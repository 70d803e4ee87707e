"""Serving load test of the port (counterpart of ``scripts/serve-bench.py``):
drive the HTTP demix service (``umx_tpu_torch.serve``) with concurrent
clients and report aggregate throughput, latency percentiles, and the
server's own autoscaling signals.

Evidence for the cross-request batching design (engine/batcher.py): the
recurrence's latency floor is batch-width independent, so aggregate
x realtime should grow well past 1-client x realtime as clients are
added, and /info's avg_batch_fill should approach min(clients, max_batch).

The service runs on ``--device`` (default ``cuda``, which raises without
a GPU); ``--cpu`` is ``--device cpu`` (the hermetic test).

    python -m umx_tpu_torch.scripts.serve_bench [--model ggml.bin.gz] [--clients 4]
           [--track-secs 30] [--segment-secs 60] [--requests 1]
           [--max-batch 4] [--port 0] [--cpu] [--device cuda|cpu] [--ttl-probe]
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
from scipy.io import wavfile


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default=None, help="ggml path (default: synthetic UMX-L)")
    p.add_argument("--hidden-size", type=int, default=1024)
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--requests", type=int, default=1, help="requests per client")
    p.add_argument("--track-secs", type=float, default=30.0)
    p.add_argument("--segment-secs", type=float, default=60.0)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (hermetic test)")
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    p.add_argument(
        "--ttl-probe", action="store_true",
        help="after the timed window, demonstrate session TTL eviction "
        "under abandonment: start sessions on a 2 s-TTL server, abandon "
        "them, and show the table drain + 404 on a stale push",
    )
    return p


def _start(model_path: str, args, device, **kw):
    """A serving thread for ``model_path`` → (server, base URL)."""
    from umx_tpu_torch.serve import serve

    srv = serve(model_path, port=kw.pop("port", 0), segment_secs=args.segment_secs,
                max_batch=args.max_batch, device=device, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv) -> None:
    srv.shutdown()
    srv.server_close()
    srv.service.batcher.close()


def _post(url: str, data: bytes | None = None, timeout: float = 600):
    with urllib.request.urlopen(urllib.request.Request(url, data=data, method="POST"),
                                timeout=timeout) as r:
        return r.read()


def _get_json(url: str, timeout: float = 60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from umx_tpu_torch.engine.separator import resolve_device
    from umx_tpu_torch.utils.profiling import card_name

    device = resolve_device("cpu" if args.cpu else args.device)
    with tempfile.TemporaryDirectory(prefix="umx_serve_bench_") as tmp:
        model_path = args.model
        if model_path is None:
            from umx_tpu_torch.config import ModelConfig
            from umx_tpu_torch.io.ggml import write_ggml
            from umx_tpu_torch.models.umx import synthetic_state_dicts

            model_path = f"{tmp}/model.bin.gz"
            write_ggml(
                model_path,
                args.hidden_size,
                synthetic_state_dicts(ModelConfig(hidden_size=args.hidden_size), seed=0),
            )
        _bench(args, model_path, device, card_name(device))
    return 0


def _bench(args, model_path: str, device, card: str) -> None:
    srv, base = _start(model_path, args, device, port=args.port)
    print(f"# serving {model_path} at {base} on {device} [{card}]", file=sys.stderr)
    try:
        # warmup: one short demix through the batcher (the first kernel use
        # builds them), then two concurrent rounds
        with urllib.request.urlopen(base + "/warmup", timeout=3600) as r:
            print(f"# warmup: {json.loads(r.read())}", file=sys.stderr)

        rng = np.random.default_rng(0)
        n = int(args.track_secs * 44100)
        wav_buf = io.BytesIO()
        wavfile.write(wav_buf, 44100, rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32))
        body = wav_buf.getvalue()

        def one_request():
            t0 = time.perf_counter()
            _post(base + "/demix?shifts=0&wiener=1", body, timeout=3600)
            return time.perf_counter() - t0

        # TWO concurrent warm passes: in the first, the lead request can
        # race ahead as a batch of one before the others enqueue; the
        # second, issued while the server is already hot, coalesces
        for i in range(2):
            warm_threads = [threading.Thread(target=one_request) for _ in range(args.clients)]
            t0 = time.perf_counter()
            [t.start() for t in warm_threads]
            [t.join() for t in warm_threads]
            print(f"# concurrent warm pass {i}: {time.perf_counter() - t0:.1f}s",
                  file=sys.stderr)

        # zero the batcher clock so busy_fraction/busy_s reflect the timed
        # window only
        _post(base + "/stats/reset", timeout=60)

        latencies: list[float] = []
        errors: list[BaseException] = []
        lock = threading.Lock()

        def client():
            try:
                for _ in range(args.requests):
                    dt = one_request()
                    with lock:
                        latencies.append(dt)
            except Exception as e:  # reported after the join
                with lock:
                    errors.append(e)

        threads = [threading.Thread(target=client) for _ in range(args.clients)]
        t0 = time.perf_counter()
        [t.start() for t in threads]
        [t.join() for t in threads]
        wall = time.perf_counter() - t0
        if errors:
            raise RuntimeError(f"{len(errors)} client(s) failed: {errors[0]!r}")

        total_audio = args.clients * args.requests * args.track_secs
        lat = sorted(latencies)
        pct = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]  # noqa: E731
        info = _get_json(base + "/info")

        # device_xrt: the audio over the batcher's device-busy seconds in
        # the timed window; aggregate_xrt: over the wall (the host's HTTP,
        # decode and encode work included)
        busy_s = info["batching"].get("busy_s", 0.0)
        print(json.dumps({
            "clients": args.clients,
            "requests": len(latencies),
            "track_secs": args.track_secs,
            "wall_s": round(wall, 2),
            "aggregate_xrt": round(total_audio / wall, 1),
            "device_xrt": round(total_audio / busy_s, 1) if busy_s else None,
            "latency_p50_s": round(pct(0.5), 2),
            "latency_p95_s": round(pct(0.95), 2),
            "latency_p99_s": round(pct(0.99), 2),
            "batching": info["batching"],
            "autoscaling": info["autoscaling"],
            "device_name": card,
        }), flush=True)
    finally:
        _stop(srv)

    if args.ttl_probe:
        _ttl_probe(args, model_path, device)


def _ttl_probe(args, model_path: str, device) -> None:
    """Abandoned-session behaviour on a short-TTL server: 3 sessions started
    and dropped; after the TTL the next session operation lazily evicts
    them, and a push to an evicted id is a 404."""
    srv2, base2 = _start(model_path, args, device, session_ttl_s=2.0)
    try:
        sids = [json.loads(_post(base2 + "/stream/start"))["session"] for _ in range(3)]
        before = _get_json(base2 + "/info")["streaming_sessions"]
        time.sleep(2.5)  # all three idle past the TTL
        json.loads(_post(base2 + "/stream/start"))
        after = _get_json(base2 + "/info")["streaming_sessions"]
        try:
            _post(base2 + f"/stream/push?session={sids[0]}", b"\x00" * 8, timeout=60)
            stale = "NO ERROR (bug)"
        except urllib.error.HTTPError as e:
            stale = f"HTTP {e.code}"
        print(json.dumps({
            "ttl_probe": {
                "ttl_s": 2.0,
                "abandoned_sessions": before,
                "sessions_after_ttl_plus_start": after,
                "stale_push": stale,
            }
        }), flush=True)
    finally:
        _stop(srv2)


if __name__ == "__main__":
    sys.exit(main())
