"""Demixing service over HTTP (standard library only):

    python -m umx_tpu_torch.serve <model file> [--port 8765] [--device cuda]

Endpoints:
    GET  /healthz          -> {"status": "ok"}
    GET  /info             -> model and engine configuration, batching
                              counters and autoscaling signals (busy
                              fraction, queue depth, batch fill, scale hint)
    GET  /warmup           -> {"warmup_s": s}: one short demix through the
                              batcher (the first kernel use builds them)
    POST /demix            -> body: audio bytes, WAV, FLAC, OGG/Vorbis or
                              MP3, sniffed by magic (44.1 kHz mono/stereo);
                              response: an uncompressed ZIP of
                              target_{0..3}.wav
         ?shifts=0|1&wiener=0|1&seed=N
    POST /stats/reset      -> zero the batcher's counters and utilization
                              clock (after a warm-up, so that the signals
                              read steady state)
    POST /stream/start     -> {"session": id}   (?wiener=0|1)
    POST /stream/push?session=id
         body: raw float32 little-endian interleaved stereo PCM (frames x 2)
         response: raw float32 stems (4, 2, m), C order; m in
         X-Stems-Samples (0 until a whole segment is buffered: the
         one-segment latency of engine/streaming.py)
    POST /stream/close?session=id
         -> the stems of the remaining samples; the session is freed

Streaming sessions idle longer than --session-ttl-s (default 600) are
evicted when the session table is next touched, so abandoned clients
cannot fill it (16 sessions at most); a push to an evicted session
returns 404 "expired", to an id never issued 404 "unknown".

Concurrent requests share the device through a segment batcher
(engine/batcher.py): each request's next segment joins other requests'
segments in one batched device call.  ``--device`` picks the device
(default ``cuda``; without a usable GPU that raises instead of running on
the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import sys
import tempfile
import threading
import time
import uuid
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from umx_tpu_torch.config import TARGETS, EngineConfig, SegmentConfig
from umx_tpu_torch.engine.batcher import SegmentBatcher
from umx_tpu_torch.engine.memory import suggest_max_segment_batch
from umx_tpu_torch.engine.separator import Separator, resolve_device
from umx_tpu_torch.engine.streaming import StreamingDemixer
from umx_tpu_torch.io.audio import load_audio, write_audio


class DemixService:
    def __init__(
        self,
        model_path: str,
        quantized_hbm: bool = False,
        segment_secs: float = 60.0,
        max_batch: int = 4,
        batch_wait_ms: float = 5.0,
        session_ttl_s: float = 600.0,
        device=None,
    ):
        self.device = resolve_device(device)
        cfg = EngineConfig(segment=SegmentConfig(segment_secs=segment_secs))
        self.separator = Separator.from_ggml(model_path, cfg, self.device,
                                             quantized_hbm=quantized_hbm)
        # concurrent requests' segments coalesce into one device call (the
        # batcher's worker is the device's one executor); the width asked
        # for is capped by the memory planner, so that no admitted batch
        # runs the device out of memory
        fit = suggest_max_segment_batch(self.separator.cfg, quantized=quantized_hbm,
                                        params=self.separator.params, device=self.device)
        self.batcher = SegmentBatcher(max_batch=min(max_batch, fit), max_wait_ms=batch_wait_ms)
        self._counter_lock = threading.Lock()
        self.model_path = model_path
        self.requests_served = 0
        # streaming sessions: id -> [StreamingDemixer, the session's lock,
        # last-touched monotonic time]; evicted ids are remembered (a
        # bounded FIFO) so that their next push reads "expired"
        self._sessions: dict = {}
        self._sessions_lock = threading.Lock()
        self._expired: dict = {}
        self.max_sessions = 16
        self.session_ttl_s = float(session_ttl_s)

    def info(self) -> dict:
        cfg = self.separator.cfg
        st = self.batcher.stats
        return {
            "model": self.model_path,
            "hidden_size": cfg.model.hidden_size,
            "targets": list(TARGETS),
            "sample_rate": cfg.dsp.sample_rate,
            "segment_secs": cfg.segment.segment_secs,
            "device": str(self.device),
            "requests_served": self.requests_served,
            "batching": {
                "max_batch": self.batcher.max_batch,
                "jobs": st.jobs,
                "device_calls": st.device_calls,
                "max_batch_observed": st.max_batch_observed,
                "busy_s": round(st.busy_s, 3),
            },
            "streaming_sessions": len(self._sessions),
            "autoscaling": self.autoscaling(),
        }

    def autoscaling(self) -> dict:
        """Batcher-aware signals for an external autoscaler:

        * ``busy_fraction``: the device worker's utilization;
        * ``queue_depth``: jobs waiting for a device call now;
        * ``avg_batch_fill``: mean jobs per device call; below
          ``max_batch`` this replica has room (extra rows of a call cost
          little), so scale out only once the fill saturates;
        * ``scale_hint``: "up" | "steady" | "down"."""
        st = self.batcher.stats
        busy = round(self.batcher.utilization(), 4)
        depth = self.batcher.queue_depth()
        fill = round(st.jobs / st.device_calls, 2) if st.device_calls else 0.0
        saturated = fill >= 0.9 * self.batcher.max_batch
        if depth > self.batcher.max_batch or (busy > 0.8 and saturated):
            hint = "up"
        elif busy < 0.15 and depth == 0 and not self._sessions:
            hint = "down"
        else:
            hint = "steady"
        return {
            "busy_fraction": busy,
            "queue_depth": depth,
            "avg_batch_fill": fill,
            "batch_headroom": max(0.0, self.batcher.max_batch - fill),
            "scale_hint": hint,
        }

    def warmup(self) -> float:
        n = self.separator.cfg.segment.segment_samples(self.separator.cfg.dsp.sample_rate)
        t0 = time.perf_counter()
        self.separator.demix(np.zeros((2, min(n, 44100)), np.float32),
                             segment_fn=self.batcher.run)
        return time.perf_counter() - t0

    def demix_wav_bytes(self, wav_bytes: bytes, shifts: int, wiener: bool, seed: int) -> bytes:
        """Demix an audio file's bytes (WAV, FLAC, OGG or MP3: load_audio
        sniffs the magic) into a stored ZIP of the four stems."""
        with tempfile.NamedTemporaryFile() as f:
            f.write(wav_bytes)
            f.flush()
            audio = load_audio(f.name, self.separator.cfg.dsp.sample_rate)
        cfg = dataclasses.replace(self.separator.cfg, shifts=shifts, use_wiener=wiener)
        sep = Separator(self.separator.params, cfg, self.device)
        stems = sep.demix_track(audio, seed=seed, segment_fn=self.batcher.run)
        with self._counter_lock:
            self.requests_served += 1
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
            for i in range(stems.shape[0]):
                wav = io.BytesIO()
                write_audio(wav, stems[i], cfg.dsp.sample_rate)
                zf.writestr(f"target_{i}.wav", wav.getvalue())
        return buf.getvalue()

    # -- streaming sessions ---------------------------------------------------

    def stream_start(self, wiener: bool) -> str:
        cfg = dataclasses.replace(self.separator.cfg, use_wiener=wiener)
        with self._sessions_lock:
            self._evict_idle_locked()
            if len(self._sessions) >= self.max_sessions:
                raise RuntimeError(
                    f"too many streaming sessions (max {self.max_sessions}); close one first"
                )
            sid = uuid.uuid4().hex[:12]
            self._sessions[sid] = [
                StreamingDemixer(self.separator.params, cfg, self.device),
                threading.Lock(),
                time.monotonic(),
            ]
        return sid

    def _evict_idle_locked(self) -> None:
        """Drop the sessions idle longer than ``session_ttl_s``; the caller
        holds ``_sessions_lock``.  Lazy (on start and access): no reaper
        thread; an abandoned session holds device memory only until the
        next session operation."""
        now = time.monotonic()
        dead = [sid for sid, (_, _, ts) in self._sessions.items()
                if now - ts > self.session_ttl_s]
        for sid in dead:
            self._sessions.pop(sid, None)
            self._expired[sid] = now
        while len(self._expired) > 64:
            self._expired.pop(next(iter(self._expired)))

    def _session(self, sid: str):
        with self._sessions_lock:
            self._evict_idle_locked()
            if sid not in self._sessions:
                if sid in self._expired:
                    raise KeyError(
                        f"streaming session {sid!r} expired after {self.session_ttl_s:g}s idle"
                    )
                raise KeyError(f"unknown streaming session {sid!r}")
            entry = self._sessions[sid]
            entry[2] = time.monotonic()
            return entry[0], entry[1]

    def stream_push(self, sid: str, pcm_bytes: bytes) -> bytes:
        if len(pcm_bytes) % 8:
            raise ValueError("stream body must be float32 interleaved stereo")
        frames = np.frombuffer(pcm_bytes, np.float32).reshape(-1, 2)
        demixer, lock = self._session(sid)
        with lock:
            stems = demixer.push(np.ascontiguousarray(frames.T))
        return np.ascontiguousarray(stems, np.float32).tobytes()

    def stream_close(self, sid: str) -> bytes:
        demixer, lock = self._session(sid)
        with lock:
            stems = demixer.flush()
        with self._sessions_lock:
            self._sessions.pop(sid, None)
        return np.ascontiguousarray(stems, np.float32).tobytes()


def make_handler(service: DemixService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {"status": "ok"})
            elif path == "/info":
                self._json(200, service.info())
            elif path == "/warmup":
                self._json(200, {"warmup_s": round(service.warmup(), 2)})
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def _raw(self, payload: bytes, samples: int):
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(payload)))
            self.send_header("X-Stems-Samples", str(samples))
            self.end_headers()
            self.wfile.write(payload)

        def do_POST(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if url.path == "/stats/reset":
                service.batcher.reset_stats()
                self._json(200, {"status": "reset"})
                return
            if url.path.startswith("/stream/"):
                try:
                    if url.path == "/stream/start":
                        sid = service.stream_start(wiener=q.get("wiener", ["1"])[0] != "0")
                        self._json(200, {"session": sid})
                    elif url.path in ("/stream/push", "/stream/close"):
                        sid = q.get("session", [""])[0]
                        if url.path == "/stream/push":
                            length = int(self.headers.get("Content-Length", "0"))
                            body = self.rfile.read(length) if length else b""
                            payload = service.stream_push(sid, body)
                        else:
                            payload = service.stream_close(sid)
                        self._raw(payload, len(payload) // (4 * len(TARGETS) * 2))
                    else:
                        self._json(404, {"error": f"unknown path {url.path}"})
                except KeyError as e:
                    self._json(404, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — surfaced as an HTTP error
                    self._json(400, {"error": str(e)})
                return
            if url.path != "/demix":
                self._json(404, {"error": f"unknown path {url.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length <= 0:
                    raise ValueError("empty request body; expected audio bytes")
                body = self.rfile.read(length)
                zip_bytes = service.demix_wav_bytes(
                    body,
                    shifts=int(q.get("shifts", ["1"])[0]),
                    wiener=q.get("wiener", ["1"])[0] != "0",
                    seed=int(q.get("seed", ["0"])[0]),
                )
            except Exception as e:  # noqa: BLE001 — surfaced as an HTTP error
                self._json(400, {"error": str(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/zip")
            self.send_header("Content-Length", str(len(zip_bytes)))
            self.end_headers()
            self.wfile.write(zip_bytes)

    return Handler


def serve(model_path: str, port: int = 8765, host: str = "127.0.0.1", **kw) -> ThreadingHTTPServer:
    """A server for ``model_path`` (not yet serving: call its
    ``serve_forever``); ``kw`` goes to :class:`DemixService`.  Port 0 picks
    a free port (``server.server_address[1]``)."""
    service = DemixService(model_path, **kw)
    server = ThreadingHTTPServer((host, port), make_handler(service))
    server.service = service  # type: ignore[attr-defined]
    return server


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="umx-tpu-torch-serve", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model_file")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--segment-secs", type=float, default=60.0)
    p.add_argument("--quantized-hbm", action="store_true")
    p.add_argument("--max-batch", type=int, default=4,
                   help="segments from concurrent requests coalesced per device call")
    p.add_argument("--batch-wait-ms", type=float, default=5.0)
    p.add_argument("--session-ttl-s", type=float, default=600.0,
                   help="evict streaming sessions idle longer than this")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    server = serve(
        args.model_file,
        port=args.port,
        host=args.host,
        quantized_hbm=args.quantized_hbm,
        segment_secs=args.segment_secs,
        max_batch=args.max_batch,
        batch_wait_ms=args.batch_wait_ms,
        session_ttl_s=args.session_ttl_s,
        device=args.device,
    )
    print(f"umx-tpu-torch serving {args.model_file} on http://{args.host}:"
          f"{server.server_address[1]} ({server.service.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        server.service.batcher.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
