"""Driver: training steps of ``umx_tpu_torch.train.make_train_step`` at the
configuration's recipe, the loss read back after every step as the
upstream loop reads it.

Set-up makes the weights, builds one train state and step, and a pool of
``pool_batches`` batches with ``make_batch_from_audio`` from seeded raw
audio (targets as seeded noise, the mix their sum).  It then drives that
state through its first ``check_steps`` steps on the pool's first
batches, through the window's own call, and records what the comparison
reads: each step's loss, the first gradient of every leaf as AdamW holds
it after one step (its first moment over 1 − β1), and every leaf's change
after those steps.  The window goes on with the same state, cycling the
pool.
"""

from __future__ import annotations

import gc
import math
import time
import traceback

from benchmarks.harness import compare, generate, system
from benchmarks.harness.trace import span

E2E = {"train_steps_per_s": "steps/s"}
FROZEN = ("bn1_rm", "bn1_rv", "bn2_rm", "bn2_rv", "bn3_rm", "bn3_rv")


def field_of(key: str) -> str:
    """The system's parameter field that holds a state-dict entry."""
    if key.startswith("lstm."):
        kind = key.split(".")[1].split("_l")[0]  # weight_ih, weight_hh, bias_ih, bias_hh
        return {"weight_ih": "lstm_ih_w", "weight_hh": "lstm_hh_w", "bias_ih": "lstm_ih_b",
                "bias_hh": "lstm_hh_b"}[kind]
    if key.startswith("fc"):
        return f"{key[:3]}_w"
    if key.startswith("bn"):
        part = key.split(".")[1]
        return {"weight": f"{key[:3]}_w", "bias": f"{key[:3]}_b", "running_mean": f"{key[:3]}_rm",
                "running_var": f"{key[:3]}_rv"}[part]
    return key


def to_fields(tree: dict, n_layers: int) -> dict:
    """{target: {key: tensor}} in the published layout → the system's
    stacked fields (targets first; weights transposed to ``x @ w`` form;
    the LSTM's by layer, then direction)."""
    import torch

    from benchmarks.harness.generate import TARGETS

    def stack(fn):
        return torch.stack([fn(tree[t]) for t in TARGETS])

    def lstm(kind, transpose):
        return stack(lambda d: torch.stack([torch.stack([
            d[f"lstm.{kind}_l{layer}{rev}"].T if transpose else d[f"lstm.{kind}_l{layer}{rev}"]
            for rev in ("", "_reverse")]) for layer in range(n_layers)]))

    out = {"lstm_ih_w": lstm("weight_ih", True), "lstm_hh_w": lstm("weight_hh", True),
           "lstm_ih_b": lstm("bias_ih", False), "lstm_hh_b": lstm("bias_hh", False)}
    for key in tree[TARGETS[0]]:
        f = field_of(key)
        if f in out or f in FROZEN:
            continue
        out[f] = stack(lambda d, k=key: d[k].T if k.endswith("weight") and k.startswith("fc") else d[k])
    return out


def field_norms(tree: dict) -> dict:
    """Norms by the system's fields of {target: {key: tensor}}."""
    sq = {}
    for d in tree.values():
        for k, v in d.items():
            f = field_of(k)
            sq[f] = sq.get(f, 0.0) + float(v.double().pow(2).sum())
    return {f: math.sqrt(s) for f, s in sq.items() if f not in FROZEN}


def setup(run) -> dict:
    import torch
    from umx_tpu_torch.config import DSPConfig
    from umx_tpu_torch.train import (
        TrainConfig, init_train_state, make_batch_from_audio, make_train_step,
    )

    cfg, tr = run.cell.config, run.cell.traffic
    rc = cfg["train"]
    ecfg = system.engine_config(cfg)
    sd = generate.state_dicts(cfg, run.seed, run.device)
    tcfg = TrainConfig(learning_rate=rc["lr"], weight_decay=rc["weight_decay"],
                       seq_len=rc["seq_len"])
    state = init_train_state(system.params(sd, cfg, run.device), tcfg)
    del sd
    step = make_train_step(ecfg.model)
    samples = cfg["n_hop"] * (rc["seq_len"] - 1)
    dsp = DSPConfig(sample_rate=cfg["sample_rate"], n_fft=cfg["n_fft"], hop=cfg["n_hop"])
    raw, pool = [], []
    for b in range(tr["pool_batches"]):
        mix, targets = generate.stems_batch(rc["batch_size"], len(cfg["targets"]), samples,
                                            run.seed, f"batch{b}", run.device)
        pool.append(make_batch_from_audio(mix, targets, ecfg.model, dsp, rc["seq_len"],
                                          run.device))
        if b < tr["check_steps"]:
            raw.append((mix, targets))
    names = [n for n in vars(state.params) if n not in FROZEN]
    p0 = {n: getattr(state.params, n).detach().clone() for n in names}
    losses, grads = [], {}
    for s in range(tr["check_steps"]):
        with span("bench.train_step"):
            state, loss = step(state, pool[s])
            losses.append(float(loss))
        if s == 0:
            b1 = state.optimizer.param_groups[0]["betas"][0]
            first = {n: state.optimizer.state[getattr(state.params, n)]["exp_avg"].detach()
                     .double() / (1.0 - b1) for n in names}
            grads = {n: float(g.norm()) for n, g in first.items()}
            first = {n: g.float().cpu() for n, g in first.items()}
    change = {n: float((getattr(state.params, n).detach() - p0[n]).double().norm())
              for n in names}
    del p0
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    return {"state": state, "step": step, "pool": pool, "raw": raw, "losses": losses,
            "grads": grads, "change": change, "first": first}


def window(run, st: dict, seconds: float, recorder) -> dict:
    cfg, tr = run.cell.config, run.cell.traffic
    rc = cfg["train"]
    pool, step = st["pool"], st["step"]
    k = tr["check_steps"]
    steps = attempted = failed = 0
    with recorder.window():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            attempted += 1
            try:
                with span("bench.train_step"):
                    st["state"], loss = step(st["state"], pool[k % len(pool)])
                    value = float(loss)
            except Exception:  # a failed step counts, and the loop goes on
                traceback.print_exc()
                failed += 1
                continue
            finally:
                k += 1
            if not math.isfinite(value):
                failed += 1
            steps += 1
        elapsed = time.perf_counter() - t0
    e2e = {"train_steps_per_s": steps / elapsed} if steps else {}
    frames = steps * rc["batch_size"] * rc["seq_len"]
    work = {"frames": frames, "train_steps": steps, "batch": rc["batch_size"],
            "steps": rc["seq_len"]}
    return {"attempted": attempted, "failed": failed, "e2e": e2e, "work": work}


def release(st: dict) -> None:
    import torch

    for key in ("state", "step", "pool"):
        st.pop(key, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(run, st: dict, result: dict, control: bool = False, detail: dict | None = None) -> dict:
    """The compared numbers: the first step's loss, the first gradients
    (their norms by the worst leaf, their differences by the median leaf)
    and the leaves' change after the steps, each against the reference's
    on the same weights and raw audio (``control``: the reference with
    TF32 products in the system's place)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = run.cell.config
    ref_mod = run.cell.reference()
    sd = generate.state_dicts(cfg, run.seed, run.device)
    raw = [(torch.from_numpy(m).to(run.device), torch.from_numpy(t).to(run.device))
           for m, t in st["raw"]]
    ref = reference_numbers(ref_mod, sd, raw, cfg, "float32")
    if control:
        cand = reference_numbers(ref_mod, sd, raw, cfg, "tf32")
    else:
        cand = {"losses": st["losses"], "grads": st["grads"], "change": st["change"],
                "first": {n: g.to(run.device) for n, g in st["first"].items()}}
    out = numbers(cand, ref)
    if detail is not None:
        detail.update({k: cand[k] for k in ("losses", "grads", "change")}, gaps=gaps(cand, ref),
                      reference={k: ref[k] for k in ("losses", "grads", "change")})
    return out


def reference_numbers(ref_mod, sd: dict, raw: list, cfg: dict, products: str) -> dict:
    losses, first, trained = ref_mod.train(sd, raw, cfg, products)
    start = ref_mod.trainable_state(sd)
    delta = {t: {k: trained[t][k] - start[t][k].detach() for k in trained[t]} for t in trained}
    return {"losses": losses, "grads": field_norms(first), "change": field_norms(delta),
            "first": to_fields(first, cfg["nb_layers"])}


def gaps(cand: dict, ref: dict) -> dict:
    """Per leaf, ‖g − g_ref‖ / ‖g_ref‖ of the first gradient."""
    return {n: float((cand["first"][n].double() - r.double()).norm() / r.double().norm())
            for n, r in ref["first"].items()}


def numbers(cand: dict, ref: dict) -> dict:
    """The four compared numbers: the first step's loss; the first
    gradients' norms by the worst leaf; their differences by the median
    leaf; the leaves' change after the steps by the worst leaf.  The
    losses of the later steps are not compared: AdamW moves every element
    whose gradient is at rounding level by a whole step of either sign, so
    they carry that noise.  The change leaves out the leaves whose
    reference gradient is under a thousandth of the median leaf's (they
    move by round-off alone)."""
    import statistics

    med = statistics.median(ref["grads"].values())
    moved = [k for k, v in ref["grads"].items() if v >= 1e-3 * med]
    return {"first_loss_gap": compare.loss_gap(cand["losses"][:1], ref["losses"][:1]),
            "grad_norm_gap": compare.norm_gap(cand["grads"], ref["grads"])[0],
            "grad_diff_median": statistics.median(gaps(cand, ref).values()),
            "update_norm_gap": compare.norm_gap(cand["change"], ref["change"], moved)[0]}
