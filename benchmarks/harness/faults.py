"""Faults planted under the timed path, for the tests and the readings
that show the comparison catches them.  Each is a context manager that
patches the system while it is open and restores it after."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def stems_bf16():
    """The stems rounded to bfloat16 on their copy to the host."""
    import torch
    import umx_tpu_torch.engine.fleet as fleet
    import umx_tpu_torch.engine.separator as sep

    def to_host(t):
        return t.to(torch.bfloat16).float().cpu().numpy()

    with patched(fleet, "to_host", to_host), patched(sep, "to_host", to_host):
        yield


@contextlib.contextmanager
def state_unchanged():
    """The recurrence returns the state it was given: nothing carries from
    segment to segment."""
    import umx_tpu_torch.engine.separator as sep

    real = sep.umx_recurrence_batched

    def rec(params, x1, state, cfg, *a, **k):
        return real(params, x1, state, cfg, *a, **k)[0], state

    with patched(sep, "umx_recurrence_batched", rec):
        yield


@contextlib.contextmanager
def answer_altered():
    """One target's stems altered by 1 % where they are produced."""
    import umx_tpu_torch.engine.separator as sep

    real = sep.segment_finish

    def finish(*a, **k):
        out = real(*a, **k)
        out[:, 0] *= 1.01
        return out

    with patched(sep, "segment_finish", finish):
        yield


@contextlib.contextmanager
def train_state_unchanged():
    """The step computes the loss and leaves the parameters as they are."""
    import torch
    import umx_tpu_torch.train as train

    real = train.make_train_step

    def make(cfg):
        step = real(cfg)

        def frozen(state, batch):
            saved = {k: v.detach().clone() for k, v in vars(state.params).items()}
            state, loss = step(state, batch)
            with torch.no_grad():
                for k, v in saved.items():
                    getattr(state.params, k).copy_(v)
            return state, loss

        return frozen

    with patched(train, "make_train_step", make):
        yield


@contextlib.contextmanager
def train_half_batch():
    """Half of the batch left out, the mean taken over the rest."""
    import umx_tpu_torch.train as train

    real = train.mask_loss

    def loss(params, batch, cfg):
        return real(params, {k: v[: max(1, v.shape[0] // 2)] for k, v in batch.items()}, cfg)

    with patched(train, "mask_loss", loss):
        yield


DEMIX = {"stems_bf16": stems_bf16, "state_unchanged": state_unchanged,
         "answer_altered": answer_altered}
TRAIN = {"state_unchanged": train_state_unchanged, "half_batch": train_half_batch}
