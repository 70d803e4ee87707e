"""mfu.train: 3 × a step's forward FLOPs × the window's steps, over the
traced window at the bf16 peak."""

from benchmarks.harness import counts, readers

UNIT, MOVES = "%", "train_steps_per_s"


def read(r):
    return readers.mfu(r, r.work["train_steps"] * counts.train_step_flops(r.config))
