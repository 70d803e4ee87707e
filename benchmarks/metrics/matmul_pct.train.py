"""matmul_pct.train: the device time of the matrix-product kernels (the
f32 projections of ``models.umx``) over the traced window."""

from benchmarks.harness import readers

UNIT, MOVES = "%", "train_steps_per_s"


def read(r):
    return readers.kind_pct(r, "matmul")
