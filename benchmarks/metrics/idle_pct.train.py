"""idle_pct.train: the device's idle share of the traced window of a
training cell (1 − the union of device work over the window)."""

from benchmarks.harness import readers

UNIT, MOVES = "%", "train_steps_per_s"


def read(r):
    return readers.idle_pct(r)
