"""lstm_train_roofline_pct.train: the training recurrence's least time
(forward and backward of every layer) over the device time of K4, K5 and
K6 (``ops.lstm_cuda``)."""

from benchmarks.harness import readers

UNIT, MOVES = "%", "train_steps_per_s"


def read(r):
    return readers.roofline_pct(r, "recurrence", readers.recurrence_train_least_s(r))
