"""lstm_roofline_pct.demix: the inference recurrence's least time (its
bf16 products at the bf16 peak, or its bytes at the memory's bandwidth)
over the device time of the recurrence kernels (``ops.lstm_cuda``)."""

from benchmarks.harness import readers

UNIT, MOVES = "%", "demix_xrt"


def read(r):
    return readers.roofline_pct(r, "recurrence", readers.recurrence_least_s(r))
