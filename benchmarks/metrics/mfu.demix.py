"""mfu.demix: the mask network's FLOPs over the frames the window's
segments ran (overlap and shift pad included), over the traced window at
the bf16 peak."""

from benchmarks.harness import readers

UNIT, MOVES = "%", "demix_xrt"


def read(r):
    return readers.mfu(r, readers.demix_flops(r))
