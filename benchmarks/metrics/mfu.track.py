"""mfu.track: the mask network's FLOPs over the frames the window's
tracks ran, over the traced window at the bf16 peak."""

from benchmarks.harness import readers

UNIT, MOVES = "%", "track_p90_s"


def read(r):
    return readers.mfu(r, readers.demix_flops(r))
