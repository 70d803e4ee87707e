"""idle_pct.track: the device's idle share of the traced window of a
single-track cell (1 − the union of device work over the window)."""

from benchmarks.harness import readers

UNIT, MOVES = "%", "track_p90_s"


def read(r):
    return readers.idle_pct(r)
