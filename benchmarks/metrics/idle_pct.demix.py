"""idle_pct.demix: the device's idle share of the traced window of a
catalogue cell (1 − the union of device work over the window)."""

from benchmarks.harness import readers

UNIT, MOVES = "%", "demix_xrt"


def read(r):
    return readers.idle_pct(r)
