"""d2h_pct.track: the device time of the stems' copies to the host
(``Memcpy DtoH``) over the traced window."""

from benchmarks.harness import readers

UNIT, MOVES = "%", "track_p90_s"


def read(r):
    return readers.kind_pct(r, "d2h")
