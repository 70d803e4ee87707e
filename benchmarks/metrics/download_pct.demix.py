"""download_pct.demix: the fleet runner's own ``stats["download_s"]`` (the
stems' copy to the host, closed by a sync) over the traced window."""

from benchmarks.harness import readers

UNIT, MOVES = "%", "demix_xrt"


def read(r):
    s = readers.fleet(r, "download_s")
    if s is None or r.trace is None:
        return None
    return 100.0 * s / r.trace.window_s
