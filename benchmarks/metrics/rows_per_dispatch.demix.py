"""rows_per_dispatch.demix: the fleet runner's track rows per dispatch,
``stats["rows"] / stats["dispatches"]``, a count."""

from benchmarks.harness import readers

UNIT, MOVES = "rows", "demix_xrt"


def read(r):
    rows, dispatches = readers.fleet(r, "rows"), readers.fleet(r, "dispatches")
    return None if not dispatches else rows / dispatches
