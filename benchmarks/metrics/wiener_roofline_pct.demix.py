"""wiener_roofline_pct.demix: the Wiener EM's least time (f32 operations
at the f32 peak, or bf16 masks in, f32 mix planes in, bf16 estimates out
at the memory's bandwidth) over the device time of K2 and K3
(``ops.wiener_cuda``)."""

from benchmarks.harness import readers

UNIT, MOVES = "%", "demix_xrt"


def read(r):
    return readers.roofline_pct(r, "wiener", readers.wiener_least_s(r))
