"""host_idle_pct.demix: the share of a catalogue cell's traced window that
the card sits idle while the fleet prepares a dispatch (``umx.prepare``),
copies its stems out (``umx.to_host``) or cuts and sums them per track
(``umx.combine``), each the innermost host operation of the idle gap."""

from benchmarks.harness import spans

UNIT, MOVES = "%", "demix_xrt"


def read(r):
    return spans.host_idle_pct(r.trace)
