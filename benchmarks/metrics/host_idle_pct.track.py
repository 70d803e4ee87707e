"""host_idle_pct.track: the share of the track cell's traced window that
the card sits idle while the separator pads the track and moves it onto
the card (``umx.prepare``) or copies the stems out (``umx.to_host``),
each the innermost host operation of the idle gap."""

from benchmarks.harness import spans

UNIT, MOVES = "%", "track_p90_s"


def read(r):
    return spans.host_idle_pct(r.trace)
