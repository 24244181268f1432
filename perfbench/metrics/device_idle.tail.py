"""The device's idle share in a cell that reports sr_latency_p95_s: 1 -
the union of its activity intervals in the traced calls over the time
that as many calls took untraced just before. Over half means only the
host paces the tail."""

LAYER = "device"
UNIT = "%"
MOVES = "sr_latency_p95_s"


def read(ctx):
    return ctx.idle_pct() if ctx.reports(MOVES) else None
