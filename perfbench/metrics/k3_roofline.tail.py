"""k3_roofline in a cell that reports sr_latency_p95_s."""

LAYER = "kernels"
UNIT = "%"
MOVES = "sr_latency_p95_s"


def read(ctx):
    return ctx.k3_roofline_pct() if ctx.reports(MOVES) else None
