"""step_mfu.sample in a cell that reports sr_latency_p95_s."""

LAYER = "model step"
UNIT = "%"
MOVES = "sr_latency_p95_s"


def read(ctx):
    return ctx.step_mfu_pct() if ctx.reports(MOVES) else None
