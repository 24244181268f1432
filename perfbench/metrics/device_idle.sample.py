"""The device's idle share in a cell that reports sr_img_per_s: 1 - the
union of its activity intervals in the traced calls over the time that
as many calls took untraced just before."""

LAYER = "device"
UNIT = "%"
MOVES = "sr_img_per_s"


def read(ctx):
    return ctx.idle_pct() if ctx.reports(MOVES) else None
