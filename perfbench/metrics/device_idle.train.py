"""The device's idle share in a training cell: 1 - the union of its
activity intervals in the traced steps over the time that as many steps
took untraced just before."""

LAYER = "device"
UNIT = "%"
MOVES = "train_img_per_s"


def read(ctx):
    return ctx.idle_pct() if ctx.reports(MOVES) else None
