"""K1's share of its roofline in a training cell: the bytes bound of the
GroupNorm -> Swish under every Block of a training forward (from the
cell's shapes), times the traced steps, over the device time of K1's
two kernels (channel statistics, then normalise and Swish). Nothing
where no K1 ran."""

LAYER = "kernels"
UNIT = "%"
MOVES = "train_img_per_s"


def read(ctx):
    return ctx.k1_roofline_pct() if ctx.reports(MOVES) else None
