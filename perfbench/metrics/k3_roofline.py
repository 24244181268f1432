"""K3's share of its roofline: the bound time of an eval's fused
GroupNorm -> Swish -> 3x3 conv calls (every Block, the stem and the
Upsample convs, from the cell's shapes), times the traced evals, over
the device time of K3's kernels by name (the conv, then its statistics
reduction). Nothing where no K3 ran."""

LAYER = "kernels"
UNIT = "%"
MOVES = "sr_img_per_s"


def read(ctx):
    return ctx.k3_roofline_pct() if ctx.reports(MOVES) else None
