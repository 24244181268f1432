"""The train step's share of the card's peak: the reference's forward and
backward convolution and matmul FLOPs per step at the cell's batch,
times the traced steps, over the time that as many took untraced and
the IEEE float32 peak (67 TFLOP/s)."""

LAYER = "model step"
UNIT = "%"
MOVES = "train_img_per_s"


def read(ctx):
    return ctx.step_mfu_pct() if ctx.reports(MOVES) else None
