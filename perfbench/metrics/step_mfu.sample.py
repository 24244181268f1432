"""The sampling step's share of the card's peak: the reference UNet's
convolution and matmul FLOPs per eval at the cell's batch, times the
traced evals, over the time that as many took untraced and the peak of
the cell's type (bf16 989 TFLOP/s, IEEE float32 67)."""

LAYER = "model step"
UNIT = "%"
MOVES = "sr_img_per_s"


def read(ctx):
    return ctx.step_mfu_pct() if ctx.reports(MOVES) else None
