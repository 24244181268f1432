"""The benchmark's work counts reproduce the bound column of the port's
kernel table at the full widths: K3 per 64->256 eval (49 calls) 4.38 ms
in bf16 at batch 16, 60.48 ms in float32 at batch 16 and 3.78 ms at
batch 1; K1 per training forward at batch 4, 1.024 ms."""

import pytest

from perfbench.harness import workcount
from perfbench.harness.cells import load_cell

MODEL = load_cell("fastdiffsr_x4.serve_b16_bf16").config["model"]
SR3 = load_cell("sr3_x4.train_b4").config["model"]


@pytest.mark.parametrize("dtype, batch, ms", [("bf16", 16, 4.38),
                                              ("f32", 16, 60.48),
                                              ("f32", 1, 3.78)])
def test_k3_bound_per_eval(dtype, batch, ms):
    got = workcount.k3_bound_s_per_eval(MODEL, batch, 256, dtype) * 1e3
    assert round(got, 2) == ms


def test_k3_calls_per_eval():
    assert workcount.k3_calls_per_eval(MODEL, 16, 256) == 49


@pytest.mark.parametrize("model", [MODEL, SR3])
def test_k1_bound_per_training_forward(model):
    got = workcount.k1_bound_s_per_forward(model, 4, 256) * 1e3
    assert round(got, 3) == 1.024


def test_flops_per_eval_and_step():
    # 2*9*C*Co*H*W summed over the convs of one image at 256^2: about
    # 0.26 TFLOP an eval; a train step's backward doubles its forward
    per_image = workcount.flops_per_eval(MODEL, 1, 256)
    assert 0.2e12 < per_image < 0.3e12
    assert workcount.flops_per_eval(MODEL, 16, 256) == 16 * per_image
    step = workcount.flops_per_train_step(MODEL, 4, 256)
    assert 2.9 * 4 * per_image < step < 3.1 * 4 * per_image
