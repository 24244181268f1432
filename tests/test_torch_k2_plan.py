"""K2's launch plan and a plain PyTorch model of its summation, on the CPU.

The CUDA kernel (``csrc/channel_stats.cu``) cannot run here, so what decides
its result is held in Python: the plan :func:`channel_stats_plan` computes
for a call (vector width, channel slabs, pixel lanes, blocks per image, the
last block's lanes) covers every (image, pixel, channel) exactly once at
every main-path shape and at drawn ones, and :func:`k2_model` (per-thread
sums over its pixels in order, the block's lanes added in order, the last
block's ordered sum over the blocks) agrees with ``channel_stats_plain``
and with the JAX package's ``channel_stats_pallas`` in interpret mode.
``tests/test_torch_kernels_gpu.py`` holds the kernel to this model bit for
bit on the card.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fastdiffsr_tpu.ops.groupnorm import (
    channel_stats_pallas as jax_channel_stats)
from fastdiffsr_tpu_torch.ops import groupnorm
from torch_k2_model import cdiv, k2_model
from fastdiffsr_tpu_torch.ops.groupnorm import (
    K2_BLOCKS_PER_SM, K2_FINAL_LANES, K2_MAX_BLOCKS, K2_SLAB,
    K2_SLOT_COUNTERS, K2_THREADS, SMS, channel_stats, channel_stats_plain, channel_stats_plan, gn_swish)

torch.set_num_threads(2)

ITEMSIZE = {"f32": 4, "bf16": 2}
DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}
# (H, W, C) of the 4 K2 calls of one fused UNet eval (after the three
# downsamples and after the middle attention): 256^2 input (64->256 and the
# x8 32->256 configs, which run the same UNet at 256^2) and 512^2 (128->512)
K2_256 = [(128, 128, 64), (64, 64, 128), (32, 32, 256)]
K2_512 = [(256, 256, 64), (128, 128, 128), (64, 64, 256)]
# (H, W, C) of the K1 calls of one training forward at 256^2
# (chip_smoke.record_k1): FastDiffSR and SR3 (45 calls), the guided UNet (29)
K1_SR3 = [(32, 32, 256), (32, 32, 512), (64, 64, 128), (64, 64, 256),
          (64, 64, 384), (64, 64, 512), (128, 128, 64), (128, 128, 128),
          (128, 128, 192), (128, 128, 256), (128, 128, 384), (256, 256, 64),
          (256, 256, 128), (256, 256, 192)]
K1_GUIDED = [(32, 32, 512), (32, 32, 1024), (64, 64, 256), (64, 64, 512),
             (64, 64, 768), (64, 64, 1024), (128, 128, 128),
             (128, 128, 256), (128, 128, 384), (128, 128, 512),
             (128, 128, 768), (256, 256, 128), (256, 256, 256),
             (256, 256, 384)]
# the demo configs' 64x64 UNet (8->64, 16->64): K2 at batch 1 (-p val)
# and K1 at the training batch 16, on maps a quarter of the side
K2_64 = [(h // 4, w // 4, c) for h, w, c in K2_256]
K1_64 = [(h // 4, w // 4, c) for h, w, c in K1_SR3]
MAIN_PATH = sorted(
    {(B, hwc) for B in (16, 1) for hwc in K2_256}
    | {(1, hwc) for hwc in K2_512}
    | {(B, hwc) for B in (4, 1) for hwc in K1_SR3 + K1_GUIDED}
    | {(1, hwc) for hwc in K2_64} | {(16, hwc) for hwc in K1_64})


def check_plan(plan, B, HW, C, itemsize, aligned=True):
    """The plan's limits, its coverage of every (image, pixel, channel)
    exactly once, and the grid's size."""
    assert plan.vec in (1, 16 // itemsize)
    assert plan.vec == 1 or (C % plan.vec == 0 and aligned)
    if C % (16 // itemsize) == 0 and aligned:
        assert plan.vec == 16 // itemsize       # 16-byte loads wherever
    assert plan.slab_units * plan.vec == K2_SLAB
    assert plan.lanes == K2_THREADS // plan.slab_units
    assert plan.n_slabs == cdiv(C, K2_SLAB)
    assert 1 <= plan.n_blocks <= HW
    assert B * plan.n_slabs <= K2_SLOT_COUNTERS
    # channels: slab s, vector u of the slab, element e
    sc = plan.slab_units * plan.vec
    ch = (np.arange(plan.n_slabs)[:, None, None] * sc
          + np.arange(plan.slab_units)[None, :, None] * plan.vec
          + np.arange(plan.vec)[None, None, :]).ravel()
    ch = ch[ch < C]
    assert np.array_equal(np.sort(ch), np.arange(C))
    # pixels: block k, lane l, its pixels p0 + l, p0 + l + lanes, ...
    counts = np.zeros(HW, np.int64)
    for k in range(plan.n_blocks):
        p0, p1 = k * HW // plan.n_blocks, (k + 1) * HW // plan.n_blocks
        assert p1 > p0                          # no empty block
        for lane in range(min(plan.lanes, p1 - p0)):
            counts[p0 + lane:p1:plan.lanes] += 1
    assert (counts == 1).all()
    # the grid: at least a block per SM wherever the map has that many
    # passes of a block's lanes; about K2_BLOCKS_PER_SM per SM at most, and
    # no more than K2_MAX_BLOCKS per (image, slab) unless the grid would
    # then have fewer blocks than SMs
    per = B * plan.n_slabs
    assert per * plan.n_blocks >= min(SMS, per * cdiv(HW, plan.lanes))
    assert plan.n_blocks <= max(
        cdiv(SMS, per), min(cdiv(K2_BLOCKS_PER_SM * SMS, per),
                            K2_MAX_BLOCKS))
    # the last block: 16 float4 of a (2, 32) partial row times its lanes
    assert plan.final_lanes == K2_FINAL_LANES == K2_THREADS // (2 * sc // 4)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,hwc", MAIN_PATH)
def test_plan_covers_each_element_once_at_main_path_shapes(B, hwc, dt):
    H, W, C = hwc
    plan = channel_stats_plan(B, H * W, C, ITEMSIZE[dt])
    check_plan(plan, B, H * W, C, ITEMSIZE[dt])


def test_plan_at_the_serving_and_validation_shapes():
    """16-byte loads at every UNet width, 32 channels a block (a warp reads
    4 float32 or 8 bfloat16 pixels' 128 or 64 bytes); batch 16 shares the
    grid's blocks among its images, batch 1 gives its one image up to
    K2_MAX_BLOCKS per slab, and a 32-channel map a block per SM."""
    grid = K2_BLOCKS_PER_SM * SMS
    p = channel_stats_plan(16, 128 * 128, 64, 4)
    assert (p.vec, p.slab_units, p.n_slabs, p.lanes, p.n_blocks) == (
        4, 8, 2, 32, cdiv(grid, 32))
    p = channel_stats_plan(16, 32 * 32, 256, 2)
    assert (p.vec, p.slab_units, p.n_slabs, p.lanes, p.n_blocks) == (
        8, 4, 8, 64, cdiv(grid, 128))
    p = channel_stats_plan(1, 128 * 128, 64, 4)
    assert (p.n_slabs, p.n_blocks) == (2, min(cdiv(grid, 2), K2_MAX_BLOCKS))
    p = channel_stats_plan(1, 64 * 64, 256, 2)
    assert (p.vec, p.n_slabs, p.n_blocks) == (8, 8, cdiv(grid, 8))
    p = channel_stats_plan(1, 1024 * 1024, 32, 4)
    assert (p.n_slabs, p.n_blocks) == (1, SMS)


def test_plan_takes_scalar_loads_where_vectors_do_not_fit():
    """C = 6 (K1's smallest test width) and 42 are no multiple of 4 or 8;
    C = 40 is (10 float4 or 5 uint4 a pixel); a map that is not 16-byte
    aligned takes scalar loads whatever C is."""
    for C, itemsize, vec in ((6, 4, 1), (6, 2, 1), (42, 4, 1), (42, 2, 1),
                             (40, 4, 4), (40, 2, 8), (24, 2, 8)):
        assert channel_stats_plan(2, 63, C, itemsize).vec == vec, (C,
                                                                   itemsize)
    assert channel_stats_plan(2, 63, 64, 4, aligned=False).vec == 1


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(B=st.integers(1, 20), H=st.integers(1, 48), W=st.integers(1, 48),
       C=st.one_of(st.sampled_from([6, 40, 42, 64, 96, 256, 264, 520]),
                   st.integers(1, 1100)),
       dt=st.sampled_from(["f32", "bf16"]), aligned=st.booleans())
def test_plan_covers_each_element_once_at_drawn_shapes(B, H, W, C, dt,
                                                       aligned):
    plan = channel_stats_plan(B, H * W, C, ITEMSIZE[dt], aligned)
    check_plan(plan, B, H * W, C, ITEMSIZE[dt], aligned)


def _x(shape, dt, seed=1):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * 1.5 + 0.5).astype(np.float32)
    return torch.from_numpy(a).to(DTYPE[dt]), a


# (B, H, W, C); each with its own plan and with fewer blocks, so that a
# thread walks several pixels and the last block several blocks per lane
MODEL_CASES = [(2, 12, 8, 24), (3, 9, 7, 40), (2, 9, 7, 6), (1, 30, 30, 64),
               (2, 5, 11, 42), (1, 16, 16, 264)]


@pytest.mark.parametrize("n_blocks", [None, 3, 1])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", MODEL_CASES)
def test_k2_model_matches_plain(shape, dt, n_blocks):
    """float32 sums in another order: atol 1e-5 of max sum x^2 (rtol 1e-5
    of the sum of squares, the card test's tolerance)."""
    B, H, W, C = shape
    x, _ = _x(shape, dt)
    plan = channel_stats_plan(B, H * W, C, ITEMSIZE[dt])
    if n_blocks is not None:
        plan = plan._replace(n_blocks=min(n_blocks, H * W))
    got = k2_model(x, plan)
    want = channel_stats_plain(x)
    scale = want[:, 1].abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 12, 8, 24), (3, 9, 7, 40),
                                   (2, 5, 11, 42)])
def test_k2_model_matches_jax_pallas(shape, dt):
    """The model against the JAX package's Pallas kernel in interpret mode:
    float32 sums of at most 99 values per channel, rtol 1e-5, atol 1e-4
    (tests/test_torch_ops.py's tolerance for the plain version)."""
    B, H, W, C = shape
    x, a = _x(shape, dt, seed=4)
    plan = channel_stats_plan(B, H * W, C, ITEMSIZE[dt])
    got = k2_model(x, plan)
    with pltpu.force_tpu_interpret_mode():
        want = jax_channel_stats(jnp.asarray(a, {"f32": jnp.float32,
                                                 "bf16": jnp.bfloat16}[dt]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_k2_model_order_is_the_plans():
    """The model follows the plan's order, not one of its own: two plans
    of one map give sums that differ in their last bits (the card test's
    bit-equality with the kernel is then a check of the order)."""
    x, _ = _x((1, 64, 64, 64), "f32", seed=5)
    plan = channel_stats_plan(1, 64 * 64, 64, 4)
    a = k2_model(x, plan)
    b = k2_model(x, plan._replace(n_blocks=7))
    assert not torch.equal(a, b)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-3)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    """Off the CPU a map must be float32 or bfloat16, 4-D and contiguous
    NHWC, on a CUDA device; the checks come before any launch (meta tensors
    here: no data, no card)."""
    x = torch.empty((1, 8, 8, 16), device="meta")
    one = torch.ones(16, device="meta")
    for fn in (channel_stats, lambda t: gn_swish(t, one, one, 4)):
        with pytest.raises(TypeError, match="dtype"):
            fn(x.half())
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.empty((1, 8, 16, 8), device="meta").transpose(2, 3))
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.empty((8, 8, 16), device="meta"))
        with pytest.raises(ValueError, match="unsupported device"):
            fn(x)


def test_counter_slots_are_per_device_and_stream(monkeypatch):
    """Each (device, stream) gets a slot of its own, numbered per device,
    and the slots run out with a clear error, never by sharing one."""
    class FakeStream:
        def __init__(self, handle):
            self.cuda_stream = handle

    handle = {"value": 1}
    monkeypatch.setattr(groupnorm, "_SLOTS", {})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: FakeStream(handle["value"]))
    dev0, dev1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert groupnorm._counter_slot(dev0) == 0
    assert groupnorm._counter_slot(dev0) == 0
    handle["value"] = 2
    assert groupnorm._counter_slot(dev0) == 1
    assert groupnorm._counter_slot(dev1) == 0
    monkeypatch.setattr(groupnorm, "K2_COUNTER_SLOTS", 2)
    handle["value"] = 3
    with pytest.raises(RuntimeError, match="streams"):
        groupnorm._counter_slot(dev0)
