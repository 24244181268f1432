"""K3's routing between its two hand-written kernels, and a plain PyTorch
model of the tensor-core kernel's decomposition, on the CPU.

The CUDA kernels cannot run here, so what surrounds them is held in
Python: :func:`k3_route` over every K3 call of a full-width UNet eval, and
the kernel's indexing (16x16 tiles, K walked in chunks of 16 channels over
two sources, the halo zeroed after the transform, nine shifted windows,
per-tile partial statistics summed in order) against
``fused_gn_swish_conv3x3_plain``.
"""

import numpy as np
import pytest
import torch

from fastdiffsr_tpu_torch.ops import fused_conv
from fastdiffsr_tpu_torch.ops.fused_conv import (
    _norm_affine, fused_gn_swish_conv3x3_plain, k3_route)
from fastdiffsr_tpu_torch.ops.groupnorm import channel_stats_plain

# (source widths, H = W, Co) of the 49 K3 calls of one eval of the
# full-width UNet (inner 64, mults [1,2,4,4], 2 res blocks, 256x256): 23
# distinct signatures once norm / shift / res are counted, 18 shapes
FULL_WIDTH = [
    ((6,), 256, 64), ((64,), 128, 128), ((64,), 256, 3), ((64,), 256, 64),
    ((64, 64), 256, 64), ((128,), 64, 256), ((128,), 128, 128),
    ((128,), 256, 128), ((128, 64), 128, 128), ((128, 64), 256, 64),
    ((128, 128), 128, 128), ((256,), 32, 256), ((256,), 64, 256),
    ((256,), 128, 256), ((256, 128), 64, 256), ((256, 128), 128, 128),
    ((256, 256), 32, 256), ((256, 256), 64, 256),
]
RAGGED = [((6,), 7, 64), ((64,), 9, 3), ((40,), 7, 80), ((8, 4), 5, 5),
          ((3,), 1, 1)]


@pytest.mark.parametrize("Cs,hw,Co", FULL_WIDTH + RAGGED)
def test_bf16_goes_to_the_tensor_cores(Cs, hw, Co):
    assert k3_route(torch.bfloat16, Cs, Co) == "wgmma"


@pytest.mark.parametrize("Cs,hw,Co", FULL_WIDTH + RAGGED)
def test_f32_stays_on_the_cuda_cores(Cs, hw, Co):
    """IEEE float32 results must not pass through TF32."""
    assert k3_route(torch.float32, Cs, Co) == "cuda_cores"


def test_route_limits():
    """The type alone decides; how many channels a kernel takes is the
    library's to say (``fdsr_fused_conv*_max_channels``), on the card."""
    assert k3_route(torch.bfloat16, (4096,), 64) == "wgmma"
    assert k3_route(torch.float32, (4096, 8), 8) == "cuda_cores"
    with pytest.raises(TypeError):
        k3_route(torch.float16, (64,), 64)
    with pytest.raises(ValueError, match="two sources"):
        k3_route(torch.bfloat16, (8, 8, 8), 8)
    with pytest.raises(ValueError, match="widths"):
        k3_route(torch.bfloat16, (0,), 8)


TILE, KC = 16, 16


def decomposition_model(xs, gn_scale, gn_bias, stats_in, w, b, shift, res,
                        groups, apply_norm):
    """K3 computed the way csrc/fused_conv_wgmma.cu walks it, in float32."""
    B, H, W = xs[0].shape[:3]
    Cs = [x.shape[-1] for x in xs]
    C, Co = sum(Cs), w.shape[-1]
    if apply_norm:
        scale, bias = _norm_affine(xs, gn_scale, gn_bias, stats_in, groups,
                                   1e-5)
    n_chunks = -(-C // KC)
    tiles = [(h0, w0) for h0 in range(0, H, TILE) for w0 in range(0, W, TILE)]
    y = torch.zeros((B, H, W, Co))
    partial = torch.zeros((B, len(tiles), 2, Co))
    for bi in range(B):
        for ti, (h0, w0) in enumerate(tiles):
            acc = torch.zeros((TILE, TILE, Co))
            for ch in range(n_chunks):
                # stage the 18x18xKC halo tile: zero outside the image and
                # past the last channel, each channel from its own source
                staged = torch.zeros((TILE + 2, TILE + 2, KC))
                inside = torch.zeros((TILE + 2, TILE + 2), dtype=torch.bool)
                for iy in range(TILE + 2):
                    for ix in range(TILE + 2):
                        gh, gw = h0 + iy - 1, w0 + ix - 1
                        if not (0 <= gh < H and 0 <= gw < W):
                            continue
                        inside[iy, ix] = True
                        for k in range(KC):
                            c = ch * KC + k
                            if c < Cs[0]:
                                staged[iy, ix, k] = xs[0][bi, gh, gw, c]
                            elif c < C:
                                staged[iy, ix, k] = xs[1][bi, gh, gw,
                                                          c - Cs[0]]
                if apply_norm:
                    # transform in place; the halo keeps its zeros
                    sc = torch.zeros(KC)
                    bs = torch.zeros(KC)
                    n = min(KC, C - ch * KC)
                    sc[:n] = scale[bi, ch * KC:ch * KC + n]
                    bs[:n] = bias[bi, ch * KC:ch * KC + n]
                    v = staged * sc + bs
                    v = v * torch.sigmoid(v)
                    staged = torch.where(inside[..., None], v,
                                         torch.zeros(()))
                wk = torch.zeros((3, 3, KC, Co))
                n = min(KC, C - ch * KC)
                wk[:, :, :n] = w[:, :, ch * KC:ch * KC + n]
                for dy in range(3):
                    for dx in range(3):
                        win = staged[dy:dy + TILE, dx:dx + TILE]
                        acc = acc + win @ wk[dy, dx]
            acc = acc + b
            if shift is not None:
                acc = acc + shift[bi]
            hh, ww = min(TILE, H - h0), min(TILE, W - w0)
            out = acc[:hh, :ww]
            if res is not None:
                out = out + res[bi, h0:h0 + hh, w0:w0 + ww]
            y[bi, h0:h0 + hh, w0:w0 + ww] = out
            partial[bi, ti, 0] = out.sum(dim=(0, 1))
            partial[bi, ti, 1] = (out * out).sum(dim=(0, 1))
    stats = torch.zeros((B, 2, Co))
    for ti in range(len(tiles)):          # summed over tiles in order
        stats = stats + partial[:, ti]
    return y, stats


MODEL_CASES = {
    # a group of 3 channels straddles the boundary between the sources
    "two_sources_straddle_ragged": ((8, 4), 4, 7, 9, 5, True, True, True),
    "straddle_128_64_groups_32": ((128, 64), 32, 8, 8, 6, True, False, True),
    "two_tiles_each_way": ((24,), 8, 19, 18, 8, True, True, False),
    "stem_c6_no_norm": ((6,), 1, 17, 5, 4, False, False, False),
    "final_co3": ((16,), 4, 9, 7, 3, True, False, False),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_decomposition_model_matches_plain(case):
    """float32, atol 1e-5 on y of order 1 (summation order only)."""
    Cs, G, H, W, Co, norm, with_shift, with_res = MODEL_CASES[case]
    rng = np.random.default_rng(7)
    B, C = 2, sum(Cs)

    def rnd(*shape, s=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * s).astype(np.float32))

    xs = tuple(rnd(B, H, W, c) + 0.2 for c in Cs)
    stats = tuple(channel_stats_plain(x) for x in xs)
    gs, gb = rnd(C, s=0.1) + 1, rnd(C, s=0.1)
    w, b = rnd(3, 3, C, Co, s=(9 * C) ** -0.5), rnd(Co, s=0.1)
    shift = rnd(B, Co, s=0.1) if with_shift else None
    res = rnd(B, H, W, Co) if with_res else None
    want_y, want_st = fused_gn_swish_conv3x3_plain(
        xs if len(xs) > 1 else xs[0], gs if norm else None,
        gb if norm else None,
        (stats if len(xs) > 1 else stats[0]) if norm else None, w, b,
        shift=shift, res=res, groups=G, apply_norm=norm)
    got_y, got_st = decomposition_model(xs, gs, gb, stats if len(xs) > 1
                                        else stats[0], w, b, shift, res, G,
                                        norm)
    torch.testing.assert_close(got_y, want_y, rtol=0, atol=1e-5)
    torch.testing.assert_close(got_st, want_st, rtol=1e-5, atol=1e-4)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper runs the plain version and counts no launch
    and no route."""
    from fastdiffsr_tpu_torch.ops import kernels
    x = torch.randn(1, 5, 6, 8)
    w = torch.randn(3, 3, 8, 4)
    before = (dict(kernels.LAUNCHES), dict(fused_conv.ROUTE_TAKEN))
    y, st = fused_conv.fused_gn_swish_conv3x3(
        x, torch.ones(8), torch.zeros(8), channel_stats_plain(x), w,
        torch.zeros(4), groups=2)
    assert y.shape == (1, 5, 6, 4) and st.shape == (1, 2, 4)
    assert (dict(kernels.LAUNCHES), dict(fused_conv.ROUTE_TAKEN)) == before
