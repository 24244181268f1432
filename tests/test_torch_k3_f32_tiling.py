"""A plain PyTorch model of the float32 K3 kernel's decomposition
(``csrc/fused_conv.cu``), and its tile choice, on the CPU.

The CUDA kernel cannot run here, so its indexing is held in Python: the
launcher's choice of tile from the grid a call gives (:func:`f32_tile`,
the mirror of ``choose_tile``), and the walk of one tile (channel stages of
8 with a ragged last stage, the raw halo tile zero-filled outside the image
and past the last channel, the transform, the halo zeroed after it, nine
shifted windows, the small tile's four partial accumulators over two
channels of each stage added in order, a ragged last Co tile, bias + shift
+ residual, per-tile statistics summed over the tiles in order) against
``fused_gn_swish_conv3x3_plain``. ``tests/test_torch_kernels_gpu.py``
holds the library's tile count against :func:`f32_tile` on the card.
"""

import numpy as np
import pytest
import torch

from fastdiffsr_tpu_torch.ops.fused_conv import (
    _norm_affine, fused_gn_swish_conv3x3_plain)
from fastdiffsr_tpu_torch.ops.groupnorm import channel_stats_plain
from test_torch_k3_route import FULL_WIDTH

SMS = 132    # the H100 SXM's SMs, a constant of the launcher
KC = 8       # input channels per stage
# (rows, columns, output channels, groups that split each stage's
# channels) of the kernel's tiles, widest first
WIDE, WIDE64, SMALL, NARROW = (8, 16, 128, 1), (16, 16, 64, 1), \
    (8, 8, 64, 4), (16, 32, 8, 1)


def cdiv(n, d):
    return -(-n // d)


def f32_tile(B, H, W, Co):
    """The tile ``choose_tile`` in ``csrc/fused_conv.cu`` takes for a
    (B, H, W, Co) call: Co <= 8 the narrow tile; else the widest tile (128
    channels only where Co > 64) whose grid has a block for every SM, else
    the small tile."""
    if Co <= 8:
        return NARROW
    for tile in ((WIDE,) if Co > 64 else ()) + (WIDE64,):
        if blocks(tile, B, H, W, Co) >= SMS:
            return tile
    return SMALL


def blocks(tile, B, H, W, Co):
    th, tw, tco, _ = tile
    return cdiv(H, th) * cdiv(W, tw) * cdiv(Co, tco) * B


@pytest.mark.parametrize("B", [16, 1])
@pytest.mark.parametrize("Cs,hw,Co", FULL_WIDTH)
def test_f32_tile_choice_at_full_width(Cs, hw, Co, B):
    """Every full-width K3 shape at the serving batch (16) and the
    validation batch (1): the tile fills the SMs if any tile can, a wider
    tile that would is never passed over, and batch 16 always gets the
    wide tiles."""
    tile = f32_tile(B, hw, hw, Co)
    wider = [t for t in ((WIDE,) if Co > 64 else ()) + (WIDE64,)]
    if Co <= 8:
        assert tile == NARROW
    elif tile == SMALL:
        assert all(blocks(t, B, hw, hw, Co) < SMS for t in wider)
    else:
        assert blocks(tile, B, hw, hw, Co) >= SMS
        assert all(blocks(t, B, hw, hw, Co) < SMS
                   for t in wider[:wider.index(tile)])
    if B == 16 and Co > 8:
        assert tile == (WIDE if Co > 64 else WIDE64)


def test_f32_tile_choice_at_batch_1():
    """At the validation batch the 64^2 and 32^2 maps and the 128-wide
    128^2 maps leave SMs idle with the wide tiles and take the small one;
    256^2 maps and the 256-wide 128^2 maps keep the wide tiles."""
    assert f32_tile(1, 256, 256, 64) == WIDE64
    assert f32_tile(1, 256, 256, 128) == WIDE
    assert f32_tile(1, 128, 128, 256) == WIDE
    assert f32_tile(1, 128, 128, 128) == SMALL
    assert f32_tile(1, 64, 64, 256) == SMALL
    assert f32_tile(1, 32, 32, 256) == SMALL
    assert f32_tile(1, 256, 256, 3) == NARROW
    assert blocks(SMALL, 1, 64, 64, 256) == 256
    assert blocks(SMALL, 1, 32, 32, 256) == 64    # fewer than the SMs


# the K3 shapes of one 64x64 eval (the demo configs, 8->64 and 16->64):
# the full-width shapes with a quarter of the side, down to 8x8 maps
DEMO_64 = [(Cs, hw // 4, Co) for Cs, hw, Co in FULL_WIDTH]


@pytest.mark.parametrize("Cs,hw,Co", DEMO_64)
def test_f32_tile_choice_at_the_64_maps(Cs, hw, Co):
    """At the validation batch every 64x64-eval shape leaves SMs idle with
    the wide tiles and takes the small one (Co <= 8: the narrow one); an
    8x8 map is one tile, and every map a whole number of them."""
    tile = f32_tile(1, hw, hw, Co)
    assert tile == (NARROW if Co <= 8 else SMALL)
    assert all(blocks(t, 1, hw, hw, Co) < SMS for t in (WIDE, WIDE64))
    if tile == SMALL:
        assert hw % SMALL[0] == 0 and hw % SMALL[1] == 0
        assert blocks(SMALL, 1, hw, hw, Co) == (hw // 8) ** 2 * cdiv(Co, 64)


def f32_decomposition_model(xs, gn_scale, gn_bias, stats_in, w, b, shift,
                            res, groups, apply_norm, tile):
    """K3 computed the way csrc/fused_conv.cu walks it with ``tile``, in
    float32."""
    TH, TW, TCO, KS = tile
    B, H, W = xs[0].shape[:3]
    C, Co = sum(x.shape[-1] for x in xs), w.shape[-1]
    n_stages = cdiv(C, KC)
    cpad = n_stages * KC
    tiles_h, tiles_w, n_co = cdiv(H, TH), cdiv(W, TW), cdiv(Co, TCO)
    # what the copies see: the channel concat (never built by the kernel),
    # zero outside the image and past the last channel
    raw = torch.zeros((B, tiles_h * TH + 2, tiles_w * TW + 2, cpad))
    raw[:, 1:H + 1, 1:W + 1, :C] = torch.cat(xs, dim=-1)
    inside = torch.zeros(raw.shape[1:3], dtype=torch.bool)
    inside[1:H + 1, 1:W + 1] = True
    scale = torch.zeros((B, cpad))
    bias = torch.zeros((B, cpad))
    if apply_norm:
        scale[:, :C], bias[:, :C] = _norm_affine(xs, gn_scale, gn_bias,
                                                 stats_in, groups, 1e-5)
    wpad = torch.zeros((3, 3, cpad, n_co * TCO))
    wpad[:, :, :C, :Co] = w
    add = torch.zeros((B, n_co * TCO))
    add[:, :Co] = b + (shift if shift is not None else 0.0)
    y = torch.zeros((B, H, W, Co))
    partial = torch.zeros((B, tiles_h * tiles_w, 2, Co))
    for bi in range(B):
        for t in range(tiles_h * tiles_w):
            h0, w0 = (t // tiles_w) * TH, (t % tiles_w) * TW
            hh, ww = min(TH, H - h0), min(TW, W - w0)
            halo = (slice(h0, h0 + TH + 2), slice(w0, w0 + TW + 2))
            for ct in range(n_co):
                cos = slice(ct * TCO, (ct + 1) * TCO)
                # one partial accumulator per group of the KS, each over
                # its KC / KS channels of every stage, added in order
                parts = [torch.zeros((TH, TW, TCO)) for _ in range(KS)]
                for s in range(n_stages):
                    cs = slice(s * KC, (s + 1) * KC)
                    v = raw[(bi,) + halo + (cs,)]
                    if apply_norm:
                        v = v * scale[bi, cs] + bias[bi, cs]
                        v = v * torch.sigmoid(v)
                    # the halo is zeroed after the transform
                    v = torch.where(inside[halo][..., None], v,
                                    torch.zeros(()))
                    n = KC // KS
                    for g in range(KS):
                        ws = wpad[:, :, s * KC + g * n:s * KC + (g + 1) * n,
                                  cos]
                        for dy in range(3):
                            for dx in range(3):
                                parts[g] = parts[g] + (
                                    v[dy:dy + TH, dx:dx + TW,
                                      g * n:(g + 1) * n] @ ws[dy, dx])
                acc = parts[0]
                for part in parts[1:]:
                    acc = acc + part
                nco = min(TCO, Co - ct * TCO)
                out = acc[:hh, :ww, :nco] + add[bi, ct * TCO:ct * TCO + nco]
                if res is not None:
                    out = out + res[bi, h0:h0 + hh, w0:w0 + ww,
                                    ct * TCO:ct * TCO + nco]
                y[bi, h0:h0 + hh, w0:w0 + ww, ct * TCO:ct * TCO + nco] = out
                partial[bi, t, 0, ct * TCO:ct * TCO + nco] = out.sum((0, 1))
                partial[bi, t, 1, ct * TCO:ct * TCO + nco] = (
                    out * out).sum((0, 1))
    stats = torch.zeros((B, 2, Co))
    for t in range(tiles_h * tiles_w):     # summed over tiles in order
        stats = stats + partial[:, t]
    return y, stats


# (source widths, groups, H, W, Co, apply_norm, shift, res)
MODEL_CASES = {
    # 12 channels: a full stage and a ragged one; a group of 3 channels
    # straddles the boundary between the sources; Co = 5 is a ragged tile
    "two_sources_straddle_ragged": ((8, 4), 4, 7, 9, 5, True, True, True),
    "stem_c6_no_norm": ((6,), 1, 17, 5, 12, False, False, False),
    "final_co3": ((16,), 4, 9, 7, 3, True, False, False),
    # a second, ragged Co tile for every tile shape, several pixel tiles
    "co_136_shift_res": ((20,), 4, 10, 18, 136, True, True, True),
    "two_sources_24_16": ((24, 16), 8, 17, 9, 72, True, False, True),
    # the deepest map of a 64x64 UNet (the demo configs): one small tile
    # covers it, the 16-row tiles overhang it
    "map_8x8_two_sources": ((32, 16), 8, 8, 8, 64, True, True, True),
}
TILES = {"wide": WIDE, "wide64": WIDE64, "small": SMALL, "narrow": NARROW}


def make_inputs(Cs, H, W, Co, with_shift, with_res, B=2, seed=7):
    rng = np.random.default_rng(seed)
    C = sum(Cs)

    def rnd(*shape, s=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * s).astype(np.float32))

    xs = tuple(rnd(B, H, W, c) + 0.2 for c in Cs)
    stats = tuple(channel_stats_plain(x) for x in xs)
    gs, gb = rnd(C, s=0.1) + 1, rnd(C, s=0.1)
    w, b = rnd(3, 3, C, Co, s=(9 * C) ** -0.5), rnd(Co, s=0.1)
    shift = rnd(B, Co, s=0.1) if with_shift else None
    res = rnd(B, H, W, Co) if with_res else None
    return xs, stats, gs, gb, w, b, shift, res


@pytest.mark.parametrize("tile", sorted(TILES))
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_f32_decomposition_model_matches_plain(case, tile):
    """float32, atol 1e-5 on y of order 1 (summation order only); the
    statistics rtol 1e-5, atol 1e-4."""
    Cs, G, H, W, Co, norm, with_shift, with_res = MODEL_CASES[case]
    xs, stats, gs, gb, w, b, shift, res = make_inputs(Cs, H, W, Co,
                                                      with_shift, with_res)
    one = len(xs) == 1
    want_y, want_st = fused_gn_swish_conv3x3_plain(
        xs[0] if one else xs, gs if norm else None, gb if norm else None,
        (stats[0] if one else stats) if norm else None, w, b, shift=shift,
        res=res, groups=G, apply_norm=norm)
    got_y, got_st = f32_decomposition_model(
        xs, gs, gb, stats[0] if one else stats, w, b, shift, res, G, norm,
        TILES[tile])
    torch.testing.assert_close(got_y, want_y, rtol=0, atol=1e-5)
    torch.testing.assert_close(got_st, want_st, rtol=1e-5, atol=1e-4)


def test_f32_decomposition_model_with_the_launchers_tile():
    """The tile the launcher takes for a small batch-1 call (the small
    tile: the wide ones would leave SMs idle), through the model."""
    Cs, H, W, Co = (32,), 12, 20, 64
    tile = f32_tile(1, H, W, Co)
    assert tile == SMALL
    xs, stats, gs, gb, w, b, shift, res = make_inputs(Cs, H, W, Co, True,
                                                      True, B=1)
    want = fused_gn_swish_conv3x3_plain(xs[0], gs, gb, stats[0], w, b,
                                        shift=shift, res=res, groups=8)
    got = f32_decomposition_model(xs, gs, gb, stats[0], w, b, shift, res, 8,
                                  True, tile)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mangled,want", [
    ("_ZN4fdsr46_GLOBAL__N__6c809f20_13_fused_conv_cu_cb556f5921fused_conv_"
     "f32_kernelILi16ELi32ELi8ELi1ELi8EEEvNS0_7F32ArgsE",
     "fused_conv_f32_kernel<16,32,8,1,8>"),
    ("_ZN4fdsr46_GLOBAL__N__aa_19fused_conv_wgmma_cu_1234567823fused_conv_"
     "wgmma_kernelILi64ELi16EEEvNS0_8ConvArgsE",
     "fused_conv_wgmma_kernel<64,16>"),
    ("_ZN4fdsr46_GLOBAL__N__aa_channel_stats_cu_1a2b3c4d20channel_stats_"
     "kernelI13__nv_bfloat16EEvPKT_Pfiii", "channel_stats_kernel<bf16>"),
    ("_ZN4fdsr46_GLOBAL__N__aa_channel_stats_cu_1a2b3c4d22reduce_partials_"
     "kernelEPKfPfii", "reduce_partials_kernel<>"),
    ("_ZN4fdsr46_GLOBAL__N__aa_13_quant_conv_cu_1a2b3c4d18quant_conv3_"
     "kernelI13__nv_bfloat16fLi8EEEvPKT_PKaPKfS8_S8_PT0_Piiiiiiii",
     "quant_conv3_kernel<bf16,f32,8>"),
])
def test_chip_smoke_names_the_kernels_of_the_build_log(mangled, want):
    """chip_smoke's build line names each kernel from nvcc's mangled name,
    whose length prefix may follow a namespace hash's digits directly and
    whose name may hold digits (f32)."""
    import chip_smoke
    assert chip_smoke.kernel_of(mangled) == want
