"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: they skip where no CUDA device is visible. This
file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from fastdiffsr_tpu_torch.ops import fused_conv, groupnorm, kernels
from test_torch_k3_f32_tiling import cdiv, f32_tile
from test_torch_k3_route import FULL_WIDTH
from torch_k2_model import k2_model
from fastdiffsr_tpu_torch.ops.fused_conv import (
    fused_gn_swish_conv3x3, fused_gn_swish_conv3x3_plain)
from fastdiffsr_tpu_torch.ops.groupnorm import (
    channel_stats, channel_stats_plain, channel_stats_plan, gn_swish,
    gn_swish_custom, gn_swish_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (source widths, Co, groups, apply_norm, want_stats, shift, res, H, W)
CASES = {
    "one_source": ((64,), 64, 32, True, True, True, True, 16, 32),
    "two_sources_straddle": ((128, 64), 64, 32, True, True, True, False,
                             24, 20),
    "stem_c6": ((6,), 64, 1, False, True, False, False, 17, 33),
    "final_co3": ((64,), 3, 32, True, False, False, False, 16, 16),
    "co_not_multiple_of_tile": ((40,), 80, 8, True, True, False, True, 9, 7),
    # two N tiles of 128, three row tiles, a shift and a residual
    "co256": ((32,), 256, 8, True, True, True, True, 36, 20),
    # one N tile of 128 and a source boundary inside a GroupNorm group
    "two_sources_co128": ((64, 32), 128, 16, True, True, False, True, 18, 18),
    "ragged_7x9": ((40,), 48, 8, True, True, True, False, 7, 9),
    "upsample_conv": ((128,), 128, 32, False, True, False, False, 32, 32),
}
ROUTE = {torch.float32: "cuda_cores", torch.bfloat16: "wgmma"}
# float32 cases for each tile of csrc/fused_conv.cu, as (source widths,
# Co, groups, apply_norm, want_stats, shift, res, H, W, B, the tile that
# test_torch_k3_f32_tiling.f32_tile says the launcher takes)
F32_CASES = {
    # batch 1, the validation batch: the small tile (four groups split each
    # stage's channels), 64 blocks at 32^2 and 256 at 64^2
    "b1_32x32_co256": ((256,), 256, 32, True, True, True, True, 32, 32, 1,
                       "small"),
    "b1_64x64_co256": ((256,), 256, 32, True, True, False, False, 64, 64, 1,
                       "small"),
    "b1_two_sources_256_256": ((256, 256), 256, 32, True, True, False,
                               False, 32, 32, 1, "small"),
    "wide_two_sources_256_256": ((256, 256), 256, 32, True, True, True,
                                 False, 32, 32, 9, "wide"),
    "wide64_two_sources_128_64": ((128, 64), 64, 32, True, True, True, True,
                                  64, 64, 9, "wide64"),
    "wide64_stem_c6": ((6,), 64, 1, False, True, False, False, 64, 64, 9,
                       "wide64"),
    "wide_no_norm": ((128,), 128, 32, False, True, False, False, 64, 64, 5,
                     "wide"),
    "narrow_final_co3": ((64,), 3, 32, True, False, False, False, 40, 70, 2,
                         "narrow"),
    "small_ragged_7x9": ((40,), 48, 8, True, True, True, True, 7, 9, 1,
                         "small"),
}


def check_kernel_against_plain(cuda, dt, Cs, Co, G, norm, want_stats,
                               with_shift, with_res, H, W, B):
    """One K3 call on the card against its plain version: the launch is
    counted on the route of its type, a second call gives the same bits,
    y is within atol 1e-3 (f32) or two bf16 steps of |y| (bf16), the
    statistics within 1e-4 of the sum of squares' scale."""
    C = sum(Cs)
    g = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=g, device=cuda) * s

    xs = tuple(rnd(B, H, W, c).to(dt) for c in Cs)
    stats = tuple(channel_stats_plain(x) for x in xs)
    args = (xs if len(xs) > 1 else xs[0],
            rnd(C, s=0.1) + 1 if norm else None,
            rnd(C, s=0.1) if norm else None,
            (stats if len(xs) > 1 else stats[0]) if norm else None,
            rnd(3, 3, C, Co, s=(9 * C) ** -0.5), rnd(Co, s=0.1))
    kw = dict(groups=G, apply_norm=norm, want_stats=want_stats,
              shift=rnd(B, Co, s=0.1) if with_shift else None,
              res=rnd(B, H, W, Co).to(dt) if with_res else None)
    before = kernels.LAUNCHES["fused_gn_swish_conv3x3"]
    taken = fused_conv.ROUTE_TAKEN[ROUTE[dt]]
    got = fused_gn_swish_conv3x3(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_gn_swish_conv3x3"] == before + 1
    assert fused_conv.ROUTE_TAKEN[ROUTE[dt]] == taken + 1
    again = fused_gn_swish_conv3x3(*args, **kw)
    torch.cuda.synchronize()
    for g1, g2 in zip(got if want_stats else (got,),
                      again if want_stats else (again,)):
        assert torch.equal(g1, g2)      # no atomics: the same on every run
    want = fused_gn_swish_conv3x3_plain(*args, **kw)
    if not want_stats:
        got, want = (got,), (want,)
    assert got[0].dtype == dt and got[0].shape == (B, H, W, Co)
    y, yw = got[0].float(), want[0].float()
    if dt == torch.float32:
        torch.testing.assert_close(y, yw, rtol=0, atol=1e-3)
    else:
        assert ((y - yw).abs() <= yw.abs() * 2 ** -6 + 2e-3).all()
    if want_stats:
        scale = want[1][:, 1].abs().max().item()
        torch.testing.assert_close(got[1], want[1], rtol=0,
                                   atol=1e-4 * scale + 1e-3)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_conv_kernel_matches_plain(cuda, case, dt):
    """f32: atol 1e-3 (summation order); bf16: two bf16 steps of |y|
    (a sum that differs in its last float32 bits rounds to the
    neighbouring bf16 value). Statistics: 1e-4 of the sum of squares'
    scale."""
    check_kernel_against_plain(cuda, dt, *CASES[case], B=2)


@pytest.mark.parametrize("case", sorted(F32_CASES))
def test_fused_conv_f32_tiles_match_plain(cuda, case):
    """The float32 kernel on each of its tiles, the one the launcher takes
    for the case's grid; tolerances as in the test above."""
    *args, B, tile = F32_CASES[case]
    Cs, Co, H, W = args[0], args[1], args[7], args[8]
    from test_torch_k3_f32_tiling import TILES
    assert f32_tile(B, H, W, Co) == TILES[tile]
    check_kernel_against_plain(cuda, torch.float32, *args, B=B)


def test_f32_tile_count_is_the_launchers(cuda):
    """The library's tile count, which sizes the partial statistics, is
    that of the tile test_torch_k3_f32_tiling.f32_tile mirrors, at every
    full-width shape at batch 16 and 1."""
    lib = kernels.load()
    for B in (16, 1):
        for _, hw, Co in FULL_WIDTH:
            th, tw, _, _ = f32_tile(B, hw, hw, Co)
            assert lib.fdsr_fused_conv_tiles(B, hw, hw, Co) == (
                cdiv(hw, th) * cdiv(hw, tw)), (B, hw, Co)


# (B, H, W, C) of K2 on the card: the serving shape; C = 40 (a second
# slab of 8 channels); three images; the 512^2 eval's largest map (256^2 x
# 64); C = 6 and 42, no multiple of the vector width (the scalar path);
# C = 264, nine slabs
K2_SHAPES = [(2, 128, 128, 64), (3, 7, 9, 40), (3, 64, 64, 128),
             (1, 256, 256, 64), (2, 9, 7, 6), (2, 5, 11, 42),
             (2, 16, 16, 264)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K2_SHAPES)
def test_channel_stats_kernel_matches_plain(cuda, shape, dt):
    """float32 sums in another order: rtol 1e-5 of the sum of squares. One
    launch counted per call; the kernel's sums are bit-equal to the CPU
    model of its order under the plan the wrapper gave it
    (tests/torch_k2_model.py), and ten more calls to the first."""
    g = torch.Generator(device=cuda).manual_seed(8)
    x = (torch.randn(shape, generator=g, device=cuda) * 1.5 + 0.5).to(dt)
    before = kernels.LAUNCHES["channel_stats"]
    got = channel_stats(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["channel_stats"] == before + 1
    want = channel_stats_plain(x)
    scale = want[:, 1].abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    B, H, W, C = shape
    plan = channel_stats_plan(B, H * W, C, x.element_size())
    assert torch.equal(got.cpu(), k2_model(x.cpu(), plan))
    for _ in range(10):
        assert torch.equal(channel_stats(x), got)


def test_channel_stats_constants_are_the_librarys(cuda):
    """The plan's mirror of csrc/channel_stats.cu's constants."""
    lib = kernels.load()
    assert lib.fdsr_channel_stats_threads() == groupnorm.K2_THREADS
    assert lib.fdsr_channel_stats_slab() == groupnorm.K2_SLAB
    assert (lib.fdsr_channel_stats_final_lanes()
            == groupnorm.K2_FINAL_LANES)
    assert (lib.fdsr_channel_stats_counter_slots()
            == groupnorm.K2_COUNTER_SLOTS)
    assert (lib.fdsr_channel_stats_slot_counters()
            == groupnorm.K2_SLOT_COUNTERS)
    assert lib.fdsr_channel_stats_unroll() >= 4


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_channel_stats_unaligned_map_takes_scalar_loads(cuda, dt):
    """A contiguous map whose data is not 16-byte aligned (a view one
    element into a buffer) takes the scalar path, bit-equal to the model."""
    buf = torch.randn(1 + 2 * 24 * 20 * 64, device=cuda).to(dt)
    x = buf[1:].view(2, 24, 20, 64)
    assert x.data_ptr() % 16 != 0
    plan = channel_stats_plan(2, 24 * 20, 64, x.element_size(), False)
    assert plan.vec == 1
    got = channel_stats(x)
    assert torch.equal(got.cpu(), k2_model(x.cpu(), plan))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_channel_stats_is_one_launch_and_replays_bit_equal(cuda, dt):
    """One K2 call is one kernel node of a captured CUDA graph (K1 two, its
    pass 1 and pass 2); three replays of a captured call give the eager
    call's bits, so the last block's counter is back at 0 after each."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((1, 128, 128, 64), generator=g, device=cuda).to(dt)
    one = torch.ones(64, device=cuda)
    assert kernels.kernels_per_call(lambda: channel_stats(x)) == 1
    assert kernels.kernels_per_call(lambda: gn_swish(x, one, one, 32)) == 2
    eager = channel_stats(x)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = channel_stats(x)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_channel_stats_on_two_streams(cuda):
    """Calls on two streams at once use counters of their own: each stream's
    results equal the eager call's bits."""
    g = torch.Generator(device=cuda).manual_seed(10)
    xs = [torch.randn((4, 64, 64, 128), generator=g, device=cuda)
          for _ in range(2)]
    want = [channel_stats(x) for x in xs]
    streams = [torch.cuda.Stream() for _ in xs]
    outs = [[], []]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(20):
        for i, (s, x) in enumerate(zip(streams, xs)):
            with torch.cuda.stream(s):
                outs[i].append(channel_stats(x))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(o, want[i]) for o in outs[i])


def test_channel_stats_refuses_what_its_counters_cannot_hold(cuda):
    """B x channel slabs beyond a slot's counters, and an empty map, raise
    before any launch."""
    before = kernels.LAUNCHES["channel_stats"]
    with pytest.raises(ValueError, match="counters"):
        channel_stats(torch.zeros((200, 1, 1, 3072), device=cuda))
    with pytest.raises(ValueError, match="empty"):
        channel_stats(torch.zeros((0, 4, 4, 8), device=cuda))
    assert kernels.LAUNCHES["channel_stats"] == before


# the last seven are the maps the UNet's exact rewrites give K1 at 64->256,
# batch 16: fold's level-0 maps at half the batch with twice the groups
# (group sizes 2, 6 and 4), and the skip_concat='split' parts
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [((2, 32, 32, 64), 32),
                                          ((2, 16, 16, 192), 32),
                                          ((3, 6, 6, 24), 4),
                                          ((2, 9, 7, 6), 3),
                                          ((8, 256, 256, 128), 64),
                                          ((8, 256, 256, 384), 64),
                                          ((8, 256, 256, 256), 64),
                                          ((16, 32, 32, 256), 16),
                                          ((16, 64, 64, 256), 16),
                                          ((16, 128, 128, 128), 16),
                                          ((16, 256, 256, 64), 16)])
def test_gn_swish_kernel_matches_plain(cuda, shape, groups, dt):
    """K1 against its plain version. f32: atol 1e-4 (statistics summed in
    another order shift mean and 1/std by a few float32 steps); bf16: one
    bf16 step of |y| (2^-7 |y| + 1e-5), since a float32 value a few steps
    off can round to the neighbouring bf16 value. C=6 takes the scalar
    path of the kernel."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dt)
    C = shape[-1]
    scale = torch.randn(C, generator=g, device=cuda) * 0.1 + 1
    bias = torch.randn(C, generator=g, device=cuda) * 0.1
    before = kernels.LAUNCHES["gn_swish"]
    got = gn_swish(x, scale, bias, groups)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gn_swish"] == before + 1
    want = gn_swish_plain(x, scale, bias, groups)
    assert got.dtype == dt and got.shape == shape
    y, yw = got.float(), want.float()
    if dt == torch.float32:
        torch.testing.assert_close(y, yw, rtol=0, atol=1e-4)
    else:
        assert ((y - yw).abs() <= yw.abs() * 2 ** -7 + 1e-5).all()


def test_gn_swish_custom_gradient_on_card(cuda):
    """gn_swish_custom (K1 forward, VJP of gn_swish_reference) against
    autograd of gn_swish_plain, K1's own formulation: atol 1e-4 of max
    |g| (the two variance formulas differ in their last float32 bits)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, 16, 16, 64, generator=g, device=cuda)
    s = torch.randn(64, generator=g, device=cuda) * 0.1 + 1
    b = torch.randn(64, generator=g, device=cuda) * 0.1
    cot = torch.randn(x.shape, generator=g, device=cuda)
    grads = []
    for fn in (gn_swish_custom, gn_swish_plain):
        leaves = [t.clone().requires_grad_() for t in (x, s, b)]
        (fn(*leaves, 16) * cot).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, r in zip(*grads):
        torch.testing.assert_close(a, r, rtol=0,
                                   atol=1e-4 * r.abs().max().item())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W", [(2, 24, 40), (9, 64, 64)])
def test_statistics_flow_from_kernel_to_kernel(cuda, dt, B, H, W):
    """K2's output goes straight into K3 and K1 (no PyTorch op between),
    and K3's own statistics into the next K3: each against the plain
    version fed the same tensors. In f32 the first shape runs on the small
    tile, the second on the 16x16 one."""
    g = torch.Generator(device=cuda).manual_seed(5)
    C, Co, G = 64, 64, 16
    x = (torch.randn((B, H, W, C), generator=g, device=cuda) + 0.3).to(dt)
    gs = torch.randn(C, generator=g, device=cuda) * 0.1 + 1
    gb = torch.randn(C, generator=g, device=cuda) * 0.1
    w = torch.randn((3, 3, C, Co), generator=g, device=cuda) * (9 * C) ** -.5
    b = torch.randn(Co, generator=g, device=cuda) * 0.1
    st = channel_stats(x)
    y1, st1 = fused_gn_swish_conv3x3(x, gs, gb, st, w, b, groups=G)
    y2, st2 = fused_gn_swish_conv3x3(y1, gs, gb, st1, w, b, groups=G, res=x)
    torch.cuda.synchronize()
    w1, wst1 = fused_gn_swish_conv3x3_plain(x, gs, gb, st, w, b, groups=G)
    w2, _ = fused_gn_swish_conv3x3_plain(y1, gs, gb, st1, w, b, groups=G,
                                         res=x)
    tol = (lambda ref: 1e-3) if dt == torch.float32 else (
        lambda ref: ref.abs() * 2 ** -6 + 2e-3)
    assert ((y1.float() - w1.float()).abs() <= tol(w1.float())).all()
    assert ((y2.float() - w2.float()).abs() <= tol(w2.float())).all()
    scale = wst1[:, 1].abs().max().item()
    torch.testing.assert_close(st1, wst1, rtol=0, atol=1e-4 * scale + 1e-3)
    k1 = gn_swish(x, gs, gb, G)
    k1w = gn_swish_plain(x, gs, gb, G)
    if dt == torch.float32:
        torch.testing.assert_close(k1, k1w, rtol=0, atol=1e-4)
    else:
        assert ((k1.float() - k1w.float()).abs()
                <= k1w.float().abs() * 2 ** -7 + 1e-5).all()


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("beta", [-80.0, -95.0, -300.0, 95.0])
def test_fused_conv_swish_far_from_zero(cuda, beta, dt):
    """A quarter of the channels get a GroupNorm bias far from zero. Below
    -87 the e^-x of the swish leaves the range in which the kernels'
    reciprocal (rcp_newton) is exact, and they hold the denominator at
    2^126: the result stays finite and within the tolerance of the plain
    version (f32: atol 1e-3; bf16: two bf16 steps of the largest term)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B, H, W, C, Co, G = 2, 20, 18, 64, 64, 16
    x = torch.randn((B, H, W, C), generator=g, device=cuda).to(dt)
    gs = torch.randn(C, generator=g, device=cuda) * 0.1 + 1
    gb = torch.randn(C, generator=g, device=cuda) * 0.1
    gb[::4] = beta
    w = torch.randn((3, 3, C, Co), generator=g, device=cuda) * (9 * C) ** -.5
    b = torch.randn(Co, generator=g, device=cuda) * 0.1
    st = channel_stats(x)
    y, ys = fused_gn_swish_conv3x3(x, gs, gb, st, w, b, groups=G)
    torch.cuda.synchronize()
    yw, _ = fused_gn_swish_conv3x3_plain(x, gs, gb, st, w, b, groups=G)
    assert torch.isfinite(y.float()).all() and torch.isfinite(ys).all()
    if dt == torch.float32:
        torch.testing.assert_close(y, yw, rtol=0, atol=1e-3)
        return
    tol = yw.float().abs() * 2 ** -6 + 2e-3 * max(1.0, beta)
    assert ((y.float() - yw.float()).abs() <= tol).all()


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_fused_conv_channel_limit_is_the_kernels(cuda, dt):
    """Each kernel says how many input channels its affine arrays hold; the
    wrapper takes that many and raises for one chunk more."""
    lib = kernels.load()
    C = (lib.fdsr_fused_conv_wgmma_max_channels() if dt == torch.bfloat16
         else lib.fdsr_fused_conv_max_channels())
    assert C >= 1024      # the UNet's widest K3 input has 512
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((1, 6, 5, C), generator=g, device=cuda).to(dt)
    gs = torch.randn(C, generator=g, device=cuda) * 0.1 + 1
    gb = torch.randn(C, generator=g, device=cuda) * 0.1
    w = torch.randn((3, 3, C, 8), generator=g, device=cuda) * (9 * C) ** -.5
    b = torch.zeros(8, device=cuda)
    st = channel_stats_plain(x)
    y, sty = fused_gn_swish_conv3x3(x, gs, gb, st, w, b, groups=8)
    torch.cuda.synchronize()
    yw, stw = fused_gn_swish_conv3x3_plain(x, gs, gb, st, w, b, groups=8)
    assert ((y.float() - yw.float()).abs()
            <= yw.float().abs() * 2 ** -6 + 2e-3).all()
    torch.testing.assert_close(sty, stw, rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="exceed"):
        fused_gn_swish_conv3x3(
            torch.zeros((1, 4, 4, C + 16), device=cuda, dtype=dt), None,
            None, None, torch.zeros((3, 3, C + 16, 8), device=cuda), b,
            apply_norm=False)


def test_fused_conv_rejects_what_the_kernels_do_not_take(cuda):
    x = torch.randn(1, 8, 8, 16, device=cuda)
    w = torch.randn(3, 3, 16, 8, device=cuda)
    b = torch.zeros(8, device=cuda)
    one = torch.ones(16, device=cuda)
    st = channel_stats_plain(x)
    with pytest.raises(ValueError, match="contiguous"):     # strided map
        fused_gn_swish_conv3x3(
            torch.randn(1, 8, 16, 8, device=cuda).transpose(2, 3), None,
            None, None, w, b, apply_norm=False)
    with pytest.raises(TypeError):                          # wrong dtype
        fused_gn_swish_conv3x3(x.half(), None, None, None, w, b,
                               apply_norm=False)
    with pytest.raises(ValueError, match="stats_in"):       # float64 sums
        fused_gn_swish_conv3x3(x, one, one, st.double(), w, b, groups=4)
    with pytest.raises(ValueError, match="one device"):     # weights on CPU
        fused_gn_swish_conv3x3(x, None, None, None, w.cpu(), b,
                               apply_norm=False)
    with pytest.raises(ValueError, match="res must be"):    # residual dtype
        fused_gn_swish_conv3x3(x.bfloat16(), None, None, None, w, b,
                               apply_norm=False,
                               res=torch.zeros(1, 8, 8, 8, device=cuda))
    with pytest.raises(ValueError, match="exceed"):         # too wide
        fused_gn_swish_conv3x3(
            torch.zeros(1, 4, 4, 2048, device=cuda), None, None, None,
            torch.zeros(3, 3, 2048, 8, device=cuda), b, apply_norm=False)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(1, 8, 8, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        channel_stats(x)
    with pytest.raises(ValueError, match="contiguous"):
        channel_stats(torch.randn(1, 8, 16, 8, device=cuda).transpose(1, 2))
    one = torch.ones(16, device=cuda)
    with pytest.raises(TypeError):
        gn_swish(x, one, one, 4)
    with pytest.raises(ValueError, match="contiguous"):
        gn_swish(torch.randn(1, 16, 8, 8, device=cuda).permute(0, 2, 3, 1),
                 one[:8], one[:8], 4)
    w = torch.randn(3, 3, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="weight shape"):
        fused_gn_swish_conv3x3(torch.randn(1, 8, 8, 16, device=cuda), None,
                               None, None, w, torch.zeros(8, device=cuda),
                               apply_norm=False)


def test_fused_unet_matches_plain_on_card(cuda):
    """A small UNet (inner 32, groups 16, mults (1, 2)) on the card: the
    fused forward on K3/K2 against the plain forward, f32 (atol 1e-4,
    summation order) and bf16 (atol 0.1 on outputs up to ~3: both round
    every block's input to bf16, at different places)."""
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import (FastDiffSRUNet,
                                                             init_params)
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr_fused import (
        fused_apply, prepare_fused_params)
    net = init_params(FastDiffSRUNet(inner_channel=32, norm_groups=16,
                                     channel_mults=(1, 2), dropout=0.0),
                      seed=1).to(cuda).eval()
    x = torch.randn(2, 32, 32, 6, device=cuda)
    lvl = torch.tensor([0.7, 0.3], device=cuda)
    before = dict(kernels.LAUNCHES)
    for dt, atol in ((torch.float32, 1e-4), (torch.bfloat16, 0.1)):
        net.dtype = dt
        with torch.no_grad():
            want = net(x, lvl)
        got = fused_apply(prepare_fused_params(net, dt), x, lvl)
        assert got.dtype == want.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0, atol=atol)
    # stem + 2x(2 res blocks x 2) down, 2 mid x 2, 2x(3 x 2) up, 1
    # Upsample, final: 1 + 8 + 4 + 12 + 1 + 1 = 27 K3 calls per eval
    assert kernels.LAUNCHES["fused_gn_swish_conv3x3"] == (
        before["fused_gn_swish_conv3x3"] + 2 * 27)
    assert kernels.LAUNCHES["channel_stats"] == before["channel_stats"] + 2 * 2


@pytest.mark.parametrize("kw", [{"upsample_mode": "tconv"},
                                {"upsample_mode": "d2s2"}, {"fold": "down"},
                                {"fold": "all"}, {"skip_concat": "split"},
                                {"skip_concat": "swap"},
                                {"conv_split": "ups_0,ups_5"}])
def test_rewrite_modes_match_literal_on_card(cuda, kw):
    """The plain UNet (inner 32, groups 16, mults (1, 2)) on the card in
    each exact rewrite against the literal form, same weights, f32: atol
    1e-4 (summation order); K1 takes every GroupNorm -> Swish, and the
    split form adds one call per split up block."""
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import (FastDiffSRUNet,
                                                             init_params)
    small = dict(inner_channel=32, norm_groups=16, channel_mults=(1, 2),
                 dropout=0.0)
    lit = init_params(FastDiffSRUNet(**small), seed=1).to(cuda).eval()
    net = FastDiffSRUNet(**small, **kw).to(cuda).eval()
    net.load_state_dict(lit.state_dict())
    x = torch.randn(2, 32, 32, 6, device=cuda)
    lvl = torch.tensor([0.7, 0.3], device=cuda)
    with torch.no_grad():
        want = lit(x, lvl)
        before = kernels.LAUNCHES["gn_swish"]
        got = net(x, lvl)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    # 12 ResnetBlocks x 2 + the final Block; split: ups_0, ups_1, ups_5
    # and ups_6 take the parts apart (group size 8 or 4 divides x's width)
    n_split = sum(m.split_input for m in net.ups if hasattr(m, "split_input"))
    assert kernels.LAUNCHES["gn_swish"] - before == 25 + n_split


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_tconv_repeats_bit_equal_on_card(cuda, dtype):
    """The tconv Upsample's transposed conv (``ops.tconv.upsample_tconv``,
    cuDNN's deterministic algorithms) at the 128x128, C=128 map of a
    64->256 eval, batch 4: a second call, and a second backward, give the
    same bits, with cuDNN's timing on as the trainers set it."""
    from fastdiffsr_tpu_torch.ops.tconv import upsample_tconv
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        g = torch.Generator(device=cuda).manual_seed(3)
        x = torch.randn((4, 128, 128, 128), generator=g, device=cuda,
                        dtype=dtype).permute(0, 3, 1, 2).requires_grad_()
        w = (torch.randn((128, 128, 4, 4), generator=g, device=cuda,
                         dtype=dtype) / 40).requires_grad_()
        b = torch.randn(128, generator=g, device=cuda,
                        dtype=dtype).requires_grad_()
        dy = torch.randn((4, 128, 256, 256), generator=g, device=cuda,
                         dtype=dtype)
        runs = []
        for _ in range(2):
            y = upsample_tconv(x, w, b)
            runs.append((y.detach(), *torch.autograd.grad(y, (x, w, b), dy)))
        for a, c in zip(*runs):
            assert torch.equal(a, c)
    finally:
        torch.backends.cudnn.benchmark = prev


# Q1 (B, H, W, Ci, Co): a 128-row map of the UNet's first stage, the final
# Block's Co = 3 (the 8-wide N) with ragged H and W, the odd Ci = 192 with
# Co = 128 (two warpgroups a patch, 8x16 tiles, its weights streamed a
# chunk at a time); then Ci = 4 (one chunk, 8-byte bfloat16 copies), Ci =
# 36 and 100 (padded chunks), Co = 256 (four warpgroups a patch, 8x8
# tiles), Co = 80 and 300 (a partial and a second block of output
# channels), and more tiles than SMs (a block walks several tiles; Ci = 160
# at Co = 128 streams an odd number of chunks)
Q1_CASES = [(2, 128, 64, 64, 64), (1, 37, 21, 64, 3), (1, 20, 40, 192, 128),
            (1, 19, 23, 4, 64), (2, 17, 33, 36, 128), (1, 25, 18, 100, 256),
            (1, 9, 40, 64, 80), (1, 12, 12, 32, 300), (4, 97, 90, 64, 64),
            (2, 130, 120, 160, 128)]


def _q1_inputs(case, dt, static, device):
    from fastdiffsr_tpu_torch.ops import quant
    B, H, W, ci, co = case
    g = torch.Generator(device=device).manual_seed(ci + co)
    h = (torch.randn(B, H, W, ci, generator=g, device=device) * 2).to(dt)
    w = torch.randn(co, ci, 3, 3, generator=g, device=device) * 0.05
    b = torch.randn(co, generator=g, device=device) * 0.1
    q_w, s_w = quant.quantize_weights(w)
    return h, quant.pack_weights(q_w), s_w, quant.activation_scale(
        h, static), b


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", Q1_CASES)
def test_quant_conv_kernel_matches_plain(cuda, case, dt, static):
    """Q1 against its plain version on the same inputs: the int32
    accumulators and the dequantized output bit-equal, with and without
    the accumulator output, one counted launch a call, and the wrapper's
    output-channel tile and tile rows the library's."""
    from fastdiffsr_tpu_torch.ops import quant
    co = case[-1]
    h, packed, s_w, s_a, b = _q1_inputs(case, dt, static, cuda)
    before = kernels.LAUNCHES["quant_conv3"]
    y, acc = quant.quant_conv3_launch(h, packed, s_w, s_a, b, dt,
                                      want_acc=True)
    y_only = quant.quant_conv3_launch(h, packed, s_w, s_a, b, dt)
    assert kernels.LAUNCHES["quant_conv3"] == before + 2
    y_want, acc_want = quant.quant_conv3_apply_plain(h, packed, s_w, s_a, b,
                                                     dt, want_acc=True)
    torch.cuda.synchronize()
    assert torch.equal(acc, acc_want)
    assert torch.equal(y, y_want)
    assert torch.equal(y_only, y_want)
    lib = kernels.load()
    assert lib.fdsr_quant_conv3_co_tile(co) == quant.co_tile(co)
    assert (lib.fdsr_quant_conv3_tile_rows(co),
            lib.fdsr_quant_conv3_tile_cols(co)) == quant.tile_shape(co)


@pytest.mark.parametrize("case", [Q1_CASES[0], Q1_CASES[5]])
def test_quant_conv_is_one_kernel_per_call(cuda, case):
    """A call is one kernel on the card (the kernel nodes of a CUDA graph
    that captured it), the accumulator output included."""
    from fastdiffsr_tpu_torch.ops import quant
    h, packed, s_w, s_a, b = _q1_inputs(case, torch.bfloat16, False, cuda)
    assert kernels.kernels_per_call(lambda: quant.quant_conv3_launch(
        h, packed, s_w, s_a, b, torch.bfloat16, want_acc=True)) == 1


def test_quant_conv_refuses_what_the_kernel_does_not_take(cuda):
    from fastdiffsr_tpu_torch.ops import quant
    w = torch.randn(8, 6, 3, 3, device=cuda)
    h = torch.randn(1, 8, 8, 6, device=cuda)
    q_w, s_w = quant.quantize_weights(w)
    s_a = quant.activation_scale(h, False)
    b = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        quant.quant_conv3_launch(h, quant.pack_weights(q_w), s_w, s_a, b,
                                 torch.float32)
    h = torch.randn(1, 8, 8, 8, device=cuda, dtype=torch.float16)
    w = torch.randn(8, 8, 3, 3, device=cuda)
    q_w, s_w = quant.quantize_weights(w)
    with pytest.raises(TypeError):
        quant.quant_conv3_launch(h, quant.pack_weights(q_w), s_w, s_a, b,
                                 torch.float32)
    # weights in another layout (the mma.sync kernel's (9, Co_pad, Ci_pad))
    # or a view that is not 16-byte aligned
    h = torch.randn(1, 8, 8, 8, device=cuda)
    flat = torch.zeros(9, 8, 32, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="packed weights"):
        quant.quant_conv3_launch(h, flat, s_w, s_a, b, torch.float32)
    packed = quant.pack_weights(q_w)
    shifted = torch.zeros(packed.numel() + 8, dtype=torch.int8,
                          device=cuda)[8:].view(packed.shape)
    with pytest.raises(ValueError, match="aligned"):
        quant.quant_conv3_launch(h, shifted, s_w, s_a, b, torch.float32)


def test_chained_train_step_replays_eager_steps(cuda):
    """make_cached_train_step(n_sub=3) on the card: the first call runs 3
    eager steps and captures them, the second replays the CUDA graph;
    against 6 unchained steps from the same state, taken after them
    (dropout on, the EMA starting inside the replay, cuDNN's
    deterministic algorithms) the parameters, EMA and losses are
    bit-equal; a replay runs 3 x the K1
    launches of one eager step (its gn_swish and channel_stats kernels in
    a torch.profiler trace of the replay), and counts none on the host."""
    from torch.profiler import ProfilerActivity, profile

    from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine,
                                                DiffusionSpec,
                                                ScheduleBuffers)
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import (FastDiffSRUNet,
                                                             init_params)
    from fastdiffsr_tpu_torch.train import (create_train_state,
                                            make_cached_train_step,
                                            make_optimizer)

    sched = {"schedule": "linear_cosine", "n_timestep": 20,
             "linear_start": 1e-6, "linear_end": 1e-2}
    eng = DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                          ScheduleBuffers.create(sched, device=cuda))
    g = torch.Generator(device=cuda).manual_seed(3)
    data = {k: torch.randint(0, 256, (8, 32, 32, 3), generator=g,
                             device=cuda, dtype=torch.uint8)
            for k in ("HR", "SR")}

    def state():
        net = init_params(FastDiffSRUNet(inner_channel=32, norm_groups=8,
                                         channel_mults=(1, 2),
                                         res_blocks=1, dropout=0.2),
                          5).to(cuda)
        return create_train_state(net, make_optimizer(net.parameters(),
                                                      {"lr": 1e-3}))

    torch.backends.cudnn.deterministic = True
    try:
        a, b = state(), state()
        eager = make_cached_train_step(eng, 4, ema_decay=0.9, ema_start=4)
        chained = make_cached_train_step(eng, 4, ema_decay=0.9, ema_start=4,
                                         n_sub=3)
        got = [chained(b, data, 9)[1]["l_pix"] for _ in range(1)]
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got.append(chained(b, data, 9)[1]["l_pix"])
            torch.cuda.synchronize()
        host = dict(kernels.LAUNCHES)
        kernels.reset_launch_counts()
        want = [eager(a, data, 9)[1]["l_pix"] for _ in range(6)]
        k1_per_step = kernels.LAUNCHES["gn_swish"] // 6
    finally:
        torch.backends.cudnn.deterministic = False
    assert not any(host.values())
    assert a.step == b.step == 6
    assert torch.equal(torch.cat(got), torch.stack(want))
    pa = dict(a.net.named_parameters())
    for k, p in b.net.named_parameters():
        assert torch.equal(p, pa[k]), k
        assert torch.equal(b.ema_params[k], a.ema_params[k]), k
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert k1_per_step > 0
    for kernel in ("gn_swish_apply_kernel", "channel_stats_kernel"):
        assert sum(kernel in n for n in names) == 3 * k1_per_step, kernel


def _tiny_train_state(cuda):
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import (FastDiffSRUNet,
                                                             init_params)
    from fastdiffsr_tpu_torch.train import create_train_state, make_optimizer
    net = init_params(FastDiffSRUNet(inner_channel=32, norm_groups=8,
                                     channel_mults=(1, 2), res_blocks=1,
                                     dropout=0.2), 5).to(cuda)
    return create_train_state(net, make_optimizer(net.parameters(),
                                                  {"lr": 1e-3}))


def test_chained_train_step_under_a_process_group_on_card(cuda):
    """A one-rank NCCL group, the nets DDP-wrapped as under -dist: the
    chained step (n_sub=3) captures the bare net with its gradients'
    all-reduce and replays it; against 6 unchained DDP steps from the
    same state (dropout on, the EMA starting inside the replay, cuDNN's
    deterministic algorithms) the parameters, EMA and losses are
    bit-equal, and a replay runs 3 x one step's K1 launches."""
    import socket

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine,
                                                DiffusionSpec,
                                                ScheduleBuffers)
    from fastdiffsr_tpu_torch.train import make_cached_train_step

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0, device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    sched = {"schedule": "linear_cosine", "n_timestep": 20,
             "linear_start": 1e-6, "linear_end": 1e-2}
    eng = DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                          ScheduleBuffers.create(sched, device=cuda))
    g = torch.Generator(device=cuda).manual_seed(3)
    data = {k: torch.randint(0, 256, (8, 32, 32, 3), generator=g,
                             device=cuda, dtype=torch.uint8)
            for k in ("HR", "SR")}
    torch.backends.cudnn.deterministic = True
    try:
        a, b = _tiny_train_state(cuda), _tiny_train_state(cuda)
        assert a.train_net is not a.net             # DDP
        eager = make_cached_train_step(eng, 4, ema_decay=0.9, ema_start=4)
        chained = make_cached_train_step(eng, 4, ema_decay=0.9, ema_start=4,
                                         n_sub=3)
        got = [chained(b, data, 9)[1]["l_pix"]]
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got.append(chained(b, data, 9)[1]["l_pix"])
            torch.cuda.synchronize()
        host = dict(kernels.LAUNCHES)
        kernels.reset_launch_counts()
        want = [eager(a, data, 9)[1]["l_pix"] for _ in range(6)]
        k1_per_step = kernels.LAUNCHES["gn_swish"] // 6
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()
    assert not any(host.values())
    assert a.step == b.step == 6
    assert torch.equal(torch.cat(got), torch.stack(want))
    pa = dict(a.net.named_parameters())
    for k, p in b.net.named_parameters():
        assert torch.equal(p, pa[k]), k
        assert torch.equal(b.ema_params[k], a.ema_params[k]), k
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert k1_per_step > 0
    for kernel in ("gn_swish_apply_kernel", "channel_stats_kernel"):
        assert sum(kernel in n for n in names) == 3 * k1_per_step, kernel


@pytest.mark.parametrize("variant", ["fastdiffsr", "ddpm"])
def test_scan_export_runs_the_kernels_in_its_loop_on_card(cuda, variant):
    """The serving export's scan form on the card (T=6 ancestral, a
    symbolic batch traced at 2, run at 3): bit-equal to the unrolled
    artifact fed the noise it drew from its seeds, its CPU copy
    (``move_to_device_pass``) within 1e-5 of the in-process sampler on
    the CPU fed that noise; the kernels of the
    forward (fused FastDiffSR: K3 and K2; plain SR3: K1) launch from the
    operators inside the loop, T or T + 1 evals' worth a call (torch
    2.11's scan runs its body once more than T)."""
    import copy

    from fastdiffsr_tpu_torch import serving
    from fastdiffsr_tpu_torch.cli.infer import make_denoiser
    from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine,
                                                DiffusionSpec,
                                                ScheduleBuffers,
                                                counter_noise)
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import (FastDiffSRUNet,
                                                             init_params)
    from fastdiffsr_tpu_torch.models.unet_sr3 import SR3UNet
    from fastdiffsr_tpu_torch.train import make_sample_fn, pad_batch_with_keys

    T, size = 6, 32
    sched = {"schedule": "linear", "n_timestep": T, "linear_start": 1e-4,
             "linear_end": 2e-1}
    eng = DiffusionEngine(DiffusionSpec.for_variant(variant),
                          ScheduleBuffers.create(sched, device=cuda))
    cpu_eng = DiffusionEngine(DiffusionSpec.for_variant(variant),
                              ScheduleBuffers.create(sched, device="cpu"))
    fused = variant == "fastdiffsr"
    if fused:
        net = init_params(FastDiffSRUNet(inner_channel=32, norm_groups=8,
                                         channel_mults=(1, 2),
                                         res_blocks=1), 5)
    else:
        torch.manual_seed(5)
        net = SR3UNet(inner_channel=32, norm_groups=8, channel_mults=(1, 2),
                      attn_res=(16,), res_blocks=1, image_size=size)
    net = net.to(cuda).eval()
    loaded = []
    for loop in (True, False):
        ep, meta = serving.build_sample_export(eng, net, size, fused=fused,
                                               loop=loop)
        loaded.append(serving.ExportedSampler(ep, meta))
    scan, unrolled = loaded
    cond = torch.rand((3, size, size, 3), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda) * 2 - 1
    gens = pad_batch_with_keys(cond.cpu().numpy(), 3, 4, 0, device=cuda)[1]
    params = {k: v.detach() for k, v in net.state_dict().items()}
    kernels.reset_launch_counts()
    got = scan(params, cond, gens)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    init, seq = scan.sampler_noise(cond, pad_batch_with_keys(
        cond.cpu().numpy(), 3, 4, 0, device=cuda)[1])
    kernels.reset_launch_counts()
    want = unrolled.call(params, cond, init, seq)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and got.shape == (3, size, size, 3)
    assert torch.equal(got, want)
    unrolled_launches = dict(kernels.LAUNCHES)
    # the CPU copy (--platforms cuda,cpu: move_to_device_pass) against the
    # in-process sampler on the CPU, both on the kernels' plain versions
    cpu_ep, cpu_meta = serving.for_platform(scan.program, scan.meta, "cpu")
    cpu_scan = serving.ExportedSampler(cpu_ep, cpu_meta)
    seeds = scan.noise(cond, gens)[0].cpu()
    cpu_got = cpu_scan.call({k: v.cpu() for k, v in params.items()},
                            cond.cpu(), seeds)
    cpu_net = copy.deepcopy(net).cpu()
    init_c, seq_c = counter_noise(seeds, T, (size, size, 3), True)
    cpu_want = make_sample_fn(cpu_eng, make_denoiser(cpu_net, fused,
                                                     torch.float32))(
        cond.cpu(), init_noise=init_c, noise_seq=seq_c)
    assert cpu_got.device.type == "cpu"
    assert (cpu_got - cpu_want).abs().max().item() <= 1e-5
    names = (("fused_gn_swish_conv3x3", "channel_stats") if fused
             else ("gn_swish",))
    for k, v in launches.items():
        per_eval = unrolled_launches[k] // T
        assert unrolled_launches[k] == T * per_eval, (k, unrolled_launches)
        assert v in (T * per_eval, (T + 1) * per_eval), (k, launches)
        assert (per_eval > 0) == (k in names), (k, launches)
