"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: they skip where no CUDA device is visible. This
file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from fastdiffsr_tpu_torch.ops import kernels
from fastdiffsr_tpu_torch.ops.fused_conv import (
    fused_gn_swish_conv3x3, fused_gn_swish_conv3x3_plain)
from fastdiffsr_tpu_torch.ops.groupnorm import (
    channel_stats, channel_stats_plain, gn_swish, gn_swish_custom,
    gn_swish_plain)

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
}


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_conv_kernel_matches_plain(cuda, case, dt):
    """f32: atol 1e-3 (summation order); bf16: two bf16 steps of |y|
    (a sum that differs in its last float32 bits rounds to the
    neighbouring bf16 value). Statistics: 1e-4 of the sum of squares'
    scale."""
    Cs, Co, G, norm, want_stats, with_shift, with_res, H, W = CASES[case]
    B, C = 2, sum(Cs)
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
    got = fused_gn_swish_conv3x3(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_gn_swish_conv3x3"] == before + 1
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
@pytest.mark.parametrize("shape", [(2, 128, 128, 64), (3, 7, 9, 40)])
def test_channel_stats_kernel_matches_plain(cuda, shape, dt):
    """float32 sums in another order: rtol 1e-5 of the sum of squares."""
    x = torch.randn(shape, device=cuda).to(dt)
    before = kernels.LAUNCHES["channel_stats"]
    got = channel_stats(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["channel_stats"] == before + 1
    want = channel_stats_plain(x)
    scale = want[:, 1].abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [((2, 32, 32, 64), 32),
                                          ((2, 16, 16, 192), 32),
                                          ((3, 6, 6, 24), 4),
                                          ((2, 9, 7, 6), 3)])
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
