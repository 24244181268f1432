"""The port's profiling utilities (``fastdiffsr_tpu_torch.utils.
profiling``) on the CPU: ``param_count`` against the JAX package's on the
same tiny UNet (inner 8, mults (1, 2), 16x16), ``flops_estimate`` of the
fused forward (K3 counted by its registered flop formula) against the
plain forward's and against a count written out from the architecture,
``trace`` writing its file, ``Throughput``'s rates."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdiffsr_tpu.models.unet_fastdiffsr import FastDiffSRUNet as FlaxUNet
from fastdiffsr_tpu.utils.profiling import param_count as jax_param_count
from fastdiffsr_tpu_torch.models.unet_fastdiffsr import (FastDiffSRUNet,
                                                         ResnetBlocWithAttn,
                                                         Upsample)
from fastdiffsr_tpu_torch.models.unet_fastdiffsr_fused import (
    fused_apply, prepare_fused_params)
from fastdiffsr_tpu_torch.utils.profiling import (Throughput, flops_estimate,
                                                  param_count, trace)

torch.set_num_threads(2)

KW = dict(inner_channel=8, norm_groups=4, channel_mults=(1, 2),
          res_blocks=1, dropout=0.0)
B, R = 2, 16


def conv_flops(conv, out_hw):
    return (2 * B * out_hw * conv.out_channels * conv.in_channels
            * conv.kernel_size[0] * conv.kernel_size[1])


def linear_flops(lin, rows=B):
    return 2 * rows * lin.in_features * lin.out_features


def resblock_flops(layer, r):
    """A ResnetBlocWithAttn at an r x r map: its two 3x3 convs, the noise
    Linear, a 1x1 skip conv, and CLAM's two 1x1 convs on the avg- and
    max-pooled vectors and SLAM's 7x7 conv."""
    rb = layer.res_block
    n = (conv_flops(rb.block1.block[3], r * r)
         + conv_flops(rb.block2.block[3], r * r)
         + linear_flops(rb.noise_func.noise_func[0]))
    if isinstance(rb.res_conv, torch.nn.Conv2d):
        n += conv_flops(rb.res_conv, r * r)
    if layer.with_attn:
        n += 2 * (conv_flops(layer.ca.fc1, 1) + conv_flops(layer.ca.fc2, 1))
        n += conv_flops(layer.sa.conv1, r * r)
    return n


def analytic_flops(net):
    """Multiply-adds x 2 of every convolution and matrix product of one
    forward at batch B, R x R."""
    mlp = net.noise_level_mlp
    n = linear_flops(mlp[1]) + linear_flops(mlp[3])
    r = R
    n += conv_flops(net.downs[0], r * r)
    for layer in net.downs[1:]:
        if isinstance(layer, ResnetBlocWithAttn):
            n += resblock_flops(layer, r)
        else:                                    # stride-2 Downsample
            r //= 2
            n += conv_flops(layer.conv, r * r)
    n += sum(resblock_flops(layer, r) for layer in net.mid)
    for layer in net.ups:
        if isinstance(layer, Upsample):
            r *= 2
            n += conv_flops(layer.conv, r * r)
        else:
            n += resblock_flops(layer, r)
    return n + conv_flops(net.final_conv.block[3], r * r)


@pytest.fixture(scope="module")
def net():
    gen = torch.Generator().manual_seed(0)
    net = FastDiffSRUNet(**KW).eval()
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return net


def test_param_count_matches_jax(net):
    # the count needs the tree's shapes only: no init program compiled
    flax_net = FlaxUNet(**KW)
    params = jax.eval_shape(flax_net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, R, R, 6)),
                            jnp.ones((1,)))["params"]
    want = jax_param_count(params)
    assert param_count(net) == want
    assert param_count(net.state_dict()) == want
    assert param_count(list(net.parameters())) == want


def test_flops_fused_equals_plain_and_analytic(net):
    x = torch.randn((B, R, R, 6), generator=torch.Generator().manual_seed(1))
    level = torch.tensor([0.3, 0.8])
    fp = prepare_fused_params(net, torch.float32)
    fused = flops_estimate(fused_apply, fp, x, level)
    plain = flops_estimate(net, x, level)
    want = analytic_flops(net)
    assert fused["flops"] == plain["flops"] == want
    assert np.isnan(fused["bytes_accessed"])


def test_k3_flop_formula_counts_two_sources():
    """K3 through its operator: 2*B*H*W*9*C*Co over the concat's C."""
    from fastdiffsr_tpu_torch.ops import channel_stats, fused_gn_swish_conv3x3
    g = torch.Generator().manual_seed(2)
    x1 = torch.randn((1, 8, 8, 8), generator=g)
    x2 = torch.randn((1, 8, 8, 4), generator=g)
    w = torch.randn((3, 3, 12, 6), generator=g)
    args = ((x1, x2), torch.ones(12), torch.zeros(12),
            (channel_stats(x1), channel_stats(x2)), w, torch.zeros(6))
    got = flops_estimate(lambda: fused_gn_swish_conv3x3(*args, groups=4))
    assert got["flops"] == 2 * 8 * 8 * 9 * 12 * 6


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)):
        torch.ones(4).add_(1.0)
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())


def test_throughput_rates():
    tp = Throughput()
    for _ in range(3):
        tp.update(4)
    rates = tp.rates()
    assert tp.steps == 3 and tp.images == 12
    assert rates["steps_per_sec"] > 0
    np.testing.assert_allclose(rates["images_per_sec"],
                               4 * rates["steps_per_sec"], rtol=1e-12)
