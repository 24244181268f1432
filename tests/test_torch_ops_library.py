"""The kernels as registered operators (``fastdiffsr_tpu_torch.ops.
library``) on the CPU: each operator's fake implementation gives the
shapes and types its plain version returns (K3 with one and two
sources, with and without shift, residual and statistics; K2; K1), the
operators pass ``torch.library.opcheck``'s schema and fake-tensor
checks, they compute what the wrappers compute, and the wrappers reach
them only when traced."""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from fastdiffsr_tpu_torch.ops import (channel_stats, fused_gn_swish_conv3x3,
                                      gn_swish, kernels)
from fastdiffsr_tpu_torch.ops.groupnorm import channel_stats_plain

torch.set_num_threads(2)

K3 = torch.ops.fdsr.fused_gn_swish_conv3x3


def _k3_args(two, norm, shift, res, stats, dtype):
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    xs = [rnd(2, 8, 8, 8).to(dtype)] + ([rnd(2, 8, 8, 4).to(dtype)]
                                        if two else [])
    C = sum(x.shape[-1] for x in xs)
    return (xs, rnd(C) if norm else None, rnd(C) if norm else None,
            [channel_stats_plain(x) for x in xs] if norm else [],
            rnd(3, 3, C, 6).to(dtype), rnd(6), rnd(2, 6) if shift else None,
            rnd(2, 8, 8, 6).to(dtype) if res else None, 4, 1e-5, norm,
            stats)


K3_CASES = [dict(two=two, norm=norm, shift=shift, res=res, stats=stats,
                 dtype=dtype)
            for two, norm, shift, res, stats, dtype in (
                (False, True, False, False, True, torch.float32),
                (False, False, False, False, True, torch.float32),
                (True, True, True, True, True, torch.float32),
                (True, True, False, True, False, torch.float32),
                (False, True, True, False, False, torch.bfloat16),
                (True, True, True, True, True, torch.bfloat16))]


def _fake_like(op, args):
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fargs = torch.utils._pytree.tree_map(
            lambda a: mode.from_tensor(a) if isinstance(a, torch.Tensor)
            else a, args)
        return op(*fargs)


def _same_meta(real, fake):
    real = real if isinstance(real, list) else [real]
    fake = fake if isinstance(fake, list) else [fake]
    assert len(real) == len(fake)
    for r, f in zip(real, fake):
        assert (tuple(f.shape), f.dtype, f.device) == (tuple(r.shape),
                                                       r.dtype, r.device)


@pytest.mark.parametrize("case", K3_CASES,
                         ids=lambda c: "-".join(k for k, v in c.items()
                                                if v is True) + "-"
                         + str(c["dtype"]).split(".")[-1])
def test_k3_fake_matches_plain(case):
    args = _k3_args(**case)
    real = K3(*args)
    assert len(real) == (2 if case["stats"] else 1)
    _same_meta(real, _fake_like(K3, args))
    torch.library.opcheck(K3, args,
                          test_utils=("test_schema", "test_faketensor"))
    # the operator is the wrapper's function
    xs, sc, bi, st, w, b, shift, res, groups, eps, norm, want = args
    direct = fused_gn_swish_conv3x3(
        tuple(xs) if len(xs) > 1 else xs[0], sc, bi,
        (tuple(st) if len(st) > 1 else st[0]) if st else None, w, b,
        shift=shift, res=res, groups=groups, eps=eps, apply_norm=norm,
        want_stats=want)
    for a, d in zip(real, direct if want else (direct,)):
        assert torch.equal(a, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_k1_fake_match_plain(dtype):
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 8, 8, 16), generator=g).to(dtype)
    scale, bias = torch.randn(16, generator=g), torch.randn(16, generator=g)
    k2 = torch.ops.fdsr.channel_stats
    k1 = torch.ops.fdsr.gn_swish
    for op, args, wrapper in ((k2, (x,), channel_stats),
                              (k1, (x, scale, bias, 4, 1e-5), gn_swish)):
        real = op(*args)
        _same_meta(real, _fake_like(op, args))
        torch.library.opcheck(op, args,
                              test_utils=("test_schema", "test_faketensor"))
        assert torch.equal(real, wrapper(*args))
    assert channel_stats(x).dtype == torch.float32


def test_wrappers_take_the_operators_only_when_traced():
    from torch.utils.flop_counter import FlopCounterMode
    assert not kernels.traced()
    with FlopCounterMode(display=False):
        assert kernels.traced()
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen.append(kernels.traced())
            return channel_stats(x)

    ep = torch.export.export(Probe(), (torch.randn(1, 4, 4, 8),),
                             strict=False)
    assert seen == [True]
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets == ["fdsr.channel_stats.default"]
