"""The port's other forms of GroupNorm -> Swish (``ops/groupnorm.py``:
``gn_swish_stats``, ``gn_swish_dot`` and ``gn_swish_custom(impl=...)``)
against the JAX package's, on the same numpy inputs. The JAX stats form
runs its Pallas channel-stats kernel in interpret mode, as the JAX
package's own tests run it.

Tolerances: float32 outputs and gradients within rtol 1e-5 (atol 1e-6:
the same float32 formulas, summed in other orders); bfloat16 outputs
within K1's bfloat16 tolerance against JAX (rtol 2^-7, atol 1e-3:
tests/test_torch_ops.py), since a last-bit difference in the float32
statistics can move a bfloat16 output to its neighbour."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fastdiffsr_tpu.ops import groupnorm as jgn
from fastdiffsr_tpu_torch.ops import groupnorm as tgn

torch.set_num_threads(2)

GROUPS = 8
TOL = {"f32": dict(rtol=1e-5, atol=1e-6), "bf16": dict(rtol=2 ** -7,
                                                        atol=1e-3)}
DT = {"f32": (torch.float32, jnp.float32),
      "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, shape=(2, 8, 6, 32)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    c = shape[-1]
    scale = (rng.standard_normal(c) * 0.1 + 1).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, scale, bias


def _jax(fn, x, scale, bias, jdt):
    with pltpu.force_tpu_interpret_mode():
        y = fn(jnp.asarray(x).astype(jdt), jnp.asarray(scale),
               jnp.asarray(bias), GROUPS, 1e-5)
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["gn_swish_stats", "gn_swish_dot"])
def test_forward_matches_jax(name, dt):
    tdt, jdt = DT[dt]
    x, scale, bias = _inputs(1)
    want = _jax(getattr(jgn, name), x, scale, bias, jdt)
    got = getattr(tgn, name)(torch.from_numpy(x).to(tdt),
                             torch.from_numpy(scale),
                             torch.from_numpy(bias), GROUPS, 1e-5)
    assert got.dtype == tdt and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dt])


@pytest.mark.parametrize("impl", ["pallas", "stats"])
def test_custom_forward_and_vjp_match_jax(impl):
    """gn_swish_custom's forward (K1 or the stats form) and its VJP (the
    reference formulation's) against JAX's gn_swish_custom of the same
    impl, float32, for a weighted-sum loss."""
    x, scale, bias = _inputs(2, (2, 6, 8, 64))
    gw = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def jloss(xx, ss, bb):
        with pltpu.force_tpu_interpret_mode():
            y = jgn.gn_swish_custom(xx, ss, bb, GROUPS, 1e-5, impl)
        return jnp.sum(y * jnp.asarray(gw)), y

    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    y = tgn.gn_swish_custom(*leaves, GROUPS, 1e-5, impl=impl)
    tg = torch.autograd.grad((y * torch.from_numpy(gw)).sum(), leaves)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               **TOL["f32"])
    for name, a, b in zip(("x", "scale", "bias"), tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()),
                                   err_msg=name)


def test_custom_refuses_an_unknown_impl():
    x, scale, bias = (torch.from_numpy(a) for a in _inputs(0))
    with pytest.raises(ValueError, match="impl"):
        tgn.gn_swish_custom(x, scale, bias, GROUPS, impl="dot")


def test_stats_form_uses_k2_on_the_cpu_plain_version():
    """On CPU tensors gn_swish_stats takes K2's plain channel sums: the
    same statistics as gn_swish_plain (K1's plain version), whose
    normalise differs only in the order of the products."""
    x, scale, bias = (torch.from_numpy(a) for a in _inputs(4))
    a = tgn.gn_swish_stats(x, scale, bias, GROUPS)
    b = tgn.gn_swish_plain(x, scale, bias, GROUPS)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
