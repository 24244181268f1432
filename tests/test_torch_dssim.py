"""The port's differentiable SSIM (``ops/dssim.py``) and the training
loss's SSIM term (``diffusion/engine.py``) against the JAX package:
``ssim`` mean and per image, its gradient through a clamp, the term's
decomposition, and ``training_loss`` with the term on the tiny FastDiffSR
UNet (inner 8, groups 4, mults (1, 2), 16x16) with the JAX draws
injected. Inputs and weights from numpy seeds."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdiffsr_tpu.diffusion import DiffusionEngine as JaxEngine
from fastdiffsr_tpu.diffusion import DiffusionSpec as JaxSpec
from fastdiffsr_tpu.diffusion import ScheduleBuffers as JaxBuffers
from fastdiffsr_tpu.models.unet_fastdiffsr import FastDiffSRUNet as FlaxUNet
from fastdiffsr_tpu.ops.dssim import ssim as jax_ssim
from fastdiffsr_tpu_torch import metrics
from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine, DiffusionSpec,
                                            ScheduleBuffers)
from fastdiffsr_tpu_torch.diffusion.engine import img2res, res2img
from fastdiffsr_tpu_torch.models.convert import flax_params_to_torch
from fastdiffsr_tpu_torch.models.unet_fastdiffsr import FastDiffSRUNet
from fastdiffsr_tpu_torch.ops.dssim import _gaussian_window, ssim

torch.set_num_threads(2)

SCHED = {"schedule": "linear_cosine", "n_timestep": 20,
         "linear_start": 1e-6, "linear_end": 1e-2}
KW = dict(inner_channel=8, norm_groups=4, channel_mults=(1, 2),
          res_blocks=1)
SIZE = 16


def _pair(seed, shape, spread=25):
    """(a, b) float32 on 0..255, b a noisy copy of a."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 255, shape).astype(np.float32)
    b = np.clip(a + rng.uniform(-spread, spread, shape), 0,
                255).astype(np.float32)
    return a, b


def test_window_matches_jax():
    from fastdiffsr_tpu.ops.dssim import _gaussian_window as jax_window
    w = _gaussian_window()
    assert w.dtype == np.float32 and w.shape == (11,)
    np.testing.assert_array_equal(w, jax_window())


def test_window_is_copied_once_and_serves_autograd_after_inference():
    """One window tensor per device (a copy per call would stall the
    training step on the card), usable by autograd even when the first
    call ran in inference mode."""
    from fastdiffsr_tpu_torch.ops.dssim import _window_on
    a, b = (torch.from_numpy(x) for x in _pair(5, (1, 16, 16, 3)))
    with torch.inference_mode():
        ssim(a, b)
    assert _window_on(a.device) is _window_on(torch.device("cpu"))
    x = a.clone().requires_grad_()
    ssim(x, b).backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


@pytest.mark.parametrize("per_image", [False, True])
@pytest.mark.parametrize("shape", [(1, 48, 48, 3), (3, 48, 40, 3),
                                   (2, 11, 13, 1)])
def test_ssim_matches_jax(shape, per_image):
    """Mean and per-image SSIM against JAX's: |d| <= 1e-5 (an 11x13 map
    leaves a 1x3 window of statistics)."""
    a, b = _pair(1, shape)
    got = ssim(torch.from_numpy(a), torch.from_numpy(b), per_image=per_image)
    want = np.asarray(jax_ssim(jnp.asarray(a), jnp.asarray(b),
                               per_image=per_image))
    assert got.dtype == torch.float32
    assert got.shape == ((shape[0],) if per_image else ())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_ssim_matches_eval_metric():
    """On uint8 images: the port's metrics SSIM (MATLAB-style,
    channel-mean) within 2e-4 (as tests/test_dssim.py holds JAX's), 1 on
    identical images, and bfloat16 inputs computed in float32."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 255, (48, 48, 3)).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-25, 25, a.shape), 0,
                255).astype(np.uint8)
    ta, tb = (torch.from_numpy(x.astype(np.float32))[None] for x in (a, b))
    np.testing.assert_allclose(ssim(ta, tb).item(),
                               metrics.calculate_ssim(a, b), atol=2e-4)
    np.testing.assert_allclose(ssim(ta, ta).item(), 1.0, atol=1e-5)
    # integers up to 256 are exact in bfloat16
    np.testing.assert_array_equal(
        ssim(ta.bfloat16(), tb.bfloat16()).numpy(), ssim(ta, tb).numpy())


@pytest.mark.parametrize("per_image", [False, True])
def test_ssim_grad_through_clamp_matches_jax(per_image):
    """d/dx of sum(ssim((clip(x) + 1) * 127.5, hr)) against jax.grad, on
    x with a third of its elements outside [-1, 1] (their gradient is 0
    on both sides): max|d| <= 1e-4 * max|g|."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.5, 1.5, (2, 24, 24, 3)).astype(np.float32)
    hr = np.clip(x + rng.normal(0, 0.2, x.shape), -1, 1).astype(np.float32)
    assert 0.2 < (np.abs(x) > 1).mean() < 0.5

    def jf(v):
        return jnp.sum(jax_ssim((jnp.clip(v, -1.0, 1.0) + 1.0) * 127.5,
                                (jnp.asarray(hr) + 1.0) * 127.5,
                                per_image=per_image))

    want = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    ssim((torch.clamp(xt, -1.0, 1.0) + 1.0) * 127.5,
         (torch.from_numpy(hr) + 1.0) * 127.5,
         per_image=per_image).sum().backward()
    got = xt.grad.numpy()
    assert np.all(got[np.abs(x) > 1] == 0)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _engine(variant="fastdiffsr", **aux):
    return DiffusionEngine(DiffusionSpec.for_variant(variant),
                           ScheduleBuffers.create(SCHED, device="cpu"), **aux)


@pytest.mark.parametrize("variant", ["ddpm", "gdp"])
def test_aux_term_refused_off_noise_continuous_gamma(variant):
    """ddpm (discrete t) and gdp (x0 prediction) cannot decode x0_hat from
    the training draw; both packages refuse the knob."""
    with pytest.raises(NotImplementedError, match="aux_ssim_weight"):
        _engine(variant, aux_ssim_weight=0.1)
    with pytest.raises(NotImplementedError, match="aux_ssim_weight"):
        JaxEngine(JaxSpec.for_variant(variant), JaxBuffers.create(SCHED),
                  aux_ssim_weight=0.1)
    # a weight of 0 is the reference's loss, for every variant
    assert _engine(variant, aux_ssim_weight=0.0).aux_ssim_weight == 0.0


@pytest.mark.parametrize("variant", ["fastdiffsr", "tesr"])
@pytest.mark.parametrize("pow_", [0.0, 2.0])
def test_aux_decomposition(variant, pow_):
    """loss(w) - loss(0) == w * mean(gamma^p * (1 - SSIM_i)) on the same
    injected draw, the SSIM of the clamped, decoded x0_hat recomputed
    here by hand (relative 1e-6); gamma 0.02 makes x0_hat overflow the
    clamp."""
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.uniform(-1, 1, (3, 24, 24, 3))
                                 .astype(np.float32)) for k in ("HR", "SR")}
    noise = torch.from_numpy(rng.standard_normal((3, 24, 24, 3))
                             .astype(np.float32))
    gamma = torch.tensor([0.97, 0.6, 0.02])
    w = 0.37

    def denoise(x_in, level):
        return 0.1 * x_in[..., 3:]

    l0 = _engine(variant).training_loss(denoise, batch, None, noise=noise,
                                        gamma=gamma)
    eng = _engine(variant, aux_ssim_weight=w, aux_ssim_gamma_pow=pow_)
    l1 = eng.training_loss(denoise, batch, None, noise=noise, gamma=gamma)

    x_start = (img2res(batch["HR"], batch["SR"]) if variant == "fastdiffsr"
               else batch["HR"])
    x_noisy = eng.q_sample(x_start, gamma, noise)
    g = gamma.reshape(-1, 1, 1, 1)
    x0_hat = torch.clamp(
        (x_noisy - torch.sqrt(1 - g ** 2) * denoise(
            torch.cat([batch["SR"], x_noisy], -1), gamma)) / g, -1, 1)
    assert (x0_hat.abs() == 1).any()
    sr_hat = (res2img(x0_hat, batch["SR"], clip=False)
              if variant == "fastdiffsr" else x0_hat)
    s_i = ssim((sr_hat + 1) * 127.5, (batch["HR"] + 1) * 127.5,
               per_image=True)
    w_i = gamma ** pow_ if pow_ else torch.ones(3)
    want = w * (w_i * (1 - s_i)).mean().item()
    assert want > 0
    np.testing.assert_allclose((l1 - l0).item(), want, rtol=1e-6)


FLAX_NET = FlaxUNet(**KW, dropout=0.0)


@functools.lru_cache(maxsize=None)
def _flax_tree(seed=1):
    """The Flax UNet's parameter tree (shapes from ``jax.eval_shape`` of
    its init, which compiles nothing), filled from a numpy seed: kernels
    N(0, 1/fan_in), GroupNorm scales 1 + 0.1 N, biases 0.1 N."""
    shapes = jax.eval_shape(
        FLAX_NET.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, SIZE, SIZE, 6), jnp.float32),
        jax.ShapeDtypeStruct((1,), jnp.float32))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        z = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return z / np.sqrt(np.prod(s.shape[:-1]))
        return 1.0 + 0.1 * z if name == "scale" else 0.1 * z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


# (variant, aux weight, gamma pow): the two demo configs' settings
# (demo_ucm_native_8_64_s8hg.json, _s8hs.json) and tesr's hr-space decode
LOSS_CASES = {"s8hg": ("fastdiffsr", 0.2, 2.0),
              "s8hs": ("fastdiffsr", 0.05, 0.0),
              "tesr": ("tesr", 0.2, 2.0)}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_training_loss_with_aux_matches_jax(case, monkeypatch):
    """training_loss with the SSIM term on the tiny UNet against JAX's,
    the same weights, noise and gamma (JAX's draws patched; one gamma
    small enough to hit the clamp), dropout 0: the loss within relative
    1e-5, each gradient leaf within 1e-4 of its max |g|."""
    variant, w, pow_ = LOSS_CASES[case]
    tree = _flax_tree()
    rng = np.random.default_rng(4)
    batch = {k: rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
             for k in ("HR", "SR")}
    noise = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    gamma = np.asarray([0.93, 0.03], np.float32)
    jeng = JaxEngine(JaxSpec.for_variant(variant), JaxBuffers.create(SCHED),
                     aux_ssim_weight=w, aux_ssim_gamma_pow=pow_)
    jeng.sample_gammas = lambda key, b: (jnp.asarray(gamma), None)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(noise))

    def jloss(params):
        return jeng.training_loss(
            lambda x, lvl: FLAX_NET.apply({"params": params}, x, lvl,
                                          deterministic=True),
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    monkeypatch.undo()

    net = FastDiffSRUNet(**KW, dropout=0.0)
    net.load_state_dict(flax_params_to_torch(tree), strict=True)
    net.train()
    eng = _engine(variant, aux_ssim_weight=w, aux_ssim_gamma_pow=pow_)
    loss = eng.training_loss(
        lambda x, lvl: net(x, lvl),
        {k: torch.from_numpy(v) for k, v in batch.items()}, None,
        noise=torch.from_numpy(noise), gamma=torch.from_numpy(gamma))
    loss.backward()
    l1 = _engine(variant).training_loss(
        lambda x, lvl: net(x, lvl),
        {k: torch.from_numpy(v) for k, v in batch.items()}, None,
        noise=torch.from_numpy(noise), gamma=torch.from_numpy(gamma))
    assert loss.item() > l1.item()          # the term is on
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = flax_params_to_torch(jax.tree_util.tree_map(np.asarray,
                                                       want_grads))
    for name, p in net.named_parameters():
        wg = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), wg, rtol=0,
                                   atol=1e-4 * np.abs(wg).max() + 1e-12,
                                   err_msg=name)
