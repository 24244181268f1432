"""Checkpoints users already hold, in the port: reference ``*_gen.pth``
files (the GaussianDiffusion state dict: the UNet under ``denoise_fn.``
beside the schedule buffers) for the FastDiffSR, SR3 and guided UNets,
read by the JAX package and by the port, whose forwards must agree; the
port's reference-checkpoint converter CLI; and a JAX checkpoint trained
with Lion, whose next step in the port must match optax's. Tiny UNets,
every Flax leaf randomized first (as in test_torch_unet_variants)."""

import collections
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fastdiffsr_tpu.models.convert import (strip_diffusion_prefix as
                                           jax_strip_prefix)
from fastdiffsr_tpu.models.convert import torch_guided_unet_to_flax
from fastdiffsr_tpu.models.unet_fastdiffsr import FastDiffSRUNet as FlaxFDSR
from fastdiffsr_tpu.models.unet_guided import GuidedUNet as FlaxGuided
from fastdiffsr_tpu.models.unet_sr3 import SR3UNet as FlaxSR3
from fastdiffsr_tpu.train import create_train_state as jax_state
from fastdiffsr_tpu.train.checkpoint import \
    load_reference_gen_pth as jax_load_gen_pth
from fastdiffsr_tpu.train.checkpoint import save_state as jax_save
from fastdiffsr_tpu.train.state import make_optimizer as jax_make_optimizer
from fastdiffsr_tpu_torch.cli.infer import load_params
from fastdiffsr_tpu_torch.models import convert
from fastdiffsr_tpu_torch.models.unet_fastdiffsr import FastDiffSRUNet
from fastdiffsr_tpu_torch.models.unet_guided import GuidedUNet
from fastdiffsr_tpu_torch.models.unet_sr3 import SR3UNet
from fastdiffsr_tpu_torch.train import create_train_state, make_optimizer
from fastdiffsr_tpu_torch.train.checkpoint import load_state
from tests.test_torch_unet_variants import (GUIDED_KW, SIZE, SR3_KW,
                                            randomize)

torch.set_num_threads(2)

FDSR_KW = dict(inner_channel=8, norm_groups=4, channel_mults=(1, 2),
               res_blocks=1)
FLAX = {"fastdiffsr": lambda: FlaxFDSR(**FDSR_KW),
        "ddpm": lambda: FlaxSR3(**SR3_KW),
        "gdp": lambda: FlaxGuided(**GUIDED_KW)}
PORT = {"fastdiffsr": lambda: FastDiffSRUNet(**FDSR_KW, dropout=0.0),
        "ddpm": lambda: SR3UNet(**SR3_KW),
        "gdp": lambda: GuidedUNet(**GUIDED_KW)}
LEVEL = {"fastdiffsr": np.asarray([0.93, 0.27], np.float32),
         "ddpm": np.asarray([3.0, 41.0], np.float32),
         "gdp": np.asarray([3.0, 41.0], np.float32)}
# what the reference's GaussianDiffusion registers beside its UNet
BUFFERS = ("betas", "alphas_cumprod", "alphas_cumprod_prev",
           "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
           "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
           "sqrt_recipm1_alphas_cumprod", "posterior_variance",
           "posterior_log_variance_clipped", "posterior_mean_coef1",
           "posterior_mean_coef2")


@functools.lru_cache(maxsize=None)
def _flax(variant):
    """(Flax net, randomized params as numpy) of a tiny UNet."""
    net = FLAX[variant]()
    params = jax.jit(net.init)(jax.random.PRNGKey(3),
                               jnp.zeros((1, SIZE, SIZE, 6)),
                               jnp.ones((1,)))["params"]
    return net, randomize(jax.tree_util.tree_map(np.asarray, params), 5)


def _reference_state_dict(variant):
    """A reference-format GaussianDiffusion state dict of the tiny UNet:
    the UNet's (reference-named) tensors under ``denoise_fn.`` and the
    schedule buffers."""
    _, tree = _flax(variant)
    sd = {f"denoise_fn.{k}": v
          for k, v in convert.flax_converter(variant)(tree).items()}
    betas = torch.linspace(1e-4, 2e-2, 20, dtype=torch.float64)
    for name in BUFFERS:
        sd[name] = betas.float()
    return sd


def _jax_params(variant, path):
    """The JAX package's reading of a *_gen.pth: its loader for the
    SR3-family trees, its conversion CLI's route for the guided UNet."""
    if variant == "gdp":
        sd = {k: v.numpy() for k, v in torch.load(path).items()}
        return torch_guided_unet_to_flax(jax_strip_prefix(sd))
    return jax_load_gen_pth(path)


@pytest.mark.parametrize("variant", ["fastdiffsr", "ddpm", "gdp"])
def test_reference_gen_pth_forward_matches_jax(tmp_path, variant):
    """f32 forwards of the two packages on the same *_gen.pth: atol 1e-4
    of max(1, max|y|) (GroupNorm variance formulas, attention sums)."""
    path = tmp_path / "I10_E1_gen.pth"
    torch.save(_reference_state_dict(variant), path)
    flax_net, _ = _flax(variant)
    params = _jax_params(variant, str(path))
    net = PORT[variant]().eval()
    load_params(net, str(path), variant=variant)
    x = np.random.default_rng(1).standard_normal(
        (2, SIZE, SIZE, 6)).astype(np.float32)
    lvl = LEVEL[variant]
    apply = jax.jit(functools.partial(flax_net.apply, deterministic=True))
    want = np.asarray(apply({"params": params}, jnp.asarray(x),
                            jnp.asarray(lvl)))
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(lvl)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("bad,error,match", [
    ("denoise_fn.downs.9.weight", RuntimeError, "downs.9.weight"),
    ("denoise_fn.encoder.weight", RuntimeError, "encoder.weight"),
    ("loss_scale", KeyError, "loss_scale")])
def test_reference_gen_pth_refuses_a_wrong_key(tmp_path, bad, error, match):
    """A key the UNet does not have (under the prefix, or outside it and
    not a schedule buffer) raises, naming it; the load is strict."""
    sd = _reference_state_dict("fastdiffsr")
    sd[bad] = torch.zeros(3)
    path = tmp_path / "bad_gen.pth"
    torch.save(sd, path)
    with pytest.raises(error, match=match):
        load_params(PORT["fastdiffsr"](), str(path), variant="fastdiffsr")


@pytest.mark.parametrize("route", ["load_params", "convert"])
def test_reference_gen_pth_refuses_another_arch(tmp_path, route):
    """An SR3 checkpoint read as FastDiffSR raises, naming an SR3 key:
    in the strict load, and in the conversion CLI before it writes."""
    path = str(tmp_path / "sr3_gen.pth")
    torch.save(_reference_state_dict("ddpm"), path)
    if route == "load_params":
        with pytest.raises(RuntimeError, match="time_mlp"):
            load_params(PORT["fastdiffsr"](), path, variant="fastdiffsr")
    else:
        with pytest.raises(KeyError, match="time_mlp"):
            convert.main([path, str(tmp_path / "u.pt"),
                          "--arch", "fastdiffsr"])
        assert not (tmp_path / "u.pt").exists()


@pytest.mark.parametrize("variant", ["fastdiffsr", "gdp"])
def test_convert_cli_writes_what_load_params_reads(tmp_path, variant,
                                                   capsys):
    """``python -m fastdiffsr_tpu_torch.models.convert`` strips the
    diffusion wrapper and writes a UNet state dict that loads strictly
    and equals the reference file's UNet tensors."""
    sd = _reference_state_dict(variant)
    torch.save(sd, tmp_path / "gen.pth")
    out = convert.main([str(tmp_path / "gen.pth"), str(tmp_path / "u.pt"),
                        "--arch", variant])
    assert "tensors" in capsys.readouterr().out
    written = torch.load(out, weights_only=True)
    assert set(written) == {k[len("denoise_fn."):] for k in sd
                            if k.startswith("denoise_fn.")}
    net = PORT[variant]()
    load_params(net, out, variant=variant)
    for k, v in net.state_dict().items():
        torch.testing.assert_close(v, sd[f"denoise_fn.{k}"], rtol=0, atol=0)


def test_lion_checkpoint_resumes_like_optax(tmp_path):
    """A JAX checkpoint trained with ``optimizer.type: lion`` (two optax
    steps) resumes in the port; the third step from the same gradients
    matches optax's within 5 % of lr (Lion moves every element by lr)."""
    lr = 1e-3
    _, tree = _flax("fastdiffsr")
    tx = jax_make_optimizer({"type": "lion", "lr": lr})
    state = jax_state(jax.tree_util.tree_map(jnp.asarray, tree), tx)
    rng = np.random.default_rng(9)
    grads = [jax.tree_util.tree_map(
        lambda v: rng.standard_normal(v.shape).astype(np.float32), tree)
        for _ in range(3)]
    params, opt_state = state.params, state.opt_state
    for g in grads[:2]:
        upd, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, upd)
    assert type(opt_state[0]).__name__ == "ScaleByLionState"
    ckpt = jax_save(state.replace(params=params, opt_state=opt_state,
                                  ema_params=params,
                                  step=jnp.asarray(2, jnp.int32)),
                    str(tmp_path / "jck"), epoch=1)
    upd, _ = tx.update(grads[2], opt_state, params)
    want = convert.flax_params_to_torch(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, upd)))

    net = PORT["fastdiffsr"]()
    st = load_state(ckpt, create_train_state(net, make_optimizer(
        net.parameters(), {"type": "lion", "lr": lr})), "fastdiffsr")
    assert st.step == 2 and st.epoch == 1
    g3 = convert.flax_params_to_torch(grads[2])
    for k, p in net.named_parameters():
        p.grad = g3[k]
    st.optimizer.step()
    for k, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=0, atol=0.05 * lr, err_msg=k)


def test_optax_state_to_torch_takes_lion_and_refuses_the_rest():
    """Lion's ``mu`` becomes ``exp_avg``; an optax state it does not know
    raises, naming it; the variant has no default."""
    _, tree = _flax("fastdiffsr")
    names = list(convert.flax_params_to_torch(tree))
    lion = optax.lion(1e-4).init(tree)
    out = convert.optax_state_to_torch(lion, names, "fastdiffsr")
    assert set(out[0]) == {"exp_avg"} and len(out) == len(names)
    Belief = collections.namedtuple("ScaleByBeliefState", "count mu nu")
    with pytest.raises(NotImplementedError, match="ScaleByBeliefState"):
        convert.optax_state_to_torch((Belief(0, tree, tree),), names,
                                     "fastdiffsr")
    with pytest.raises(TypeError, match="variant"):
        convert.optax_state_to_torch(lion, names)
