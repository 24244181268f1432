"""One step of NDSRGAN's ``GANTrainer`` in the port against the JAX
package's, from the same (randomised) weights and batch: D's LSGAN step,
then G's (L1 + 1e-3 adversarial) against the updated D. Tolerances as in
``test_torch_msi_train.py``."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiffsr_tpu.msi.ndsrgan import GANTrainer as JaxGANTrainer
from fastdiffsr_tpu_torch.models.convert import flax_converter
from fastdiffsr_tpu_torch.msi.ndsrgan import GANTrainer
from tests.test_torch_msi_models import randomize_tree
from tests.test_torch_msi_train import LR_RATE, _check_update

torch.set_num_threads(2)


def test_gan_step_matches_jax():
    """GANTrainer at nf 8, nc 4, one DCRDB, crop 32, x2: the D and G
    losses of one step and both nets after their Adam steps."""
    args = types.SimpleNamespace(scale_factor=2, crop_size=32, lr=LR_RATE,
                                 weight_gan=1e-3, g_nf=8, g_nc=4, g_blocks=1)
    jgt = JaxGANTrainer(args)
    gp = randomize_tree(jgt.g_state.params, 21)
    dp = randomize_tree(jgt.d_state.params, 22)
    g_state = jgt.g_state.replace(params=gp, opt_state=jgt.tx_g.init(gp))
    d_state = jgt.d_state.replace(params=dp, opt_state=jgt.tx_d.init(dp))
    lr = np.random.default_rng(23).uniform(0, 1, (2, 16, 16, 3)).astype(
        np.float32)
    hr = np.random.default_rng(24).uniform(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    g_new, d_new, m = jax.jit(jgt._steps_fn)(g_state, d_state, lr, hr)

    gt = GANTrainer(args, device="cpu")
    gt.g.load_state_dict(flax_converter("ndsrgan")(gp))
    gt.d.load_state_dict(flax_converter("ndsrgan_discriminator")(dp))
    g0 = {k: v.clone() for k, v in gt.g.state_dict().items()}
    d0 = {k: v.clone() for k, v in gt.d.state_dict().items()}
    got = gt.step(torch.from_numpy(lr), torch.from_numpy(hr))
    for k in ("g", "d", "pixel", "adv"):
        assert got[k].item() == pytest.approx(float(m[k]), rel=1e-5), k

    # the gradients JAX took, for the update tolerance's flat elements
    def d_loss(p, fake):
        return (jnp.mean((jgt.d.apply({"params": p}, hr) - 1.0) ** 2)
                + jnp.mean(jgt.d.apply({"params": p}, fake) ** 2))

    def g_loss(p, d_params):
        fake = jgt.g.apply({"params": p}, lr)
        return jnp.mean(jnp.abs(fake - hr)) + 1e-3 * jnp.mean(
            (jgt.d.apply({"params": d_params}, fake) - 1.0) ** 2)
    d_grads = jax.jit(jax.grad(d_loss))(dp, jgt.g.apply({"params": gp}, lr))
    g_grads = jax.jit(jax.grad(g_loss))(gp, d_new.params)
    _check_update(gt.d, d0, d_new.params, d_grads, "ndsrgan_discriminator")
    _check_update(gt.g, g0, g_new.params, g_grads, "ndsrgan")


def test_gan_trainer_trains_on_a_folder(tmp_path):
    """``GANTrainer.train`` on HR PNGs (crop 32: the patch critic's
    strides leave a 1x1 logit map) runs its steps with finite losses and
    a steady rate."""
    from fastdiffsr_tpu_torch.metrics import save_img

    rng = np.random.default_rng(0)
    for i in range(4):
        save_img(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
                 str(tmp_path / f"{i}.png"))
    args = types.SimpleNamespace(scale_factor=2, crop_size=32, lr=1e-4,
                                 weight_gan=1e-3, g_nf=8, g_nc=4, g_blocks=1)
    gt = GANTrainer(args, device="cpu")
    m = gt.train([str(tmp_path)], num_epochs=2, batch_size=2, max_steps=3)
    assert gt.step_count == 3 and m["steps_per_s"] > 0
    assert all(np.isfinite(m[k]) for k in ("g", "d", "pixel", "adv"))
