"""One training step of the port's MSI trainers against the JAX
package's, from the same (randomised) weights and batch: the shared
``SupervisedSRTrainer`` (SwinIR with drop-path off; HSENet with the
opt-in VGG content term on a seeded pack) here, NDSRGAN's
``GANTrainer`` in ``test_torch_msi_gan.py``. Losses within 1e-5
relative, gradient norms within 1e-4 relative, and every parameter after
one Adam step within 1e-3 · lr of JAX's, except where JAX's gradient is
below 1e-6 of its largest (there Adam's first step, lr · g / (|g| + eps),
turns on the float32 rounding of g, and a gradient that is zero in exact
arithmetic, as that of the non-local blocks' phi bias, may move its
parameter either way; those stay within 2 · lr)."""

import types

import jax
import numpy as np
import pytest
import torch

from fastdiffsr_tpu.msi import trainer as jtrainer
from fastdiffsr_tpu.msi.hsenet import HSENet as JaxHSENet
from fastdiffsr_tpu.msi.swinir import SwinIR as JaxSwinIR
from fastdiffsr_tpu_torch.models.convert import flax_converter
from fastdiffsr_tpu_torch.msi.hsenet import HSENet
from fastdiffsr_tpu_torch.msi.swinir import SwinIR
from fastdiffsr_tpu_torch.msi.trainer import SupervisedSRTrainer, charbonnier
from tests.test_torch_msi_convnets import _vgg_pack
from tests.test_torch_msi_models import randomize_tree

torch.set_num_threads(2)

LR_RATE = 1e-3


def test_charbonnier_matches_numpy():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 3, 5, 3)), rng.standard_normal((2, 3, 5,
                                                                    3))
    want = np.mean(np.sqrt((a - b) ** 2 + 1e-12))
    got = charbonnier(torch.from_numpy(a), torch.from_numpy(b)).item()
    assert abs(got - want) <= 1e-12 * want
    # eps keeps the loss of identical images at eps, not 0
    assert charbonnier(torch.zeros(4), torch.zeros(4)).item() == \
        pytest.approx(1e-6)


def _grad_norm(tree):
    return float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                             for g in jax.tree_util.tree_leaves(tree))))


def _check_update(net, before, after_jax, grads_jax, arch):
    """Parameters after one Adam step against JAX's (module docstring)."""
    convert = flax_converter(arch)
    want = convert(after_jax)
    g = convert(grads_jax)
    gmax = max(v.abs().max().item() for v in g.values())
    for k, v in net.state_dict().items():
        d = (v - want[k]).abs()
        steep = g[k].abs() >= 1e-6 * gmax
        assert (d[steep] <= 1e-3 * LR_RATE).all(), k
        assert d.max().item() <= 2 * LR_RATE, k
        assert (v != before[k])[steep].all(), k


def _batch(seed, scale):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32),
            rng.uniform(0, 1, (2, 8 * scale, 8 * scale, 3)).astype(
                np.float32))


@pytest.mark.parametrize("arch", ["swinir", "hsenet"])
def test_supervised_step_matches_jax(arch, tmp_path, monkeypatch):
    args = types.SimpleNamespace(scale_factor=2, crop_size=16, lr=LR_RATE,
                                 b1=0.9, b2=0.999, log_freq=2,
                                 save_dir=str(tmp_path))
    if arch == "swinir":
        kw = dict(upscale=2, embed_dim=24, depths=(2, 2), num_heads=(3, 3),
                  window_size=4, mlp_ratio=2.0, drop_path_rate=0.0)
        jnet, net = JaxSwinIR(**kw), SwinIR(**kw)
    else:
        pack = tmp_path / "vgg.npz"
        np.savez(pack, **_vgg_pack(1, False))
        monkeypatch.setenv("FASTDIFFSR_TPU_VGG", str(pack))
        args.vgg_loss_weight = 0.05
        jnet, net = (JaxHSENet(scale=2, n_feats=8, n_basic_modules=1),
                     HSENet(scale=2, n_feats=8, n_basic_modules=1))
    jtr = jtrainer.SupervisedSRTrainer(jnet, args)
    params = randomize_tree(jtr.state.params, 11)
    state = jtr.state.replace(params=params, opt_state=jtr.tx.init(params))
    lr, hr = _batch(12, 2)
    key = jax.random.PRNGKey(3)

    vgg = None
    if arch == "hsenet":
        from fastdiffsr_tpu.models.vgg_feat import load_default
        vgg = load_default(feature_layer=11, use_input_norm=False)

    def loss_fn(p):
        """The JAX trainer's loss, for its gradients."""
        out = jnet.apply({"params": p}, lr, deterministic=False,
                         rngs={"dropout": key})
        loss = jtrainer.charbonnier(out, hr)
        if vgg is not None:
            loss = loss + args.vgg_loss_weight * jtrainer.charbonnier(
                vgg._forward(vgg.params, out), vgg._forward(vgg.params, hr))
        return loss
    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    new_state, step_loss = jax.jit(jtr._step_fn)(state, lr, hr, key)
    assert float(step_loss) == pytest.approx(float(want_loss), rel=1e-6)

    tr = SupervisedSRTrainer(net, args, device="cpu")
    tr.net.load_state_dict(flax_converter(arch)(params))
    before = {k: v.clone() for k, v in tr.net.state_dict().items()}
    loss = tr.train_step(torch.from_numpy(lr), torch.from_numpy(hr))
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    gnorm = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                 for p in tr.net.parameters())))
    assert gnorm == pytest.approx(_grad_norm(grads), rel=1e-4)
    assert tr.state.step == 1
    _check_update(tr.net, before, new_state.params, grads, arch)
