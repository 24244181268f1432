"""The port's training slice against the JAX package: K1's plain version
and gradient, the UNet on K1 and on the plain GroupNorm, the training
loss and its
gradients, the optimizers, the EMA, the cached train step and the
checkpoints. Tiny sizes (inner 8, groups 4, mults (1, 2), 1 res block,
16x16, as tests/test_e2e_cli.py); inputs from numpy seeds, weights from
the Flax init through ``flax_params_to_torch``."""

import copy
import functools
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.experimental.pallas import tpu as pltpu

from fastdiffsr_tpu.diffusion import DiffusionEngine as JaxEngine
from fastdiffsr_tpu.diffusion import DiffusionSpec as JaxSpec
from fastdiffsr_tpu.diffusion import ScheduleBuffers as JaxBuffers
from fastdiffsr_tpu.models.unet_fastdiffsr import FastDiffSRUNet as FlaxUNet
from fastdiffsr_tpu.ops.groupnorm import (
    _gn_swish_pallas, _gn_swish_reference as jax_gn_swish_reference,
    gn_swish_custom as jax_gn_swish_custom)
from fastdiffsr_tpu.train import create_train_state as jax_create_state
from fastdiffsr_tpu.train.checkpoint import save_state as jax_save_state
from fastdiffsr_tpu.train.state import make_optimizer as jax_make_optimizer
from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine, DiffusionSpec,
                                            ScheduleBuffers)
from fastdiffsr_tpu_torch.models.convert import flax_params_to_torch
from fastdiffsr_tpu_torch.models import unet_fastdiffsr
from fastdiffsr_tpu_torch.models.unet_fastdiffsr import (Block,
                                                         FastDiffSRUNet,
                                                         init_params)
from fastdiffsr_tpu_torch.ops import kernels
from fastdiffsr_tpu_torch.ops.groupnorm import (gn_swish, gn_swish_custom,
                                                gn_swish_plain,
                                                gn_swish_reference)
from fastdiffsr_tpu_torch.train import (create_train_state,
                                        make_cached_train_step,
                                        make_optimizer, make_train_step,
                                        step_generator)
from fastdiffsr_tpu_torch.train.checkpoint import (load_params_only,
                                                   load_state, save_state)
from tests.conftest import REPO_ROOT

torch.set_num_threads(2)

KW = dict(inner_channel=8, norm_groups=4, channel_mults=(1, 2),
          res_blocks=1)
SCHED = {"schedule": "linear_cosine", "n_timestep": 20,
         "linear_start": 1e-6, "linear_end": 1e-2}
SIZE = 16


FLAX_NET = FlaxUNet(**KW, dropout=0.0)


@functools.lru_cache(maxsize=None)
def _jit_init():
    return jax.jit(FLAX_NET.init)


@functools.lru_cache(maxsize=None)
def _flax_tree(seed=0):
    """(Flax UNet, its seeded params as numpy); callers copy, never
    mutate."""
    params = _jit_init()(jax.random.PRNGKey(seed),
                         jnp.zeros((1, SIZE, SIZE, 6)), jnp.ones((1,)))
    return FLAX_NET, jax.tree_util.tree_map(np.asarray, params["params"])


def _torch_net(tree, dropout=0.0):
    net = FastDiffSRUNet(**KW, dropout=dropout)
    net.load_state_dict(flax_params_to_torch(tree), strict=True)
    return net


def _batch_np(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)
            for k in ("HR", "SR")}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _small_net(seed=0, dropout=0.0):
    return init_params(FastDiffSRUNet(**KW, dropout=dropout), seed)


def _use_reference_norm(monkeypatch):
    """Every Block runs gn_swish_reference (plain PyTorch, autograd)
    instead of K1's gn_swish_custom."""
    monkeypatch.setattr(unet_fastdiffsr, "gn_swish_custom",
                        gn_swish_reference)


def _engine(variant="fastdiffsr"):
    return DiffusionEngine(DiffusionSpec.for_variant(variant),
                           ScheduleBuffers.create(SCHED, device="cpu"))


# ---------------------------------------------------------------- K1 --

GN_CASES = {"8x8_c16_g4": ((2, 8, 8, 16), 4),
            "6x6_c24_g4": ((2, 6, 6, 24), 4),   # H*W not a multiple of 8
            "4x4_c192_g32": ((1, 4, 4, 192), 32),   # groups of 6
            "4x4_c512_g32": ((1, 4, 4, 512), 32)}   # groups of 16


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(GN_CASES))
def test_gn_swish_plain_matches_jax_pallas_and_reference(case, dt):
    """K1's plain version against ``_gn_swish_pallas`` in interpret mode
    and against ``_gn_swish_reference``. f32: atol 1e-5 (the same math,
    sums in another order); bf16: one bf16 step, 2^-7 |y| + 1e-5 (a
    float32 value a few steps off can round to the other neighbour)."""
    shape, groups = GN_CASES[case]
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    s = (rng.standard_normal(shape[-1]) * 0.1 + 1).astype(np.float32)
    b = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    tdt, jdt = ((torch.float32, jnp.float32) if dt == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    tx = torch.from_numpy(x).to(tdt)
    before = dict(kernels.LAUNCHES)
    got = gn_swish_plain(tx, torch.from_numpy(s), torch.from_numpy(b), groups)
    assert torch.equal(gn_swish(tx, torch.from_numpy(s), torch.from_numpy(b),
                                groups), got)
    assert kernels.LAUNCHES == before      # CPU tensors: plain version only
    assert got.dtype == tdt and got.shape == shape
    jx = jnp.asarray(x, jdt)
    with pltpu.force_tpu_interpret_mode():
        want_pallas = _gn_swish_pallas(jx, jnp.asarray(s), jnp.asarray(b),
                                       groups, 1e-5)
    want_ref = jax_gn_swish_reference(jx, jnp.asarray(s), jnp.asarray(b),
                                      groups, 1e-5)
    y = got.float().numpy()
    for want in (want_pallas, want_ref):
        w = np.asarray(want, np.float32)
        if dt == "f32":
            np.testing.assert_allclose(y, w, rtol=0, atol=1e-5)
        else:
            assert (np.abs(y - w) <= np.abs(w) * 2 ** -7 + 1e-5).all()


@pytest.mark.parametrize("case", sorted(GN_CASES))
def test_gn_swish_custom_grad_matches_jax(case):
    """Gradients of sum(y * cotangent) for x, scale and bias against the
    JAX ``gn_swish_custom(..., 'pallas')`` in interpret mode: atol 1e-4."""
    shape, groups = GN_CASES[case]
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (rng.standard_normal(shape[-1]) * 0.1 + 1).astype(np.float32)
    b = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    cot = rng.standard_normal(shape).astype(np.float32)

    def jloss(x, s, b):
        with pltpu.force_tpu_interpret_mode():
            y = jax_gn_swish_custom(x, s, b, groups, 1e-5, "pallas")
        return jnp.sum(y * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(s),
                                              jnp.asarray(b))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, s, b)]
    (gn_swish_custom(*leaves, groups) * torch.from_numpy(cot)).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)


def test_gn_swish_raises_off_cpu_and_cuda():
    x = torch.empty((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gn_swish(x, torch.ones(8), torch.zeros(8), 4)


# -------------------------------------------------------------- UNet --

def test_unet_pallas_norm_matches_plain_norm(monkeypatch):
    """The UNet's Blocks on K1 (gn_swish_custom; its plain version on the
    CPU) against the same UNet on gn_swish_reference: the same state-dict
    keys as the converted Flax tree, outputs within 1e-5 (f32)."""
    _, tree = _flax_tree()
    net = _torch_net(tree)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, SIZE, SIZE, 6))
                         .astype(np.float32))
    lvl = torch.tensor([0.7, 0.2])
    with torch.no_grad():
        got = net(x, lvl)
        _use_reference_norm(monkeypatch)
        torch.testing.assert_close(got, net(x, lvl), rtol=0, atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_every_block_runs_k1(monkeypatch, train):
    """In train and eval mode, each Block's GroupNorm -> Swish goes through
    gn_swish_custom (K1) once per forward, with no other path."""
    calls = []

    def recording(x, scale, bias, groups, eps=1e-5):
        calls.append(x.shape)
        return gn_swish_custom(x, scale, bias, groups, eps)

    monkeypatch.setattr(unet_fastdiffsr, "gn_swish_custom", recording)
    net = _small_net(dropout=0.2).train(train)
    with torch.no_grad():
        net(torch.randn(2, SIZE, SIZE, 6), torch.rand(2),
            generator=torch.Generator().manual_seed(0))
    assert len(calls) == sum(isinstance(m, Block) for m in net.modules())


def test_chip_smoke_reference_norm_swaps_and_restores():
    """The on-card checks' comparison arm: inside ``reference_norm`` the
    Blocks run gn_swish_reference, afterwards K1 again."""
    import chip_smoke
    assert unet_fastdiffsr.gn_swish_custom is gn_swish_custom
    with chip_smoke.reference_norm():
        assert unet_fastdiffsr.gn_swish_custom is gn_swish_reference
    assert unet_fastdiffsr.gn_swish_custom is gn_swish_custom
    with pytest.raises(KeyError):
        with chip_smoke.reference_norm():
            raise KeyError("restored on error too")
    assert unet_fastdiffsr.gn_swish_custom is gn_swish_custom


def test_use_ieee_float32_turns_tf32_off(monkeypatch):
    from fastdiffsr_tpu_torch.device import use_ieee_float32
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    use_ieee_float32()
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_unet_blocks_see_contiguous_nhwc_maps():
    """K1 and K2 read contiguous NHWC maps: every Block's input stays
    channels-last through a train-mode forward (dropout, skip concats)."""
    net = _small_net(dropout=0.2).train()
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].permute(0, 2, 3, 1)
                                      .is_contiguous()))
        for m in net.modules() if isinstance(m, Block)]
    x = torch.randn(2, SIZE, SIZE, 6)
    out = net(x, torch.rand(2), generator=torch.Generator().manual_seed(0))
    out.sum().backward()
    for h in hooks:
        h.remove()
    # 2 levels x (1 + 2 up) res blocks... : every Block ran once
    assert len(seen) == sum(isinstance(m, Block) for m in net.modules())
    assert all(seen)


def test_train_mode_dropout_draws_from_the_generator():
    net = _small_net(dropout=0.5)
    x, lvl = torch.randn(2, SIZE, SIZE, 6), torch.rand(2)

    def run(seed):
        return net(x, lvl, generator=torch.Generator().manual_seed(seed))

    net.train()
    with torch.no_grad():
        a, b, c = run(1), run(1), run(2)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert (a - c).abs().max() > 1e-4
        with pytest.raises(ValueError, match="generator"):
            net(x, lvl)
        net.eval()
        torch.testing.assert_close(net(x, lvl), net(x, lvl), rtol=0, atol=0)


# ------------------------------------------------------ training loss --

# (variant, Blocks on gn_swish_reference instead of K1)
LOSS_CASES = {"fastdiffsr": ("fastdiffsr", False),
              "fastdiffsr_reference_norm": ("fastdiffsr", True),
              "ddpm": ("ddpm", False), "tesr": ("tesr", False),
              "gdp": ("gdp", False)}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_training_loss_and_grads_match_jax(case, monkeypatch):
    """The port's training_loss and its parameter gradients against the
    JAX engine's, with the noise level and the noise injected (JAX's draws
    patched) and dropout 0, with the Blocks on K1 (the product path) and
    on gn_swish_reference (the arm the on-card train-step check compares
    with). Loss atol 1e-5; each gradient leaf within 1e-4 of its max |g|."""
    variant, reference_norm = LOSS_CASES[case]
    flax_net, tree = _flax_tree(1)
    batch = _batch_np(4)
    rng = np.random.default_rng(5)
    noise = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    gamma = np.asarray([0.93, 0.41], np.float32)
    t = np.asarray([3, 17], np.int32)
    spec = JaxSpec.for_variant(variant)
    jeng = JaxEngine(spec, JaxBuffers.create(SCHED))
    jeng.sample_gammas = lambda key, b: (jnp.asarray(gamma), None)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(noise))
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(t))

    def jloss(params):
        return jeng.training_loss(
            lambda x, lvl: flax_net.apply({"params": params}, x, lvl,
                                          deterministic=True),
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    monkeypatch.undo()

    if reference_norm:
        _use_reference_norm(monkeypatch)
    net = _torch_net(tree).train()
    eng = _engine(variant)
    draws = ({"gamma": torch.from_numpy(gamma)}
             if spec.conditioning == "continuous_gamma"
             else {"t": torch.from_numpy(t).long()})
    loss = eng.training_loss(lambda x, lvl: net(x, lvl), _torch_batch(batch),
                             None, noise=torch.from_numpy(noise), **draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=0,
                               atol=1e-5)
    want = flax_params_to_torch(jax.tree_util.tree_map(np.asarray,
                                                       want_grads))
    for name, p in net.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=name)


def test_sample_gammas_and_q_sample_match_jax():
    """gamma lies in [sqrt_acp_prev[t], sqrt_acp_prev[t-1]] of the drawn
    t; q_sample is the JAX formula (atol 1e-6)."""
    eng = _engine()
    b = eng.buffers
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        gamma, t = eng.sample_gammas(g, 8)
        t = int(t)
        assert 1 <= t <= 20 and gamma.shape == (8,)
        lo, hi = b.sqrt_alphas_cumprod_prev[t - 1], \
            b.sqrt_alphas_cumprod_prev[t]
        assert ((gamma <= lo + 1e-7) & (gamma >= hi - 1e-7)).all()
    rng = np.random.default_rng(6)
    x0, eps = (rng.standard_normal((3, 4, 4, 3)).astype(np.float32)
               for _ in range(2))
    gam = np.asarray([0.9, 0.5, 0.1], np.float32)
    jeng = JaxEngine(JaxSpec.for_variant("fastdiffsr"), JaxBuffers.create(SCHED))
    np.testing.assert_allclose(
        eng.q_sample(*map(torch.from_numpy, (x0, gam, eps))).numpy(),
        np.asarray(jeng.q_sample(*map(jnp.asarray, (x0, gam, eps)))),
        rtol=0, atol=1e-6)


# ---------------------------------------------------------- optimizer --

@pytest.mark.parametrize("kind", ["adam", "adamw", "lion"])
def test_optimizer_steps_match_optax(kind):
    """Two steps from the same parameters and gradients against optax
    (``make_optimizer`` of the JAX package): within 5 % of lr. Parameters
    of magnitude ~100 make the weight-decay defaults (adamw 1e-4, lion
    1e-3) show in the update."""
    lr = 1e-2
    rng = np.random.default_rng(7)
    params = {f"p{i}": rng.uniform(-100, 100, shape).astype(np.float32)
              for i, shape in enumerate([(5, 3), (7,), (2, 2, 3)])}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    tx = jax_make_optimizer({"type": kind, "lr": lr})
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = make_optimizer(tp.values(), {"type": kind, "lr": lr})
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=0.05 * lr, err_msg=k)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="sgd"):
        make_optimizer([torch.nn.Parameter(torch.zeros(1))], {"type": "sgd"})


# ------------------------------------------------------- train steps --

def _state(seed=0, dropout=0.0, lr=1e-3):
    net = _small_net(seed, dropout)
    return create_train_state(net, make_optimizer(net.parameters(),
                                                  {"lr": lr}))


def test_ema_before_start_tracks_params():
    state = _state()
    step = make_train_step(_engine(), ema_start=1000)
    step(state, _torch_batch(_batch_np()), step_generator(0, 0, "cpu"))
    for k, p in state.net.named_parameters():
        assert torch.equal(state.ema_params[k], p.detach()), k


def test_ema_after_start_lags_params():
    state = _state()
    before = {k: v.clone() for k, v in state.ema_params.items()}
    step = make_train_step(_engine(), ema_decay=0.9, ema_start=0)
    step(state, _torch_batch(_batch_np()), step_generator(0, 0, "cpu"))
    params = dict(state.net.named_parameters())
    assert any((state.ema_params[k] - params[k]).abs().max() > 0
               for k in params)
    for k in params:
        torch.testing.assert_close(
            state.ema_params[k], 0.9 * before[k] + 0.1 * params[k].detach(),
            rtol=0, atol=1e-6)


def test_train_step_metrics():
    """grad_norm is the global L2 norm of the gradients the update used;
    the step counter advances."""
    state = _state(dropout=0.2)
    step = make_train_step(_engine())
    _, m = step(state, _torch_batch(_batch_np()), step_generator(0, 0, "cpu"))
    norms = torch.stack([p.grad.norm() for p in state.net.parameters()])
    torch.testing.assert_close(m["grad_norm"], norms.norm(), rtol=1e-6,
                               atol=0)
    assert state.step == 1 and torch.isfinite(m["l_pix"])


def test_loss_decreases_on_a_fixed_batch():
    state = _state(lr=2e-3)
    step = make_train_step(_engine(), ema_start=10_000)
    batch = _torch_batch(_batch_np(b=8))
    losses = [step(state, batch, step_generator(42, i % 4, "cpu"))[1]
              ["l_pix"].item() for i in range(30)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def _u8_data(seed=8, n=10):
    g = np.random.default_rng(seed)
    return {k: torch.from_numpy(g.integers(0, 255, (n, SIZE, SIZE, 3),
                                           dtype=np.uint8))
            for k in ("HR", "SR")}


def test_cached_step_assembles_its_batch_from_the_step_generator():
    """Indices with replacement, u8 / 127.5 - 1, a paired hflip: the same
    draws, in the same order, from step_generator(seed, step)."""
    seen = []

    class Recording(DiffusionEngine):
        def training_loss(self, denoise_fn, batch, generator=None, **kw):
            seen.append({k: v.clone() for k, v in batch.items()})
            return super().training_loss(denoise_fn, batch, generator, **kw)

    eng = Recording(DiffusionSpec.for_variant("fastdiffsr"),
                    ScheduleBuffers.create(SCHED, device="cpu"))
    data = _u8_data()
    state = _state()
    make_cached_train_step(eng, batch_size=4)(state, data, 3)
    gen = step_generator(3, 0, "cpu")
    idx = torch.randint(0, 10, (4,), generator=gen)
    flip = torch.rand((4,), generator=gen) < 0.5
    assert flip.any() and not flip.all()      # both branches exercised
    for k in ("HR", "SR"):
        want = data[k][idx].float() / 127.5 - 1.0
        want[flip] = want[flip].flip(2)
        torch.testing.assert_close(seen[0][k], want, rtol=0, atol=0)


def test_cached_step_draws_follow_the_step_counter():
    """Each call draws from step_generator(seed, state.step): a state
    resumed at step 2 takes the same third step (batch, noise, dropout)
    as an unbroken run."""
    data = _u8_data(9)
    a, b = _state(dropout=0.2), _state(dropout=0.2)
    step = make_cached_train_step(_engine(), batch_size=4, ema_start=1)
    for _ in range(2):
        step(a, data, 11)
    b.net.load_state_dict(a.net.state_dict())
    b.optimizer.load_state_dict(copy.deepcopy(a.optimizer.state_dict()))
    b.ema_params = {k: v.clone() for k, v in a.ema_params.items()}
    b.step = a.step
    la, lb = (step(st, data, 11)[1]["l_pix"] for st in (a, b))
    assert a.step == b.step == 3
    assert torch.equal(la, lb)
    for k, p in a.net.named_parameters():
        assert torch.equal(p, dict(b.net.named_parameters())[k]), k
        assert torch.equal(a.ema_params[k], b.ema_params[k]), k


# -------------------------------------------------------- checkpoints --

def test_checkpoint_roundtrip_is_bit_equal(tmp_path):
    state = _state(dropout=0.2)
    step = make_train_step(_engine(), ema_decay=0.5, ema_start=0)
    batch = _torch_batch(_batch_np())
    for i in range(2):
        step(state, batch, step_generator(0, i, "cpu"))
    path = save_state(state, str(tmp_path), epoch=3)
    assert path.endswith("I2_E3")
    fresh = load_state(path, _state(seed=9, dropout=0.2), "fastdiffsr")
    assert (fresh.step, fresh.epoch) == (2, 3)
    for k, v in state.net.state_dict().items():
        assert torch.equal(fresh.net.state_dict()[k], v), k
        assert torch.equal(fresh.ema_params[k], state.ema_params[k]), k
    sa, sb = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    for i in sa["state"]:
        for n in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][i][n], sb["state"][i][n])
    # the next step from either is the same
    ma = step(state, batch, step_generator(0, 2, "cpu"))[1]
    mb = step(fresh, batch, step_generator(0, 2, "cpu"))[1]
    assert torch.equal(ma["l_pix"], mb["l_pix"])
    raw, ema = (load_params_only(path, use_ema=u, variant="fastdiffsr")
                for u in (False, True))
    assert any(not torch.equal(raw[k], ema[k]) for k in raw)


def test_orbax_checkpoint_is_refused(tmp_path):
    (tmp_path / "I1_E1" / "orbax").mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax"):
        load_params_only(str(tmp_path / "I1_E1"), variant="fastdiffsr")
    with pytest.raises(FileNotFoundError):
        load_params_only(str(tmp_path), variant="fastdiffsr")


JAX_RESUME = r"""
import sys
for m in ("jax", "jaxlib", "flax", "optax", "fastdiffsr_tpu"):
    sys.modules[m] = None
import numpy as np, torch
from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine, DiffusionSpec,
                                            ScheduleBuffers)
from fastdiffsr_tpu_torch.models.unet_fastdiffsr import FastDiffSRUNet
from fastdiffsr_tpu_torch.train import (create_train_state, make_optimizer,
                                        make_train_step)
from fastdiffsr_tpu_torch.train.checkpoint import load_state
ckpt, io_path, lr = sys.argv[1], sys.argv[2], float(sys.argv[3])
d = dict(np.load(io_path))
net = FastDiffSRUNet(inner_channel=8, norm_groups=4, channel_mults=(1, 2),
                     res_blocks=1, dropout=0.0)
state = load_state(ckpt, create_train_state(
    net, make_optimizer(net.parameters(), {"lr": lr})), "fastdiffsr")
eng = DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                      ScheduleBuffers.create(
                          {"schedule": "linear_cosine", "n_timestep": 20,
                           "linear_start": 1e-6, "linear_end": 1e-2},
                          device="cpu"))
_, m = make_train_step(eng)(
    state, {"HR": torch.from_numpy(d["HR"]), "SR": torch.from_numpy(d["SR"])},
    None, noise=torch.from_numpy(d["noise"]),
    gamma=torch.from_numpy(d["gamma"]))
out = {k: v.numpy() for k, v in net.state_dict().items()}
out["__step"] = np.asarray(state.step)
out["__loss"] = m["l_pix"].numpy()
np.savez(io_path + ".out.npz", **out)
"""


def test_jax_pickle_checkpoint_resumes_like_jax(tmp_path, monkeypatch):
    """A JAX ``save_state`` pickle (after one Adam step) loads in a process
    where jax, flax, optax and the JAX package cannot be imported; the
    next step from it, with injected draws, matches the JAX package's
    next step: loss atol 1e-5, parameters within 5 % of lr."""
    lr = 1e-3
    flax_net, tree = _flax_tree(2)
    tx = jax_make_optimizer({"lr": lr})
    eng = JaxEngine(JaxSpec.for_variant("fastdiffsr"),
                    JaxBuffers.create(SCHED))

    def apply(p, x, lvl):
        return flax_net.apply({"params": p}, x, lvl, deterministic=True)

    state = jax_create_state(jax.tree_util.tree_map(jnp.asarray, tree), tx)
    first = {k: jnp.asarray(v) for k, v in _batch_np(10).items()}
    grads = jax.jit(jax.grad(lambda p: eng.training_loss(
        lambda x, lvl: apply(p, x, lvl), first, jax.random.PRNGKey(1))))(
            state.params)
    upd, opt_state = tx.update(grads, state.opt_state, state.params)
    state = state.replace(step=state.step + 1, opt_state=opt_state,
                          params=optax.apply_updates(state.params, upd))
    ckpt = jax_save_state(state, str(tmp_path), epoch=1)

    batch = _batch_np(11)
    rng = np.random.default_rng(12)
    noise = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    gamma = np.asarray([0.8, 0.35], np.float32)
    eng.sample_gammas = lambda key, b: (jnp.asarray(gamma), None)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(noise))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: eng.training_loss(
        lambda x, lvl: apply(p, x, lvl),
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(2))))(state.params)
    monkeypatch.undo()
    upd, _ = tx.update(grads, state.opt_state, state.params)
    want = flax_params_to_torch(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(state.params, upd)))

    io_path = str(tmp_path / "io.npz")
    np.savez(io_path, noise=noise, gamma=gamma, **batch)
    out = subprocess.run([sys.executable, "-c", JAX_RESUME, ckpt, io_path,
                          str(lr)], cwd=REPO_ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = np.load(io_path + ".out.npz")
    assert int(got["__step"]) == 2
    np.testing.assert_allclose(float(got["__loss"]), float(loss), rtol=0,
                               atol=1e-5)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w.numpy(), rtol=0, atol=0.05 * lr,
                                   err_msg=k)
