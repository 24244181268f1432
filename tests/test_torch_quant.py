"""The port's W8A8 3x3 conv (``ops/quant.py``) and the ``quant`` mode of
its FastDiffSR UNet against the JAX package (``ops/quant.py``, the Flax
UNet with ``quant``), on the same numpy inputs; on the CPU the wrapper
runs Q1's plain version.

Tolerances:
- the int8 weights and activations, the int32 convolution and
  ``quant_conv3``'s output: exact. The port divides, rounds (half to even)
  and clamps as JAX does, in float32, and the int32 sums are exact in
  both; no element was seen to differ, so none is allowed (the bound
  stated for the output is one unit in the last place of its type, and
  the check is equality);
- gradients: rtol 1e-5 of the largest (float32 sums over the map, taken
  in other orders);
- the whole UNet: every quantized conv of the port's forward at 128x64
  is held exactly to JAX's ``quant_conv3`` (run op by op, as the tests
  above do: jitted, XLA fuses the epilogue's product and sum into one
  FMA) on the map it saw, and the convs that quantize are JAX's (same
  count and shapes). The two nets' outputs are not bit-equal: their GroupNorm
  statistics differ in the last float32
  bit (atol 2e-4 unquantized, tests/test_torch_unet.py), which moves an
  activation across a rounding boundary now and then, and the dynamic
  scale of every later conv then spreads the step over the map (0.4-0.5
  of the quantization error itself at 128x64, in relative RMS). So the
  output is held to be nearer JAX's quantized output than the port's
  own float output is, and to atol 2e-4 where no map is 128 rows high;
- ranks: one conv split over 2 gloo ranks equals one process bit for bit
  (gradients: rtol 1e-5); the UNet's samples on 2 ranks equal one
  process's bit for bit (2 rows a rank, where the CPU's float parts give
  the same bits at both batch sizes); 2 train steps on 2 ranks, the
  1-rank losses within rtol 1e-5 and the parameters within 2e-5
  (tests/test_torch_dist_train.py's bounds).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdiffsr_tpu.models.unet_fastdiffsr import FastDiffSRUNet as FlaxUNet
from fastdiffsr_tpu.ops import quant as jq
from fastdiffsr_tpu_torch.models import unet_fastdiffsr as tu
from fastdiffsr_tpu_torch.models.convert import flax_params_to_torch
from fastdiffsr_tpu_torch.ops import kernels
from fastdiffsr_tpu_torch.ops import quant as tq
from tests import torch_dist_worker as W

torch.set_num_threads(2)

DT = {"f32": (torch.float32, jnp.float32),
      "bf16": (torch.bfloat16, jnp.bfloat16)}
KW = dict(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
          res_blocks=1, dropout=0.0)
GRAD_RTOL = 1e-5


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(np.mean((a - b) ** 2)) / (np.sqrt(np.mean(b ** 2)) + 1e-12)


def _conv_inputs(seed, shape=(2, 12, 10, 64), co=24, tie=False):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal(shape) * 2).astype(np.float32)
    w = (rng.standard_normal((3, 3, shape[-1], co)) * 0.05).astype(
        np.float32)                                       # HWIO, as JAX
    b = (rng.standard_normal(co) * 0.1).astype(np.float32)
    if tie:
        m = np.abs(h).max() + 0.5
        h[0, 1, 2, 3], h[1, 4, 5, 6] = m, -m               # |h| max twice
        wm = np.abs(w[..., 0]).max() + 0.01
        w[0, 0, 0, 0], w[2, 1, 5, 0] = wm, -wm             # in channel 0
    return h, w, b


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _jax_q_h(h, static):
    """JAX quant_conv3's activation quantization (its own expressions)."""
    hf = jnp.asarray(h).astype(jnp.float32)
    s_a = (jnp.float32(jq.STATIC_ACT_MAX / 127.0) if static else
           jnp.maximum(jnp.max(jnp.abs(hf)) / 127.0, 1e-12))
    return np.asarray(jnp.clip(jnp.round(hf / s_a), -127, 127)
                      .astype(jnp.int8)), np.asarray(s_a)


@pytest.mark.parametrize("tie", [False, True])
def test_quantize_weights_match_jax(tie):
    _, w, _ = _conv_inputs(0, tie=tie)
    q_j, s_j = jq.quantize_weights(jnp.asarray(w))
    q_t, s_t = tq.quantize_weights(_oihw(w))
    assert q_t.dtype == torch.int8
    np.testing.assert_array_equal(q_t.numpy(),
                                  np.asarray(q_j).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    # the packed layout holds the same integers
    packed = tq.pack_weights(q_t)
    # one block of 64 output channels, two chunks of 32 input channels
    assert packed.shape == (1, 2, 9, 2, 64, 16) and packed.is_contiguous()
    assert torch.equal(tq.unpack_weights(packed, 24, 64), q_t)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_activation_quantization_matches_jax(static, dt):
    tdt, jdt = DT[dt]
    h, _, _ = _conv_inputs(1)
    h = np.array(jnp.asarray(h).astype(jdt).astype(jnp.float32))
    if static:
        h[0, 0, 0, :8] = [9.0, -9.0, 0.5 * 8 / 127, 1.5 * 8 / 127, -2.5 * 8
                          / 127, 12.0, -0.0, 127.5 * 8 / 127]   # clip, ties
    q_j, s_j = _jax_q_h(jnp.asarray(h).astype(jdt), static)
    ht = torch.from_numpy(h).to(tdt)
    s_a = tq.activation_scale(ht, static)
    np.testing.assert_array_equal(s_a.numpy(), s_j)
    np.testing.assert_array_equal(tq.quantize_activations(ht, s_a).numpy(),
                                  q_j)


def test_int32_conv_matches_jax_exactly():
    """Random int8 maps, and one whose accumulators reach 9*512*127^2,
    past float32's 2^24: the plain version is exact in both."""
    rng = np.random.default_rng(2)
    cases = [(rng.integers(-127, 128, (2, 9, 7, 96), dtype=np.int8),
              rng.integers(-127, 128, (3, 3, 96, 5), dtype=np.int8)),
             (np.full((1, 4, 5, 512), 127, np.int8),
              np.full((3, 3, 512, 3), 127, np.int8))]
    cases[1][1][1, 1, 0, 1] = -127           # one odd product, not a power
    for qh, qw in cases:
        want = np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(qh), jnp.asarray(qw), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32))
        got = tq.quant_conv3_plain(torch.from_numpy(qh), _oihw(qw))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() == 9 * 512 * 127 ** 2 > 2 ** 24


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quant_conv3_matches_jax(static, dt):
    tdt, jdt = DT[dt]
    h, w, b = _conv_inputs(3)
    hj = jnp.asarray(h).astype(jdt)
    want = np.asarray(jq.quant_conv3(hj, jnp.asarray(w), jnp.asarray(b), jdt,
                                     static_scale=static).astype(jnp.float32))
    ht = torch.from_numpy(np.array(hj.astype(jnp.float32))).to(tdt)
    got = tq.quant_conv3(ht, _oihw(w), torch.from_numpy(b), tdt,
                         static_scale=static)
    assert got.dtype == tdt and got.shape == (2, 12, 10, 24)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # through the registered operator (a traced call's route)
    q_w, s_w = tq.quantize_weights(_oihw(w))
    via_op = torch.ops.fdsr.quant_conv3(
        ht, tq.pack_weights(q_w), s_w, tq.activation_scale(ht, static),
        torch.from_numpy(b), tdt)
    assert torch.equal(via_op, got)


@pytest.mark.parametrize("static,tie", [(False, False), (False, True),
                                        (True, True)])
def test_gradients_match_jax(static, tie):
    """d/dh, d/dW and d/dbias of sum(quant_conv3(h, W, b) * G) against
    jax.grad: bias directly, h and W only at their max-abs elements
    through s_a * s_w (split between tied maxima), h none with the static
    scale."""
    h, w, b = _conv_inputs(4, (2, 8, 6, 32), co=16, tie=tie)
    gw = np.random.default_rng(5).standard_normal((2, 8, 6, 16)).astype(
        np.float32)

    def jloss(hh, ww, bb):
        return jnp.sum(jq.quant_conv3(hh, ww, bb, jnp.float32,
                                      static_scale=static) * gw)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    leaves = [torch.from_numpy(h).requires_grad_(),
              _oihw(w).requires_grad_(), torch.from_numpy(b).requires_grad_()]
    y = tq.quant_conv3(*leaves, torch.float32, static_scale=static)
    tg = torch.autograd.grad((y * torch.from_numpy(gw)).sum(), leaves,
                             materialize_grads=True)
    want = [np.asarray(jg[0]), np.asarray(jg[1]).transpose(3, 2, 0, 1),
            np.asarray(jg[2])]
    for name, a, e in zip(("h", "W", "bias"), tg, want):
        np.testing.assert_allclose(a.numpy(), e, rtol=0,
                                   atol=GRAD_RTOL * np.abs(e).max() + 1e-12,
                                   err_msg=name)
    nz_h = np.count_nonzero(want[0])
    assert nz_h == (0 if static else 2 if tie else 1)
    if tie:
        assert np.count_nonzero(want[1][0]) == 2    # the tied channel


def test_error_bounds_of_the_jax_tests():
    """tests/test_quant.py's bounds, on the port: ~1% relative RMS against
    the float conv, and per-channel weight scales that keep a 100x channel
    from degrading the others."""
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((2, 16, 16, 64)).astype(
        np.float32))
    k = torch.from_numpy((rng.standard_normal((32, 64, 3, 3)) * 0.05)
                         .astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(32) * 0.1).astype(np.float32))

    def ref(kk):
        return torch.nn.functional.conv2d(h.permute(0, 3, 1, 2), kk, b,
                                          padding=1).permute(0, 2, 3, 1)

    got = tq.quant_conv3(h, k, b, torch.float32)
    err = _rel_rms(got, ref(k))
    assert 0 < err < 0.02, err
    k2 = k.clone()
    k2[0] *= 100.0
    got2 = tq.quant_conv3(h, k2, b, torch.float32)
    assert _rel_rms(got2[..., 1:], ref(k2)[..., 1:]) < 0.02


def test_default_quant_parsing(monkeypatch):
    monkeypatch.delenv("FASTDIFFSR_TPU_QUANT", raising=False)
    assert tq.default_quant() == ""
    for mode in ("", "w8a8", "w8a8s"):
        monkeypatch.setenv("FASTDIFFSR_TPU_QUANT", mode)
        assert tq.default_quant() == mode == jq.default_quant()
    monkeypatch.setenv("FASTDIFFSR_TPU_QUANT", "int4")
    with pytest.raises(ValueError, match="int4"):
        tq.default_quant()
    with pytest.raises(ValueError):
        tu.FastDiffSRUNet(**KW, quant="int4")


def test_wrapper_checks_and_weight_cache():
    """The launch path refuses a CPU map (the plain version is the CPU's
    route); the cache packs once while the weight is unchanged and again
    after an in-place update."""
    h, w, b = _conv_inputs(6)
    ht, wt, bt = torch.from_numpy(h), _oihw(w), torch.from_numpy(b)
    q_w, s_w = tq.quantize_weights(wt)
    with pytest.raises(ValueError, match="device"):
        tq.quant_conv3_launch(ht, tq.pack_weights(q_w), s_w,
                              tq.activation_scale(ht, False), bt,
                              torch.float32)
    cache = {}
    before = dict(kernels.LAUNCHES)
    y1 = tq.quant_conv3(ht, wt, bt, torch.float32, cache=cache)
    packed = cache["packed"]
    y2 = tq.quant_conv3(ht, wt, bt, torch.float32, cache=cache)
    assert cache["packed"] is packed and torch.equal(y1, y2)
    with torch.no_grad():
        wt.mul_(2.0)
    tq.quant_conv3(ht, wt, bt, torch.float32, cache=cache)
    assert cache["packed"] is not packed
    assert kernels.LAUNCHES == before       # CPU tensors: plain version only


@pytest.fixture(scope="module")
def nets():
    """(Flax net with quant='w8a8', seeded Flax params of its tree, the
    port's float and quantized nets with the converted params). The tree
    comes from ``eval_shape`` (a Flax init compiles for seconds): kernels
    N(0, 1/fan_in), GroupNorm scales 1 and other 1-d leaves 0, each 1-d
    leaf plus N(0, 0.05)."""
    flax_net = FlaxUNet(**KW, quant="w8a8")
    shapes = jax.eval_shape(flax_net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 6)), jnp.ones((1,)))
    rng = np.random.default_rng(0)

    def leaf(path, s):
        if len(s.shape) == 1:
            base = 1.0 if path[-1].key == "scale" else 0.0
            return (base + rng.standard_normal(s.shape) * 0.05).astype(
                np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes["params"])
    sd = flax_params_to_torch(tree)
    out = []
    for quant in ("", "w8a8"):
        net = tu.FastDiffSRUNet(**KW, quant=quant).eval()
        net.load_state_dict(sd, strict=True)
        out.append(net)
    return flax_net, tree, *out


def test_unet_gate_off_is_exact_and_tree_unchanged(nets):
    _, _, net, qnet = nets
    assert list(net.state_dict()) == list(qnet.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, 16, 6)).astype(np.float32))
    lvl = torch.tensor([0.7, 0.3])
    with torch.no_grad():
        assert torch.equal(qnet(x, lvl), net(x, lvl))


@pytest.mark.parametrize("hw", [(128, 128), (128, 64), (64, 128)])
def test_unet_matches_jax(nets, hw, monkeypatch):
    flax_net, tree, net, qnet = nets
    rng = np.random.default_rng(hw[0] + hw[1])
    x = rng.standard_normal((1, *hw, 6)).astype(np.float32)
    lvl = np.asarray([0.6], np.float32)
    seen_j, seen_t = [], []
    real_j = jq.quant_conv3

    def count_j(h, kernel, *a, **k):
        seen_j.append((tuple(h.shape), tuple(kernel.shape)))
        return real_j(h, kernel, *a, **k)

    monkeypatch.setattr(jq, "quant_conv3", count_j)
    want = np.asarray(jax.jit(flax_net.apply)(
        {"params": tree}, jnp.asarray(x), jnp.asarray(lvl)))
    real_t = tu.quant_conv3

    def record_t(h, weight, bias, dtype, static_scale=False, cache=None):
        y = real_t(h, weight, bias, dtype, static_scale, cache=cache)
        seen_t.append((h.detach().clone(), weight.detach().numpy(),
                       bias.detach().numpy(), y))
        return y

    monkeypatch.setattr(tu, "quant_conv3", record_t)
    with torch.no_grad():
        got = qnet(torch.from_numpy(x), torch.from_numpy(lvl)).numpy()
        plain = net(torch.from_numpy(x), torch.from_numpy(lvl)).numpy()
    # the gate is on the height: 7 convs of this net at 128 rows, none at 64
    assert len(seen_t) == (7 if hw[0] == 128 else 0)
    assert [(tuple(h.shape), w.transpose(2, 3, 1, 0).shape)
            for h, w, _, _ in seen_t] == seen_j
    # op by op, JAX compiles each new shape: the 128x64 maps only
    for h, w, b, y in seen_t if hw == (128, 64) else ():
        jy = real_j(jnp.asarray(h.numpy()), jnp.asarray(
            w.transpose(2, 3, 1, 0)), jnp.asarray(b), jnp.float32)
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    if not seen_t:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
        np.testing.assert_array_equal(got, plain)
    else:
        assert _rel_rms(got, want) < _rel_rms(plain, want)


def test_entry_points_pick_up_the_mode(monkeypatch, tmp_path):
    """unet_from_config (and so cli.infer, sr_mfe and model_api.DDPM)
    read FASTDIFFSR_TPU_QUANT; with it set FastDiffSR defaults to the
    plain forward and refuses --fused, naming both."""
    from fastdiffsr_tpu_torch.cli.infer import build_unet, resolve_fused
    from fastdiffsr_tpu_torch.model_api import create_model

    model_opt = {"which_model_G": "fastdiffsr",
                 "unet": dict(W.TINY_UNET),
                 "diffusion": {"image_size": 16},
                 "beta_schedule": {"train": W.SCHEDULE, "val": W.SCHEDULE}}
    monkeypatch.delenv("FASTDIFFSR_TPU_QUANT", raising=False)
    assert resolve_fused("fastdiffsr", None) is True
    assert build_unet(model_opt, device="cpu").quant == ""
    for mode in ("w8a8", "w8a8s"):
        monkeypatch.setenv("FASTDIFFSR_TPU_QUANT", mode)
        assert resolve_fused("fastdiffsr", None) is False
        assert resolve_fused("fastdiffsr", False) is False
        assert resolve_fused("ddpm", None) is False
        with pytest.raises(ValueError, match="--fused.*FASTDIFFSR_TPU_QUANT"):
            resolve_fused("fastdiffsr", True)
        net = build_unet(model_opt, device="cpu")
        assert net.quant == mode and net.final_conv.quant == mode
    opt = {"model": model_opt, "train": {"optimizer": {"lr": 1e-4}},
           "path": {"resume_state": None}}
    m = create_model(opt, device="cpu")
    assert m.net.quant == "w8a8s"


@pytest.fixture(scope="module")
def conv_ranks(tmp_path_factory):
    """(one process's, each of 2 gloo ranks') quant_conv_case arrays."""
    return (W.quant_conv_case()[1],
            [a for _, a in W.launch("quant_conv", 2,
                                    tmp_path_factory.mktemp("conv"))])


@pytest.mark.parametrize("mode", ["w8a8", "w8a8s"])
def test_two_ranks_share_the_scale(conv_ranks, mode):
    """One conv over 2 gloo ranks (2 rows each): the output rows equal one
    process's; the gradient of the global max reaches the ranks holding
    it, split over the three tied elements on both ranks (none with the
    static scale); the weight's and bias's gradients sum to one
    process's."""
    one, ranks = conv_ranks
    want = {k.split("/")[1]: v for k, v in one.items()
            if k.startswith(mode + "/")}
    got = [{k.split("/")[1]: v for k, v in a.items()
            if k.startswith(mode + "/")} for a in ranks]
    np.testing.assert_array_equal(np.concatenate([a["y"] for a in got]),
                                  want["y"])
    gh = np.concatenate([a["gh"] for a in got])
    np.testing.assert_allclose(gh, want["gh"], rtol=0,
                               atol=GRAD_RTOL * np.abs(want["gh"]).max())
    assert np.count_nonzero(want["gh"]) == (0 if mode == "w8a8s" else 3)
    for k in ("gw", "gb"):
        np.testing.assert_allclose(sum(a[k] for a in got), want[k], rtol=0,
                                   atol=GRAD_RTOL * np.abs(want[k]).max(),
                                   err_msg=k)


def test_two_ranks_sample_as_one(tmp_path, monkeypatch):
    """w8a8 sampling split over 2 gloo ranks (cli.infer -dist's sharing of
    the dynamic scale) equals one process over the whole batch, bit for
    bit, at 128-row maps where the first stage quantizes."""
    monkeypatch.setenv("FASTDIFFSR_TPU_QUANT", "w8a8")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, want = W.sample_case(4, 128, 8, 0)
    finally:
        torch.set_num_threads(n)
    ranks = W.launch("sample", 2, tmp_path / "out", args=(4, 128, 8, 0))
    for k in want:
        if k != "rows":
            np.testing.assert_array_equal(
                np.concatenate([a[k] for _, a in ranks]), want[k],
                err_msg=k)


def test_two_rank_train_steps_equal_one(tmp_path, monkeypatch):
    """w8a8 training on 2 gloo ranks: the scale is the max over the ranks
    and its gradient the sum of theirs, so 2 Adam steps give the 1-rank
    losses and parameters (tolerances of tests/test_torch_dist_train.py)."""
    monkeypatch.setenv("FASTDIFFSR_TPU_QUANT", "w8a8")
    want, want_p = W.train_step_case(steps=2, batch=4, size=(128, 8))
    ranks = W.launch("quant_train_step", 2, tmp_path / "out",
                     args=(128, 8))
    for res, arrays in ranks:
        np.testing.assert_allclose(res["l_pix"], want["l_pix"], rtol=1e-5)
        for k, v in want_p.items():
            np.testing.assert_allclose(arrays[k], v, rtol=0, atol=2e-5,
                                       err_msg=k)


def test_export_runs_q1_as_an_operator(monkeypatch):
    """A w8a8 sampler of the T=4 schedule exported (DPM-Solver++ in 2
    steps, 128x128 maps) holds one fdsr::quant_conv3 node per quantized
    conv per eval and gives the in-process sampler's output."""
    from fastdiffsr_tpu_torch import serving
    from fastdiffsr_tpu_torch.cli.infer import make_denoiser
    from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine,
                                                DiffusionSpec,
                                                ScheduleBuffers)
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.train import make_sample_fn, pad_batch_with_keys

    monkeypatch.setenv("FASTDIFFSR_TPU_QUANT", "w8a8")
    net = unet_from_config(W.TINY_UNET, device="cpu", seed=0)
    eng = DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                          ScheduleBuffers.create(W.SCHEDULE, device="cpu"))
    ep, meta = serving.build_sample_export(eng, net, 128, sampler="dpm",
                                           steps=2, fused=False)
    nodes = [n for n in ep.graph.nodes
             if n.op == "call_function"
             and str(n.target).startswith("fdsr.quant_conv3")]
    assert len(nodes) == 7 * 2            # 7 Blocks at 128 rows, 2 evals
    # (saving and loading are the serving tests' and the card's part)
    cond = np.random.default_rng(0).uniform(-1, 1, (2, 128, 128, 3)).astype(
        np.float32)
    cond_t, gens = pad_batch_with_keys(cond, 2, 7, 0, device="cpu")
    got = serving.ExportedSampler(ep, meta)(
        {k: v.detach() for k, v in net.state_dict().items()}, cond_t, gens)
    direct = make_sample_fn(eng, make_denoiser(net, False, torch.float32),
                            sampler="dpm", ddim_steps=2)
    want = direct(cond_t, pad_batch_with_keys(cond, 2, 7, 0,
                                              device="cpu")[1])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
