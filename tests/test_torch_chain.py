"""Chained train steps of the device-cache loop on the CPU: the clamp of
``cli.sr_mfe.steps_per_call`` against the JAX CLI's rule, ``n_sub``
steps per call bit-equal to ``n_sub`` unchained calls, the captured
region (run eagerly) of a DDP-wrapped state bit-equal to unchained
steps, a replay's re-seeding plan per rank, the CLI chained by
FASTDIFFSR_TPU_STEPS_PER_CALL, its warning without the device cache,
and the chunked device-cache upload. Small nets (inner 8, 16x16), two
threads."""

import json
import logging
import math

import numpy as np
import pytest
import torch

from fastdiffsr_tpu_torch.cli import sr_mfe
from fastdiffsr_tpu_torch.data import write_pack
from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine, DiffusionSpec,
                                            ScheduleBuffers)
from fastdiffsr_tpu_torch.models.unet_fastdiffsr import (FastDiffSRUNet,
                                                         init_params)
from fastdiffsr_tpu_torch.train import (create_train_state,
                                        make_cached_train_step,
                                        make_optimizer)
from fastdiffsr_tpu_torch.train.steps import _CapturedSteps
from tests.conftest import REPO_ROOT

torch.set_num_threads(2)

SCHED = {"schedule": "linear_cosine", "n_timestep": 20,
         "linear_start": 1e-6, "linear_end": 1e-2}
FREQS = dict(print_freq=8, val_freq=16, save_checkpoint_freq=32)


def jax_rule(requested, train_opt, n_iter, step):
    """JAX cli/sr_mfe.py:488-521, restated: the gcd of the request with
    every frequency, n_iter and the resume step that is not 0."""
    chain = requested
    if chain > 1:
        for f in (int(train_opt["print_freq"]), int(train_opt["val_freq"]),
                  int(train_opt["save_checkpoint_freq"]), n_iter, step):
            if f:
                chain = math.gcd(chain, f)
    return chain


class _Log:
    def __init__(self):
        self.warnings, self.infos = [], []

    def warning(self, msg):
        self.warnings.append(msg)

    def info(self, msg):
        self.infos.append(msg)


@pytest.mark.parametrize("requested,change,n_iter,step,want", [
    (8, {}, 64, 0, 8),                            # no clamp
    (8, {"print_freq": 4}, 64, 0, 4),
    (8, {"val_freq": 6}, 64, 0, 2),
    (8, {"save_checkpoint_freq": 12}, 64, 0, 4),
    (8, {}, 36, 0, 4),                            # n_iter
    (8, {}, 64, 6, 2),                            # a resume step
    (4, {"print_freq": 0}, 64, 0, 4),             # 0 is no constraint
    (1, {"print_freq": 3}, 64, 0, 1),
])
def test_steps_per_call_clamps_as_jax(requested, change, n_iter, step, want,
                                      monkeypatch):
    """The key, or else the environment variable, clamped by the gcd of
    each frequency, n_iter and the resume step, with JAX's warning when
    the clamp changes it."""
    train_opt = {**FREQS, **change}
    assert jax_rule(requested, train_opt, n_iter, step) == want
    for how in ("key", "env"):
        log = _Log()
        opt = dict(train_opt)
        monkeypatch.delenv("FASTDIFFSR_TPU_STEPS_PER_CALL", raising=False)
        if how == "key":
            opt["steps_per_call"] = requested
        else:
            monkeypatch.setenv("FASTDIFFSR_TPU_STEPS_PER_CALL",
                               str(requested))
        got = sr_mfe.steps_per_call(opt, n_iter, step, True, log)
        assert got == want
        assert bool(log.warnings) == (want != requested)
        if log.warnings:
            assert f"clamped {requested} -> {want}" in log.warnings[0]


def test_steps_per_call_key_wins_and_cache_off_is_one(monkeypatch):
    """The key before the variable (JAX's ``or``); without the device
    cache the chain is 1, with a warning only when the variable asks for
    more; a chain below 1 raises."""
    monkeypatch.setenv("FASTDIFFSR_TPU_STEPS_PER_CALL", "2")
    log = _Log()
    assert sr_mfe.steps_per_call({**FREQS, "steps_per_call": 4}, 64, 0,
                                 True, log) == 4
    assert sr_mfe.steps_per_call({**FREQS, "steps_per_call": 4}, 64, 0,
                                 False, log) == 1
    assert "device_cache is off" in log.warnings[0]
    monkeypatch.setenv("FASTDIFFSR_TPU_STEPS_PER_CALL", "1")
    quiet = _Log()
    assert sr_mfe.steps_per_call({**FREQS, "steps_per_call": 4}, 64, 0,
                                 False, quiet) == 1
    assert quiet.warnings == []
    with pytest.raises(ValueError, match="want >= 1"):
        sr_mfe.steps_per_call({**FREQS, "steps_per_call": -2}, 64, 0, True,
                              quiet)


def _state(kind="adam", dropout=0.2):
    net = init_params(FastDiffSRUNet(inner_channel=8, norm_groups=4,
                                     channel_mults=(1, 2), res_blocks=1,
                                     dropout=dropout), 3)
    return create_train_state(net, make_optimizer(net.parameters(),
                                                  {"type": kind,
                                                   "lr": 1e-3}))


def _data(n=6):
    g = np.random.default_rng(5)
    return {k: torch.from_numpy(g.integers(0, 256, (n, 16, 16, 3),
                                           dtype=np.uint8))
            for k in ("HR", "SR")}


@pytest.mark.parametrize("kind", ["adam", "lion"])
def test_n_sub_equals_unchained_calls(kind):
    """Three n_sub=3 calls from one state equal nine n_sub=1 calls bit
    for bit: parameters, EMA (its start, step 4, falls inside the second
    chain), optimizer state and the per-step metrics, stacked (3,)."""
    eng = DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                          ScheduleBuffers.create(SCHED, device="cpu"))
    data = _data()
    a, b = _state(kind), _state(kind)
    chained = make_cached_train_step(eng, 4, ema_decay=0.9, ema_start=4,
                                     n_sub=3)
    single = make_cached_train_step(eng, 4, ema_decay=0.9, ema_start=4)
    got, want = [], []
    for _ in range(3):
        _, m = chained(a, data, 7)
        assert m["l_pix"].shape == m["grad_norm"].shape == (3,)
        got.append(m)
    for _ in range(9):
        want.append(single(b, data, 7)[1])
    assert a.step == b.step == 9
    for k in ("l_pix", "grad_norm"):
        assert torch.equal(torch.cat([m[k] for m in got]),
                           torch.stack([m[k] for m in want]))
    pb = dict(b.net.named_parameters())
    for k, p in a.net.named_parameters():
        assert torch.equal(p, pb[k]), k
        assert torch.equal(a.ema_params[k], b.ema_params[k]), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, st in sa["state"].items():
        for name, v in st.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(sb["state"][i][name])), name


def test_graph_chain_needs_cuda_and_n_sub_at_least_one():
    """A captured chain (``_CapturedSteps``) on CPU tensors raises (the
    plain chain is the loop); n_sub 0 raises."""
    eng = DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                          ScheduleBuffers.create(SCHED, device="cpu"))
    step = _CapturedSteps(eng, 2, 2, 0.9999, 5000)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        step(_state(), _data(), 0)
    with pytest.raises(ValueError, match="n_sub=0"):
        make_cached_train_step(eng, 2, n_sub=0)


class _Wrapper(torch.nn.Module):
    """A stand-in for DDP's wrapper that the captured region must not
    call."""

    def __init__(self, net):
        super().__init__()
        self.module = net

    def forward(self, *args, **kwargs):
        raise AssertionError("the captured region called the wrapper")


def test_graph_chain_refuses_a_ddp_wrapped_net():
    """A state whose train_net wraps the net (DDP under -dist) is taken
    by the chained step's captured region, which drops the wrapper and
    runs the bare net (the wrapper raises if called): two calls of the
    region, run eagerly, equal four unchained steps of an unwrapped state
    bit for bit (parameters, EMA, losses), dropout on. Without a process
    group no gradient is all-reduced (the 2-rank case:
    tests/test_torch_dist_train.py)."""
    eng = DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                          ScheduleBuffers.create(SCHED, device="cpu"))
    data = _data()
    a, b = _state(), _state()
    a.train_net = _Wrapper(a.net)
    region = _CapturedSteps(eng, 4, 2, 0.9, 3)
    got = torch.cat([region.run_eagerly(a, data, 5)["l_pix"]
                     for _ in range(2)])
    single = make_cached_train_step(eng, 4, ema_decay=0.9, ema_start=3)
    want = torch.stack([single(b, data, 5)[1]["l_pix"] for _ in range(4)])
    assert a.step == b.step == 4 and a.train_net is a.net
    assert torch.equal(got, want)
    pb = dict(b.net.named_parameters())
    for k, p in a.net.named_parameters():
        assert torch.equal(p, pb[k]), k
        assert torch.equal(a.ema_params[k], b.ema_params[k]), k


@pytest.mark.parametrize("world,r", [(1, 0), (2, 0), (2, 1), (4, 3)])
def test_replay_reseeds_each_rank_as_unchained_steps(world, r, monkeypatch):
    """The re-seeding plan of a replay: sub-step s of rank r draws from
    step_generator(seed, s) and its dropout from rank_generator of it
    for rank r (at W > 1; at W = 1 from the step's generator), and the
    generators and EMA decays the region seeds hold exactly that."""
    from fastdiffsr_tpu_torch.train import steps

    seed, start, n = 11, 5, 3
    plan = steps.replay_seeds(seed, start, n, r, world)
    assert len(plan) == n
    for i, (s_seed, r_seed) in enumerate(plan):
        g = steps.step_generator(seed, start + i, "cpu")
        assert s_seed == g.initial_seed()
        if world == 1:
            assert r_seed is None
        else:
            assert r_seed == steps.rank_generator(g, r).initial_seed()
    monkeypatch.setattr(steps, "world_size", lambda: world)
    monkeypatch.setattr(steps, "rank", lambda: r)
    eng = DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                          ScheduleBuffers.create(SCHED, device="cpu"))
    region = _CapturedSteps(eng, 2, n, 0.9, start + 1)
    st = _state()
    st.step = start
    gens, dropout, decays = region._generators(torch.device("cpu"))
    region._seed((gens, dropout, decays), st, seed)
    for i, (s_seed, r_seed) in enumerate(plan):
        assert gens[i].initial_seed() == s_seed
        assert torch.equal(
            torch.rand(4, generator=gens[i]),
            torch.rand(4, generator=steps.step_generator(seed, start + i,
                                                         "cpu")))
        if world == 1:
            assert dropout[i] is None
        else:
            assert dropout[i].initial_seed() == r_seed
    assert decays.tolist() == [0.0, pytest.approx(0.9), pytest.approx(0.9)]


def _config(tmp_path, name, **train):
    cfg = json.loads((REPO_ROOT / "fastdiffsr_tpu_torch" / "configs"
                      / "sr_fastdiffsr_train_64_256.json").read_text())
    cfg["name"] = name
    for ds in cfg["datasets"].values():
        ds.update(dataroot=str(tmp_path / "absent"), l_resolution=8,
                  r_resolution=16, num_workers=1)
    cfg["datasets"]["train"].update(batch_size=2, device_cache=True)
    if (tmp_path / "pack").is_dir():
        for ds in cfg["datasets"].values():
            ds.update(dataroot=str(tmp_path / "pack"), datatype="npy")
    cfg["datasets"]["val"]["data_len"] = 2
    cfg["model"]["unet"].update(inner_channel=8, norm_groups=4,
                                channel_multiplier=[1, 2], res_blocks=1)
    for ph in ("train", "val"):
        cfg["model"]["beta_schedule"][ph]["n_timestep"] = 4
    cfg["train"].update(n_iter=100, val_freq=1000, print_freq=2,
                        save_checkpoint_freq=1000)
    cfg["train"]["ema_scheduler"].update(step_start_ema=3, ema_decay=0.5)
    cfg["train"].update(train)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture()
def _fresh(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    for name in ("base", "val"):
        lg = logging.getLogger(name)
        for h in list(lg.handlers):
            lg.removeHandler(h)
            h.close()


def _log_of(tmp_path, name):
    run = [p for p in (tmp_path / "experiments").iterdir()
           if p.name.startswith(name)]
    return (run[0] / "logs" / "train.log").read_text()


def test_cli_chained_by_the_variable_equals_unchained(tmp_path, monkeypatch,
                                                      _fresh):
    """The device-cache loop, 8 steps with a checkpoint every 4:
    FASTDIFFSR_TPU_STEPS_PER_CALL=2 runs 2 steps per call and saves the
    unchained run's checkpoints (params, EMA across its start at step 3,
    optimizer) and losses bit for bit."""
    write_pack(str(tmp_path / "pack"), 6, 2, 8, 16)
    out = {}
    for chain in ("1", "2"):
        monkeypatch.setenv("FASTDIFFSR_TPU_STEPS_PER_CALL", chain)
        out[chain] = sr_mfe.main(["-p", "train", "-c", _config(
            tmp_path, f"c{chain}", n_iter=8, save_checkpoint_freq=4),
            "--device", "cpu"])
    assert "device-cache loop: 2 steps per call" in _log_of(tmp_path, "c2")
    assert out["2"]["step"] == out["1"]["step"] == 8
    assert out["2"]["l_pix"] == out["1"]["l_pix"]
    for it in ("I4_E1", "I8_E2"):
        a, b = (torch.load(out[c]["checkpoint"].replace("I8_E2", it)
                           + "/state.pt", weights_only=True)
                for c in ("1", "2"))
        assert a["step"] == b["step"] == int(it[1])
        for key in ("params", "ema_params"):
            for k, v in a[key].items():
                assert torch.equal(v, b[key][k]), (it, key, k)
        for i, st in a["opt_state"]["state"].items():
            for name, v in st.items():
                assert torch.equal(torch.as_tensor(v), torch.as_tensor(
                    b["opt_state"]["state"][i][name])), (it, name)


def test_cli_debug_clamps_the_chain(tmp_path, monkeypatch, _fresh):
    """-debug saves every 3 steps: a chain of 2 is clamped to 1 with JAX's
    warning, and the run takes its 8 steps."""
    monkeypatch.setenv("FASTDIFFSR_TPU_STEPS_PER_CALL", "2")
    out = sr_mfe.main(["-p", "train", "-c", _config(tmp_path, "dbg"),
                       "-debug", "--device", "cpu"])
    assert "steps_per_call clamped 2 -> 1" in _log_of(tmp_path, "dbg")
    assert out["step"] == 8 and len(out["l_pix"]) == 8


def test_cli_warns_on_the_variable_without_the_cache(tmp_path, monkeypatch,
                                                     _fresh):
    """With device_cache off the variable is ignored, with JAX's
    warning, and the loader loop runs one step per call."""
    monkeypatch.setenv("FASTDIFFSR_TPU_STEPS_PER_CALL", "4")
    cfg = json.loads(open(_config(tmp_path, "nocache")).read())
    cfg["datasets"]["train"]["device_cache"] = False
    path = tmp_path / "nocache.json"
    path.write_text(json.dumps(cfg))
    out = sr_mfe.main(["-p", "train", "-c", str(path), "-debug", "--device",
                       "cpu"])
    log = _log_of(tmp_path, "nocache")
    assert "FASTDIFFSR_TPU_STEPS_PER_CALL is set but" in log
    assert "steps per call" not in log
    assert out["step"] == 8 and len(out["l_pix"]) == 8


def test_chunked_upload_equals_the_whole_upload(tmp_path):
    """A memory-mapped pack uploaded 4 rows at a time (ragged last chunk)
    equals the whole array, dtype and shape too; chunk 0 raises."""
    write_pack(str(tmp_path / "pack"), 10, 1, 8, 16)
    from fastdiffsr_tpu_torch.data import LRHRDataset
    ds = LRHRDataset(str(tmp_path / "pack"), "npy", 8, 16)
    raw = ds.raw_uint8(materialize=False)
    assert isinstance(raw["HR"], np.memmap)
    for k, v in raw.items():
        got = sr_mfe.upload_chunked(v, torch.device("cpu"), 4)
        whole = torch.from_numpy(np.array(v))
        assert got.dtype == whole.dtype == torch.uint8
        assert torch.equal(got, whole), k
    with pytest.raises(ValueError, match="upload chunk 0"):
        sr_mfe.upload_chunked(raw["HR"], torch.device("cpu"), 0)
