"""EDiffSR's options and optimisation in the port (``ediffsr/options.py``,
``ediffsr/schedulers.py``, ``ediffsr/train.py``'s optimizer and EMA)
against the JAX package's: the PyYAML-free reader on the six shipped
option files, ``parse_options``, every LR schedule warmup included, and
AdamW / Adam / Lion after three steps on the same gradients against
optax. Tolerances are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from fastdiffsr_tpu.ediffsr import options as joptions
from fastdiffsr_tpu.ediffsr import train as jtrain
from fastdiffsr_tpu_torch.ediffsr import options as toptions
from fastdiffsr_tpu_torch.ediffsr import schedulers as tsched
from fastdiffsr_tpu_torch.ediffsr import train as ttrain
from tests.conftest import REPO_ROOT

torch.set_num_threads(2)

YMLS = sorted((REPO_ROOT / "fastdiffsr_tpu_torch" / "ediffsr"
               / "options_yml").glob("*.yml"))


def test_six_option_files_are_the_jax_packages():
    theirs = REPO_ROOT / "fastdiffsr_tpu" / "ediffsr" / "options_yml"
    assert len(YMLS) == 6
    for p in YMLS:
        assert p.read_bytes() == (theirs / p.name).read_bytes()


@pytest.mark.parametrize("path", YMLS, ids=[p.name for p in YMLS])
def test_yaml_reader_equals_safe_load(path):
    """The port's reader gives yaml.safe_load's value on every shipped
    file, and its writer's text reads back to it through both."""
    text = path.read_text()
    want = yaml.safe_load(text)
    got = toptions.load_yaml(text)
    assert got == want
    dumped = toptions.dump_yaml(got)
    assert toptions.load_yaml(dumped) == want == yaml.safe_load(dumped)


def test_yaml_scalars_resolve_as_pyyaml():
    """YAML 1.1 resolution as safe_load: nulls, booleans, ints, floats
    only with a dot ('1e-5' stays a string), quoted strings, [] and {}."""
    text = ("a: null\nb: ~\nc:\nd: yes\ne: Off\nf: 12\ng: -3\nh: 4.0e-05\n"
            "i: 1e-5\nj: .5\nk: 'it''s'\nl: \"x: y\"\nm: []\nn: {}\n"
            "o: /data/hr_256  # a comment\np: .inf\nq:\n- 1\n- two\n"
            "r:\n  s:\n    - 3\n")
    assert toptions.load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: [1, 2]\n", "a: {b: 1}\n", "a: &x 1\n",
                                  "a: *x\n", "a: |\n  x\n", "- a: 1\n",
                                  "a: 1\na: 2\n", "a: 1\n---\nb: 2\n",
                                  "a: !!str 1\n"])
def test_yaml_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        toptions.load_yaml(text)


@pytest.mark.parametrize("is_train", [True, False])
def test_parse_options_matches_jax(tmp_path, is_train):
    name = "setting_mfe_Train_x4.yml" if is_train else \
        "setting_mfe_Test_x4.yml"
    yml = next(p for p in YMLS if p.name == name)
    ours = toptions.parse_options(str(yml), is_train,
                                  root=str(tmp_path / "port"))
    theirs = joptions.parse_options(str(yml), is_train,
                                    root=str(tmp_path / "jax"))
    for k in list(ours["path"]):
        if k in ("experiments_root", "models", "training_state", "log",
                 "val_images", "results_root"):
            assert ours["path"][k].replace("/port", "/jax") == \
                theirs["path"][k]
            ours["path"][k] = theirs["path"][k]
    assert ours == theirs


SCHEDULES = [
    dict(lr_G=4e-5, lr_scheme="TrueCosineAnnealingLR", eta_min=1e-7),
    dict(lr_G=4e-5, lr_scheme="TrueCosineAnnealingLR", eta_min=1e-7,
         warmup_iter=7),
    dict(lr_G=1e-3, lr_scheme="MultiStepLR", lr_steps=[5, 9], lr_gamma=0.5,
         warmup_iter=3),
    dict(lr_G=1e-3, lr_scheme="MultiStepLR_Restart", lr_steps=[3, 8, 14],
         restarts=[10], restart_weights=[0.5]),
    dict(lr_G=1e-3, lr_scheme="CosineAnnealingLR_Restart", T_period=[10, 10],
         restarts=[10], restart_weights=[0.5], eta_min=1e-7, warmup_iter=4),
    dict(lr_G=2e-4, lr_scheme="none", warmup_iter=5),
]


@pytest.mark.parametrize("train_opt", SCHEDULES,
                         ids=[f"{s['lr_scheme']}-w{s.get('warmup_iter', 0)}"
                              for s in SCHEDULES])
def test_lr_schedules_match_jax(train_opt):
    """f(step), the rate of update ``step``, over 25 steps of a 20-step
    run: within 1e-6 relative of the JAX schedule (both float32)."""
    want = jtrain.make_lr_schedule(train_opt, 20)
    got = tsched.make_lr_schedule(train_opt, 20)
    for k in range(25):
        w = float(want(k))
        assert abs(got(k) - w) <= 1e-6 * abs(w), (k, got(k), w)


@pytest.mark.parametrize("kind", ["AdamW", "Adam", "Lion"])
def test_optimizer_matches_optax(kind):
    """make_optimizer_ediffsr with the rate set per step from the schedule
    against the JAX package's optax optimizer (which evaluates the
    schedule at the count before the update), on the same parameters and
    three gradients: parameters within 1e-6, and the moments the
    checkpoint converter maps."""
    train_opt = dict(optimizer=kind, lr_G=1e-2, beta1=0.9, beta2=0.99,
                     lr_scheme="TrueCosineAnnealingLR", eta_min=1e-4,
                     warmup_iter=2)
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal((3,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    tx, _ = jtrain.make_optimizer_ediffsr(train_opt, 3)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = ttrain.make_optimizer_ediffsr(list(tp.values()), train_opt)
    sched = tsched.make_lr_schedule(train_opt, 3)
    for step, g in enumerate(grads):
        for group in opt.param_groups:
            group["lr"] = sched(step)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0)
    moments = st[0]
    for k in tp:
        state = opt.state[tp[k]]
        np.testing.assert_allclose(state["exp_avg"].numpy(),
                                   np.asarray(moments.mu[k]), atol=1e-6)
        if kind != "Lion":
            np.testing.assert_allclose(state["exp_avg_sq"].numpy(),
                                       np.asarray(moments.nu[k]), atol=1e-7)


def test_ema_decay_is_jaxs():
    assert ttrain.EMA_DECAY_PER_STEP == jtrain.EMA_DECAY_PER_STEP
    assert (ttrain.EMA_BETA, ttrain.EMA_UPDATE_EVERY) == (
        jtrain.EMA_BETA, jtrain.EMA_UPDATE_EVERY)


def test_launcher_without_torchrun_raises_naming_the_variables(
        monkeypatch):
    """-launcher pytorch never runs as one quiet process: without
    torchrun's variables it raises and names them."""
    names = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
             "MASTER_PORT")
    for k in names:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="-launcher pytorch") as err:
        ttrain.main(["-opt", str(YMLS[0]), "-launcher", "pytorch",
                     "--device", "cpu"])
    assert all(k in str(err.value) for k in names)
