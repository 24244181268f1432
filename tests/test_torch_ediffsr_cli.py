"""The port's EDiffSR CLI (``python -m fastdiffsr_tpu_torch.ediffsr.train``)
on the CPU at the size of tests/test_ediffsr_cli.py (NAFNet width 16,
enc [1,1], T=4, 8->16 PNG tiles): training with in-run validation,
resuming from the port's checkpoints and from a JAX ``state.pkl``,
``--test`` with each sampler, the batched restore against the per-image
one, and one train step and one restore against the JAX package on the
same weights and draws. Tolerances are stated per test."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastdiffsr_tpu.diffusion import sde as jsde
from fastdiffsr_tpu.ediffsr import deg as jdeg
from fastdiffsr_tpu.ediffsr import train as jtrain
from fastdiffsr_tpu.models.convert import torch_nafnet_to_flax
from fastdiffsr_tpu.models.nafnet import ConditionalNAFNet as JaxNAFNet
from fastdiffsr_tpu_torch.diffusion import sde as tsde
from fastdiffsr_tpu_torch.ediffsr import deg as tdeg
from fastdiffsr_tpu_torch.ediffsr import train as ttrain
from fastdiffsr_tpu_torch.ediffsr.options import dump_yaml, load_yaml
from fastdiffsr_tpu_torch.metrics import load_img, save_img
from fastdiffsr_tpu_torch.models.nafnet import ConditionalNAFNet
from tests.test_torch_ediffsr_models import _randomized

torch.set_num_threads(2)

SETTING = {"width": 16, "enc_blk_nums": [1, 1], "middle_blk_num": 1,
           "dec_blk_nums": [1, 1]}
NAF = dict(width=16, enc_blk_nums=(1, 1), middle_blk_num=1,
           dec_blk_nums=(1, 1))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("ediffsr_cli")
    rng = np.random.default_rng(0)
    for sub, size in [("hr_16", 16), ("lr_8", 8)]:
        d = root / "data" / sub
        d.mkdir(parents=True)
        for i in range(4):
            save_img(rng.integers(0, 255, (size, size, 3), dtype=np.uint8),
                     str(d / f"{i}.png"))
    data = {"dataroot_GT": str(root / "data" / "hr_16"),
            "dataroot_LQ": str(root / "data" / "lr_8")}
    opt = {
        "name": "ediffsr_unit", "use_tb_logger": False, "model": "denoising",
        "distortion": "sr", "gpu_ids": [0],
        "sde": {"max_sigma": 50, "T": 4, "schedule": "cosine",
                "eps": 0.005},
        "degradation": {"sigma": 25, "noise_type": "G", "scale": 2},
        "datasets": {
            "train": {"name": "T", "mode": "LQGT", **data,
                      "use_shuffle": True, "batch_size": 2, "GT_size": 16,
                      "LR_size": 8, "n_workers": 1},
            "val": {"name": "V", "mode": "LQGT", **data, "data_len": 2}},
        "network_G": {"which_model_G": "ConditionalNAFNet",
                      "setting": SETTING},
        "path": {"pretrain_model_G": None, "strict_load": True,
                 "resume_state": None},
        "train": {"optimizer": "AdamW", "lr_G": 1e-3,
                  "lr_scheme": "TrueCosineAnnealingLR", "beta1": 0.9,
                  "beta2": 0.99, "niter": 4, "eta_min": 1e-7,
                  "loss_type": "l1", "weight": 1.0, "manual_seed": 0,
                  "val_freq": 2, "warmup_iter": 2},
        "logger": {"print_freq": 2, "save_checkpoint_freq": 2},
    }
    return root, opt


def _write(root, name, opt):
    path = root / name
    path.write_text(dump_yaml(opt))
    return str(path)


def _run(root, monkeypatch, opt, name, *args):
    monkeypatch.chdir(root)
    return ttrain.main(["-opt", _write(root, name, opt), "--device", "cpu",
                        *args])


@pytest.fixture(scope="module")
def trained(env):
    """One 4-step training run (validating 1 image at steps 2 and 4)."""
    root, opt = env
    mp = pytest.MonkeyPatch()
    try:
        summ = _run(root, mp, opt, "train.yml", "--max_iters", "4",
                    "--val_images", "1")
    finally:
        mp.undo()
    return root, opt, summ


def test_train_and_validate(trained):
    root, _, summ = trained
    exp = root / "experiments" / "ediffsr_unit"
    assert summ["steps"] == 4 and len(summ["loss"]) == 4
    assert all(np.isfinite(summ["loss"]))
    assert [v["step"] for v in summ["validations"]] == [2, 4]
    assert all(v["images"] == 1 for v in summ["validations"])
    models = sorted(p.name for p in (exp / "models").iterdir())
    assert {"I2_E0", "I4_E0", "best.txt"} <= set(models)
    assert summ["checkpoint"].endswith("I4_E0")
    log = (exp / "train.log").read_text()
    assert "# Validation # PSNR:" in log and "Best PSNR:" in log
    assert "loss" in log and "training done" in log
    assert (exp / "val.log").read_text().count("psnr") == 2
    assert (exp / "val_images" / "2" / "000.png").exists()
    assert (exp / "models" / "best.txt").read_text().strip().endswith("_E0")


def test_resume_from_the_ports_checkpoint(trained, monkeypatch):
    """Resuming at I2_E0 restores step 2, the weights, the EMA and the
    AdamW moments of that save, and trains on to step 4."""
    from fastdiffsr_tpu_torch.train import create_train_state
    from fastdiffsr_tpu_torch.train.checkpoint import load_state

    root, opt, _ = trained
    ckpt = root / "experiments" / "ediffsr_unit" / "models" / "I2_E0"
    payload = torch.load(ckpt / "state.pt", weights_only=True)
    net = ConditionalNAFNet(**NAF, up_mode="tconv")
    state = load_state(str(ckpt), create_train_state(
        net, ttrain.make_optimizer_ediffsr(net.parameters(), opt["train"])),
        "ConditionalNAFNet")
    assert state.step == 2
    for k, v in net.state_dict().items():
        assert torch.equal(v, payload["params"][k])
    for k, v in state.ema_params.items():
        assert torch.equal(v, payload["ema_params"][k])
    for i, s in state.optimizer.state_dict()["state"].items():
        assert torch.equal(s["exp_avg"],
                           payload["opt_state"]["state"][i]["exp_avg"])

    ropt = json.loads(json.dumps(opt))
    ropt["path"]["resume_state"] = str(ckpt)
    summ = _run(root, monkeypatch, ropt, "resume.yml", "--max_iters", "4")
    assert summ["step"] == 4 and summ["steps"] == 2


def test_resume_from_a_jax_state_pkl(env, tmp_path, monkeypatch):
    """A checkpoint that the JAX EDiffSR CLI's writer
    (``fastdiffsr_tpu.train.checkpoint.save_state``) wrote for a state of
    its AdamW (``make_optimizer_ediffsr``: Adam moments and the
    schedule's count) after two updates: the port loads its params, EMA,
    moments and step exactly, and training resumes from it."""
    from fastdiffsr_tpu.train.checkpoint import save_state as jax_save
    from fastdiffsr_tpu.train.state import create_train_state as jax_state
    from fastdiffsr_tpu_torch.train import create_train_state
    from fastdiffsr_tpu_torch.train.checkpoint import load_state

    root, opt = env
    net = _randomized(ConditionalNAFNet(**NAF), 7)
    params = jax.tree_util.tree_map(
        jnp.asarray, torch_nafnet_to_flax(
            {k: v.numpy() for k, v in net.state_dict().items()}))
    tx, _ = jtrain.make_optimizer_ediffsr(opt["train"], 4)
    st = jax_state(params, tx)
    rng = np.random.default_rng(8)

    @jax.jit
    def update(st, grads):
        upd, o = tx.update(grads, st.opt_state, st.params)
        p = optax.apply_updates(st.params, upd)
        return st.replace(step=st.step + 1, params=p, opt_state=o,
                          ema_params=jax.tree_util.tree_map(
                              lambda e, q: 0.9 * e + 0.1 * q,
                              st.ema_params, p))
    for _ in range(2):
        st = update(st, jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
            st.params))
    ckpt = jax_save(st, str(tmp_path / "jax_models"), it=2, epoch=0)
    assert os.path.isfile(os.path.join(ckpt, "state.pkl"))

    fresh = ConditionalNAFNet(**NAF, up_mode="tconv")
    state = load_state(ckpt, create_train_state(
        fresh, ttrain.make_optimizer_ediffsr(fresh.parameters(),
                                             opt["train"])),
        "ConditionalNAFNet")
    assert state.step == 2
    back = ConditionalNAFNet(**NAF)
    back.load_state_dict(fresh.state_dict())
    flat = torch_nafnet_to_flax({k: v.numpy()
                                 for k, v in back.state_dict().items()})
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(st.params),
                            jax.tree_util.tree_leaves(flat)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    names = [n for n, _ in fresh.named_parameters()]
    mu = torch_nafnet_to_flax({n: state.optimizer.state[p]["exp_avg"].numpy()
                               for n, p in fresh.named_parameters()})
    for a, b in zip(jax.tree_util.tree_leaves(st.opt_state[0].mu),
                    jax.tree_util.tree_leaves(mu)):
        np.testing.assert_array_equal(np.asarray(a), b)
    ema = torch_nafnet_to_flax({n: state.ema_params[n].numpy()
                                for n in names})
    for a, b in zip(jax.tree_util.tree_leaves(st.ema_params),
                    jax.tree_util.tree_leaves(ema)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert all(float(state.optimizer.state[p]["step"]) == 2
               for p in fresh.parameters()) and len(names) > 0

    ropt = json.loads(json.dumps(opt))
    ropt["name"] = "ediffsr_from_jax"
    ropt["path"]["resume_state"] = ckpt
    summ = _run(root, monkeypatch, ropt, "from_jax.yml", "--max_iters", "3")
    assert summ["step"] == 3 and summ["steps"] == 1


@pytest.mark.parametrize("sampler", ["sde", "ode", "rk45"])
def test_test_path_with_each_sampler(trained, monkeypatch, sampler):
    """--test from the trained checkpoint: metrics, one SR PNG per image,
    and the RK45 step counts."""
    root, opt, summ = trained
    topt = json.loads(json.dumps(opt))
    topt["name"] = f"ediffsr_test_{sampler}"
    topt["path"]["pretrain_model_G"] = summ["checkpoint"]
    topt["datasets"] = {"test": dict(opt["datasets"]["val"], name="Test")}
    res = _run(root, monkeypatch, topt, f"test_{sampler}.yml", "--test",
               "--sampler", sampler, "--use_ema")
    assert res["images"] == 2 and res["sampler"] == sampler
    assert all(np.isfinite(res[k]) for k in ("psnr", "ssim", "ergas"))
    assert res["avg_time"] > 0
    out = root / "results" / topt["name"]
    assert sorted(p.name for p in out.glob("?.png")) == ["0.png", "1.png"]
    log = (out / "test.log").read_text()
    assert "loaded EMA params" in log and "mean psnr" in log
    if sampler == "rk45":
        assert len(res["rk45"]) == 2
        assert all(0 < r["rk45_accepted"] <= r["rk45_trials"]
                   for r in res["rk45"])


def test_test_from_a_reference_state_dict_file(trained, monkeypatch):
    """pretrain_model_G may be a state-dict file in the reference
    DenoisingNAFNet_arch layout (a ``*_G.pth``): it loads strictly and
    restores the same images as the checkpoint directory it came from;
    a file of another width is refused."""
    root, opt, summ = trained
    payload = torch.load(os.path.join(root, summ["checkpoint"], "state.pt"),
                         weights_only=True)
    torch.save(payload["params"], root / "ref_G.pth")
    topt = json.loads(json.dumps(opt))
    topt["datasets"] = {"test": dict(opt["datasets"]["val"], name="Test")}
    pngs = {}
    for name, src in (("dir", summ["checkpoint"]),
                      ("pth", str(root / "ref_G.pth"))):
        topt["name"] = f"ediffsr_ref_{name}"
        topt["path"]["pretrain_model_G"] = src
        _run(root, monkeypatch, topt, f"ref_{name}.yml", "--test")
        pngs[name] = [load_img(str(root / "results" / topt["name"]
                                   / f"{i}.png")) for i in range(2)]
    for a, b in zip(pngs["dir"], pngs["pth"]):
        np.testing.assert_array_equal(a, b)
    wide = ConditionalNAFNet(**dict(NAF, width=32))
    torch.save(wide.state_dict(), root / "wide_G.pth")
    topt["path"]["pretrain_model_G"] = str(root / "wide_G.pth")
    with pytest.raises(RuntimeError, match="size mismatch"):
        _run(root, monkeypatch, topt, "ref_wide.yml", "--test")


def test_cond_unet_trains_and_tests(env, monkeypatch):
    """which_model_G ConditionalUNet (nf 8, depth 2): two training steps,
    then --test from their checkpoint at --batch 2, which writes the
    PNGs of a batch-1 run (within one grey level: the uint8 rounding of
    outputs whose batched convolutions sum in another order)."""
    root, opt = env
    copt = json.loads(json.dumps(opt))
    copt["name"] = "ediffsr_cond_unet"
    copt["network_G"] = {"which_model_G": "ConditionalUNet",
                         "setting": {"nf": 8, "depth": 2}}
    copt["train"].update(niter=2, val_freq=2)
    summ = _run(root, monkeypatch, copt, "cond.yml", "--val_images", "1")
    assert summ["steps"] == 2 and np.isfinite(summ["loss"]).all()
    copt["path"]["pretrain_model_G"] = summ["checkpoint"]
    copt["datasets"] = {"test": dict(opt["datasets"]["val"], name="Test")}
    outs = {}
    for b in (1, 2):
        copt["name"] = f"ediffsr_cond_unet_test_b{b}"
        res = _run(root, monkeypatch, copt, f"cond_test_{b}.yml", "--test",
                   "--batch", str(b))
        assert res["images"] == 2 and np.isfinite(res["psnr"])
        outs[b] = [np.asarray(load_img(str(root / "results" / copt["name"]
                                           / f"{i}.png")), np.int16)
                   for i in range(2)]
    for a, b in zip(outs[1], outs[2]):
        assert np.abs(a - b).max() <= 1


def test_batched_restore_equals_per_image():
    """Per-image generators: the restore of a batch of 3 (padded to 4)
    equals each image restored alone, within 1e-5 * max|x| (the batched
    convolutions sum in another order)."""
    net = _randomized(ConditionalNAFNet(**NAF), 9)
    sde = tsde.IRSDE(tsde.IRSDEBuffers.create(50, 4))
    rng = np.random.default_rng(10)
    samples = [{"LQ": rng.uniform(0, 1, (1, 8, 8, 3)).astype(np.float32)}
               for _ in range(3)]
    cpu = torch.device("cpu")
    whole, _ = ttrain.restore_batched(net, sde, samples, 4, 5, 0, 2, "sde",
                                      cpu)
    for i, s in enumerate(samples):
        one, _ = ttrain.restore_batched(net, sde, [s], 1, 5, i, 2, "sde", cpu)
        assert np.abs(whole[i] - one[0]).max() <= 1e-5 * np.abs(one).max()


def test_restore_matches_jax():
    """The slice as a whole on one set of weights: mu = upscale(LQ), the
    NAFNet, the T=4 reverse SDE with one injected x_T and noise sequence,
    JAX package against port: within 1e-4 * max|x|."""
    net = _randomized(ConditionalNAFNet(**NAF, up_mode="tconv"), 11)
    params = torch_nafnet_to_flax({k: v.numpy()
                                   for k, v in net.state_dict().items()})
    jnet = JaxNAFNet(**NAF, up_mode="tconv")
    rng = np.random.default_rng(12)
    lq = rng.uniform(0, 1, (2, 6, 6, 3)).astype(np.float32)
    eps = rng.standard_normal((2, 12, 12, 3)).astype(np.float32)
    noise = rng.standard_normal((4, 2, 12, 12, 3)).astype(np.float32)
    js = jsde.IRSDE(jsde.IRSDEBuffers.create(50, 4))
    ts = tsde.IRSDE(tsde.IRSDEBuffers.create(50, 4))

    apply = jax.jit(lambda x, m, t: jnet.apply({"params": params}, x, m, t))
    mu_j = jdeg.upscale(jnp.asarray(lq), 2)
    want = np.asarray(js.reverse_sde(apply, mu_j + js.b.max_sigma * eps,
                                     mu_j, jax.random.PRNGKey(0),
                                     noise_seq=jnp.asarray(noise)))
    mu_t = tdeg.upscale(torch.from_numpy(lq), 2)
    got = ts.reverse_sde(net.eval(), mu_t + ts.b.max_sigma
                         * torch.from_numpy(eps), mu_t,
                         noise_seq=torch.from_numpy(noise)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_train_step_matches_jax():
    """One matching-loss step on the same weights, batch and draws (JAX's
    t and noise injected into the port): the loss within 1e-5 relative
    and every gradient within 1e-4 of the largest |gradient| of JAX's."""
    from fastdiffsr_tpu_torch.models.convert import flax_nafnet_params_to_torch

    net = _randomized(ConditionalNAFNet(**NAF, up_mode="tconv"), 13)
    params = jax.tree_util.tree_map(jnp.asarray, torch_nafnet_to_flax(
        {k: v.numpy() for k, v in net.state_dict().items()}))
    jnet = JaxNAFNet(**NAF, up_mode="tconv")
    rng = np.random.default_rng(14)
    gt = rng.uniform(0, 1, (2, 12, 12, 3)).astype(np.float32)
    lq = rng.uniform(0, 1, (2, 6, 6, 3)).astype(np.float32)
    js = jsde.IRSDE(jsde.IRSDEBuffers.create(50, 4))
    key = jax.random.PRNGKey(15)

    def loss_fn(p):
        mu = jdeg.upscale(jnp.asarray(lq), 2)
        return js.matching_loss(
            lambda x, m, t: jnet.apply({"params": p}, x, m, t),
            jnp.asarray(gt), mu, key)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    k_t, k_n = jax.random.split(key)
    t = np.asarray(jax.random.randint(k_t, (2, 1, 1, 1), 1, 5))
    noise = np.asarray(jax.random.normal(k_n, gt.shape, jnp.float32))

    ts = tsde.IRSDE(tsde.IRSDEBuffers.create(50, 4))
    net.train()
    loss = ts.matching_loss(net, torch.from_numpy(gt),
                            tdeg.upscale(torch.from_numpy(lq), 2),
                            t=torch.from_numpy(np.array(t)).long(),
                            noise=torch.from_numpy(noise))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(
        float(jloss))
    want = flax_nafnet_params_to_torch(
        jax.tree_util.tree_map(np.asarray, jgrads))
    gmax = max(float(v.abs().max()) for v in want.values())
    for name, p in net.named_parameters():
        assert float((p.grad - want[name]).abs().max()) <= 1e-4 * gmax, name


def test_cuda_is_the_default_and_raises_without_a_gpu(env):
    root, opt = env
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["-opt", _write(root, "cuda.yml", opt), "--test"])


def test_opt_file_round_trips_through_the_writer(env):
    root, opt = env
    assert load_yaml(dump_yaml(opt)) == opt
