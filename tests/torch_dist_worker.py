"""One rank of the port's multi-process tests (``tests/test_torch_dist_*.py``).

    python tests/torch_dist_worker.py <case> <out_dir> [args...]

runs with torchrun's variables set (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and gloo on the CPU, and
writes this rank's result to ``<out_dir>/rank{RANK}.json`` (arrays to
``rank{RANK}.npz``). :func:`launch` starts the W processes of one run,
each with its own timeout, so a hang fails the test instead of eating the
suite's time. The cases that test a module (``train_step``, ``sample``,
``supervised``, ``gan``) are plain functions that the tests also call in
their own process, without a process group, as the one-rank reference;
``chain`` holds two arms in one process.
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys
import types

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY_UNET = {"in_channel": 6, "out_channel": 3, "inner_channel": 8,
             "norm_groups": 4, "channel_multiplier": [1, 2],
             "res_blocks": 1, "dropout": 0.0}
SCHEDULE = {"schedule": "linear_cosine", "n_timestep": 4,
            "linear_start": 1e-6, "linear_end": 1e-2}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(case: str, world: int, out_dir, args=(), timeout: float = 120,
           cwd=None) -> list:
    """Run ``case`` as ``world`` gloo ranks on 127.0.0.1; returns each
    rank's (json dict, npz dict)."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   JAX_PLATFORMS="cpu")
        procs.append(subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()), case,
             str(out_dir), *map(str, args)],
            env=env, cwd=cwd, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{case}: a rank of {world} ran past "
                             f"{timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, (f"{case}: rank {r} of {world} exited "
                                   f"{p.returncode}:\n{log[-6000:]}")
    out = []
    for r in range(world):
        res = json.loads((out_dir / f"rank{r}.json").read_text())
        npz = out_dir / f"rank{r}.npz"
        out.append((res, dict(np.load(npz)) if npz.exists() else {}))
    return out


def _join_cpu():
    from fastdiffsr_tpu_torch.parallel import initialize_from_env
    return initialize_from_env("cpu")


def train_step_case(steps: int = 3, batch: int = 4, cached: bool = False,
                    size=(16, 16)):
    """``steps`` Adam + EMA steps of the tiny FastDiffSR UNet on a global
    batch of ``size`` maps made from seed 0 (this rank's rows of it; or,
    with ``cached``, a device-resident set of 6 tiles): the logged losses
    and the parameters and EMA parameters after the last step."""
    import torch

    from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine,
                                                DiffusionSpec,
                                                ScheduleBuffers)
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.parallel import rank, rank_rows, world_size
    from fastdiffsr_tpu_torch.train import (create_train_state,
                                            make_cached_train_step,
                                            make_optimizer, make_train_step,
                                            step_generator)

    engine = DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                             ScheduleBuffers.create(SCHEDULE, device="cpu"))
    net = unet_from_config(TINY_UNET, device="cpu", seed=0)
    state = create_train_state(net, make_optimizer(net.parameters(),
                                                   {"lr": 2e-3}))
    ema = dict(ema_decay=0.5, ema_start=1)
    rng = np.random.default_rng(0)
    losses = []
    if cached:
        data = {k: torch.from_numpy(rng.integers(0, 256, (6, *size, 3),
                                                 dtype=np.uint8))
                for k in ("HR", "SR")}
        step = make_cached_train_step(engine, batch, **ema)
        for _ in range(steps):
            state, m = step(state, data, 7)
            losses.append(float(m["l_pix"]))
    else:
        rows = rank_rows(batch, rank(), world_size())
        gbatch = {k: torch.from_numpy(rng.uniform(
            -1, 1, (batch, *size, 3)).astype(np.float32))
            for k in ("HR", "SR")}
        local = {k: v[rows] for k, v in gbatch.items()}
        step = make_train_step(engine, **ema)
        for i in range(steps):
            state, m = step(state, local, step_generator(7, i, "cpu"))
            losses.append(float(m["l_pix"]))
    arrays = {f"p/{k}": v.detach().numpy()
              for k, v in net.state_dict().items()}
    arrays.update({f"ema/{k}": v.numpy() for k, v in
                   state.ema_params.items()})
    return {"l_pix": losses}, arrays


def chain_case(chain: int = 2, calls: int = 2, batch: int = 4):
    """Two states of the tiny UNet with dropout 0.2 from one seed, each
    DDP-wrapped under the group: one takes ``calls`` calls of the chained
    step's captured region run eagerly (``_CapturedSteps.run_eagerly``:
    the bare net, ``parallel.average_gradients``, per-sub-step
    generators seeded by ``replay_seeds``), the other ``chain * calls``
    unchained DDP steps; both on a device-resident set of 6 tiles with
    the EMA starting inside the second call. Returns both runs' losses
    and gradient norms, and their parameters and EMA."""
    import torch

    from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine,
                                                DiffusionSpec,
                                                ScheduleBuffers)
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.train import (create_train_state,
                                            make_cached_train_step,
                                            make_optimizer)
    from fastdiffsr_tpu_torch.train.steps import _CapturedSteps

    engine = DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                             ScheduleBuffers.create(SCHEDULE, device="cpu"))
    rng = np.random.default_rng(0)
    data = {k: torch.from_numpy(rng.integers(0, 256, (6, 16, 16, 3),
                                             dtype=np.uint8))
            for k in ("HR", "SR")}
    ema = dict(ema_decay=0.5, ema_start=chain + 1)
    res, arrays = {}, {}
    for arm in ("chained", "unchained"):
        net = unet_from_config({**TINY_UNET, "dropout": 0.2}, device="cpu",
                               seed=0)
        state = create_train_state(net, make_optimizer(net.parameters(),
                                                       {"lr": 2e-3}))
        if arm == "chained":
            region = _CapturedSteps(engine, batch, chain, **ema)
            ms = [region.run_eagerly(state, data, 7) for _ in range(calls)]
        else:
            step = make_cached_train_step(engine, batch, **ema)
            ms = [step(state, data, 7)[1] for _ in range(chain * calls)]
            ms = [{k: v.reshape(1) for k, v in m.items()} for m in ms]
        for k in ("l_pix", "grad_norm"):
            res[f"{arm}/{k}"] = torch.cat([m[k] for m in ms]).tolist()
        res[f"{arm}/step"] = state.step
        arrays.update({f"{arm}/p/{k}": v.detach().numpy()
                       for k, v in net.state_dict().items()})
        arrays.update({f"{arm}/ema/{k}": v.numpy()
                       for k, v in state.ema_params.items()})
    return res, arrays


def sample_case(batch: int = 4, height: int = 16, width: int = 16,
                fused_too: bool = True):
    """The tiny UNet's samples of a batch of ``batch`` conditions of
    ``height`` x ``width`` from seed 1 with the ancestral, DDIM (eta 0.5:
    a draw per step) and DPM-Solver++ samplers, this rank's
    ``sample_rows`` of each, with rank 0's weights, on the plain forward
    and (``fused_too``) the fused one: arrays ``<sampler>`` of those rows
    and ``rows`` (start, stop). The ranks that sample share the int8
    activation scale, as ``cli.infer -dist`` has them do."""
    import torch

    from fastdiffsr_tpu_torch.cli.infer import make_denoiser
    from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine,
                                                DiffusionSpec,
                                                ScheduleBuffers)
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.ops.quant import shared_activation_scale
    from fastdiffsr_tpu_torch.parallel import (broadcast_from_main, rank,
                                               sample_group, sample_rows,
                                               world_size)
    from fastdiffsr_tpu_torch.train import make_sample_fn, pad_batch_with_keys

    engine = DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                             ScheduleBuffers.create(SCHEDULE, device="cpu"))
    # every rank but 0 starts from other weights: the broadcast makes
    # them rank 0's
    net = broadcast_from_main(unet_from_config(TINY_UNET, device="cpu",
                                               seed=3 + rank()))
    cond = np.random.default_rng(1).uniform(
        -1, 1, (batch, height, width, 3)).astype(np.float32)
    rows = sample_rows(batch, rank(), world_size())
    group = sample_group(batch)
    arrays = {"rows": np.array([rows.start, rows.stop])}
    for fused in (False, True) if fused_too else (False,):
        denoise = make_denoiser(net, fused, torch.float32)
        for sampler, kw in (("ancestral", {}),
                            ("ddim", {"ddim_steps": 3, "ddim_eta": 0.5}),
                            ("dpm", {"ddim_steps": 3})):
            x, gens = pad_batch_with_keys(cond, batch, 5, 0, device="cpu")
            fn = make_sample_fn(engine, denoise, sampler=sampler, **kw)
            with shared_activation_scale(group):
                out = (fn(x[rows], gens[rows]).numpy()
                       if rows.stop > rows.start
                       else np.zeros((0, height, width, 3), np.float32))
            arrays[f"{sampler}{'_fused' if fused else ''}"] = out
    return {}, arrays


def quant_conv_case(batch: int = 4):
    """One W8A8 conv (``ops.quant.quant_conv3``) of this rank's rows of a
    seeded (batch, 10, 12, 32) map in each scale mode, the ranks sharing
    the dynamic activation scale: per mode (``<mode>/``) the output rows
    and the gradients of sum(y * G) with respect to the rows, the weight
    and the bias (this rank's parts: the weight's and bias's sum over the
    ranks is the whole batch's). The map's largest |h| sits twice in rank
    1's rows and once in rank 0's, so the gradient splits over ranks."""
    import torch

    from fastdiffsr_tpu_torch.ops.quant import (quant_conv3,
                                                shared_activation_scale)
    from fastdiffsr_tpu_torch.parallel import (rank, rank_rows, sample_group,
                                               world_size)

    rng = np.random.default_rng(11)
    h = rng.standard_normal((batch, 10, 12, 32)).astype(np.float32)
    m = np.abs(h).max() + 1.0
    h[0, 1, 2, 3], h[-1, 4, 5, 6], h[-1, 0, 0, 0] = -m, m, m
    w = (rng.standard_normal((16, 32, 3, 3)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(16) * 0.1).astype(np.float32)
    g = rng.standard_normal((batch, 10, 12, 16)).astype(np.float32)
    rows = rank_rows(batch, rank(), world_size())
    group = sample_group(batch)
    out = {}
    for mode in ("w8a8", "w8a8s"):
        leaves = [torch.from_numpy(h[rows]).requires_grad_(),
                  torch.from_numpy(w).requires_grad_(),
                  torch.from_numpy(b).requires_grad_()]
        with shared_activation_scale(group):
            y = quant_conv3(*leaves, torch.float32,
                            static_scale=mode == "w8a8s")
        grads = torch.autograd.grad((y * torch.from_numpy(g[rows])).sum(),
                                    leaves, materialize_grads=True)
        out[f"{mode}/y"] = y.detach().numpy()
        out.update({f"{mode}/{k}": t.numpy()
                    for k, t in zip(("gh", "gw", "gb"), grads)})
    return {}, out


def _msi_args(crop: int, **kw):
    base = dict(scale_factor=4, crop_size=crop, test_crop_size=crop,
                lr=1e-3, b1=0.9, b2=0.999, log_freq=1, tiny=True,
                eval_batch_size=4, model_name="SwinIR")
    base.update(kw)
    return types.SimpleNamespace(**base)


def supervised_case(data_dir: str, save_dir: str, batch: int = 4):
    """``SupervisedSRTrainer`` on a tiny SwinIR with drop-path on (rate
    0.5), one epoch at global batch ``batch`` with the epoch-end
    validation, then a sharded ``validate`` and ``validate_by_class``:
    losses, the validations, the checkpoint path and the parameters."""
    import torch

    from fastdiffsr_tpu_torch.msi.swinir import SwinIR
    from fastdiffsr_tpu_torch.msi.trainer import SupervisedSRTrainer

    args = _msi_args(16, save_dir=save_dir)
    model = SwinIR(upscale=4, embed_dim=12, depths=(2,), num_heads=(2,),
                   window_size=4, mlp_ratio=2.0, drop_path_rate=0.5)
    tr = SupervisedSRTrainer(model, args, device="cpu", seed=0)
    summ = tr.train([os.path.join(data_dir, "train")],
                    val_dirs=[os.path.join(data_dir, "test")], num_epochs=1,
                    batch_size=batch)
    sharded = torch.distributed.is_initialized()
    val = tr.validate([os.path.join(data_dir, "test")], save_images=True,
                      shard=sharded)
    by_class = tr.validate_by_class([os.path.join(data_dir, "test")],
                                    shard=sharded)
    val.pop("infer_time", None)
    res = {"loss": summ["loss"], "steps": summ["steps"],
           "validations": summ["validations"],
           "checkpoint": summ["checkpoint"], "validate": val,
           "by_class": by_class}
    return res, {k: v.numpy() for k, v in tr.net.state_dict().items()}


def gan_case(data_dir: str, steps: int = 2, batch: int = 4):
    """A tiny ``GANTrainer``'s losses after ``steps`` steps at global
    batch ``batch`` (crop 32: the discriminator's four 4x4 convs need
    it) and both networks' parameters."""
    from fastdiffsr_tpu_torch.msi.ndsrgan import GANTrainer

    args = types.SimpleNamespace(scale_factor=4, g_nf=8, g_nc=4, g_blocks=1,
                                 crop_size=32, lr=1e-3, weight_gan=0.1)
    gan = GANTrainer(args, device="cpu", seed=0)
    m = gan.train([os.path.join(data_dir, "train32")], num_epochs=1,
                  batch_size=batch, max_steps=steps)
    m.pop("steps_per_s")
    arrays = {f"g/{k}": v.numpy() for k, v in gan.g.state_dict().items()}
    arrays.update({f"d/{k}": v.numpy() for k, v in gan.d.state_dict().items()})
    return m, arrays


def _cli(module: str, argv):
    import importlib
    out = importlib.import_module(module).main(list(argv))
    return json.loads(json.dumps(out, default=lambda o: None)), {}


CASES = {
    "train_step": lambda a: (_join_cpu(), train_step_case())[1],
    "train_step_cached": lambda a: (_join_cpu(),
                                    train_step_case(cached=True))[1],
    "chain": lambda a: (_join_cpu(), chain_case())[1],
    "sample": lambda a: (_join_cpu(), sample_case(*map(int, a)))[1],
    "quant_conv": lambda a: (_join_cpu(), quant_conv_case())[1],
    # the int8 UNet: FASTDIFFSR_TPU_QUANT is set in the ranks' environment
    "quant_train_step": lambda a: (_join_cpu(), train_step_case(
        steps=2, batch=4, size=tuple(map(int, a))))[1],
    "supervised": lambda a: (_join_cpu(), supervised_case(*a))[1],
    "gan": lambda a: (_join_cpu(), gan_case(*a))[1],
    "sr_mfe": lambda a: _cli("fastdiffsr_tpu_torch.cli.sr_mfe", a),
    "infer": lambda a: _cli("fastdiffsr_tpu_torch.cli.infer", a),
    "ediffsr": lambda a: _cli("fastdiffsr_tpu_torch.ediffsr.train", a),
    "msi": lambda a: _cli("fastdiffsr_tpu_torch.msi.main", a),
}


def main() -> None:
    sys.path.insert(0, str(REPO))
    import torch
    torch.set_num_threads(1)
    from fastdiffsr_tpu_torch.parallel import rank, shutdown

    case, out_dir, *args = sys.argv[1:]
    res, arrays = CASES[case](args)
    out = pathlib.Path(out_dir)
    (out / f"rank{rank()}.json").write_text(json.dumps(res))
    if arrays:
        np.savez(out / f"rank{rank()}.npz", **arrays)
    shutdown()


if __name__ == "__main__":
    main()
