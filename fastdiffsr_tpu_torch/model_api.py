"""Reference-compatible model API layer.

Counterpart of ``fastdiffsr_tpu/model_api.py``: the reference's trainer
wrapper class ``DDPM`` with its method surface (model/model.py:11-166,
model/base_model.py, the factory model/__init__.py:5-9 and
networks.define_G:82-119), on the port's train and sample steps:

    create_model(opt, device="cuda") -> DDPM
      .feed_data(data)           .optimize_parameters()
      .test(continous=False)     .sample(batch_size, continous)
      .set_new_noise_schedule(schedule_opt, schedule_phase)
      .get_current_log()         .get_current_visuals(...)
      .save_network(epoch, iter) .load_network()
      .print_network()           .count_parameters()

Training is ``train.make_train_step`` (K1 under every GroupNorm -> Swish
on CUDA); ``test`` samples with ``train.make_sample_fn`` on the forward
the val CLI runs (``cli.infer.resolve_fused``: the fused forward, K3 and
K2, for FastDiffSR). Checkpoints are ``train.checkpoint``'s
``I{iter}_E{epoch}`` directories, the ones ``cli/sr_mfe.py`` writes and
resumes.

The device is explicit (``device="cuda"`` by default). Randomness comes
from generators seeded from the opt, not from global state: the initial
parameters and train step k's draws from ``opt['seed']`` (0 when unset;
``train.step_generator(seed, k)``, as ``cli/sr_mfe.py`` draws them),
and ``test``/``sample``'s noise from the per-image generators of
``train.pad_batch_with_keys`` under ``opt['val_seed']`` (else the seed),
images indexed from 0 in each call, as the val CLI draws them. So two
calls on the same batch give the same images (JAX splits its key on
every call), and ``test(continous=True)``'s last frame is ``test()``.
"""

from __future__ import annotations

import dataclasses
import logging
from collections import OrderedDict

import numpy as np
import torch


def define_G(opt, dtype=torch.float32, device="cuda", seed: int = 0):
    """(diffusion spec, denoiser UNet) of a reference-schema opt
    (networks.define_G parity: the model.unet block of
    ``model.which_model_G``), the UNet with seeded initial parameters."""
    from .cli.infer import build_unet
    from .diffusion import DiffusionSpec

    model_opt = opt["model"]
    spec = DiffusionSpec.for_variant(model_opt["which_model_G"])
    return spec, build_unet(model_opt, dtype=dtype, device=device,
                            seed=seed)


def create_model(opt, device="cuda") -> "DDPM":
    """model/__init__.py:5-9 parity."""
    return DDPM(opt, device=device)


class DDPM:
    def __init__(self, opt, device="cuda"):
        from .device import resolve_device
        from .train import create_train_state, make_optimizer, \
            make_train_step

        self.opt = opt
        self.device = resolve_device(device)
        self.seed = int(opt.get("seed") or 0)
        self.sample_seed = (self.seed if opt.get("val_seed") is None
                            else int(opt["val_seed"]))
        self.variant = opt["model"]["which_model_G"]
        self.spec, self.net = define_G(opt, device=self.device,
                                       seed=self.seed)
        sched = opt["model"]["beta_schedule"]
        self._schedules = {phase: sched[phase] for phase in ("train", "val")
                           if sched.get(phase)}
        self.engine = self._engine(self._schedules.get("train")
                                   or next(iter(self._schedules.values())))

        train_opt = opt.get("train") or {}
        self.state = create_train_state(
            self.net, make_optimizer(self.net.parameters(),
                                     train_opt.get("optimizer") or {}))
        ema_cfg = train_opt.get("ema_scheduler") or {}
        self._train_step = make_train_step(
            self.engine, ema_decay=float(ema_cfg.get("ema_decay", 0.9999)),
            ema_start=int(ema_cfg.get("step_start_ema", 5000)))
        self._eval_net = None
        self.data = None
        self.SR = None
        self.log_dict = OrderedDict()
        self.begin_step = 0
        self.begin_epoch = 0
        self.load_network()

    def _engine(self, schedule_opt):
        from .diffusion import DiffusionEngine, ScheduleBuffers
        return DiffusionEngine(self.spec, ScheduleBuffers.create(
            schedule_opt, device=self.device))

    def _denoiser(self, params, fused: bool):
        """denoise(x_in, level) of ``params`` on an eval-mode copy of the
        net (no dropout), on the fused or the plain forward."""
        from .cli.infer import build_unet, make_denoiser
        if self._eval_net is None:
            self._eval_net = build_unet(self.opt["model"],
                                        device=self.device, seed=self.seed)
        self._eval_net.load_state_dict(params)
        return make_denoiser(self._eval_net, fused, torch.float32)

    def _generators(self, batch: int):
        """Image i's generator of ``pad_batch_with_keys`` under the
        sampling seed, i = 0 ... batch-1."""
        from .train.steps import image_generator
        return [image_generator(self.sample_seed, i, self.device)
                for i in range(batch)]

    # ------------------------------------------------------------------ #

    def feed_data(self, data: dict):
        """dict of numpy / torch NHWC arrays {'HR', 'SR', ('LR',
        'Index')}; floating arrays become float32 on the device."""
        self.data = {}
        for k, v in data.items():
            if isinstance(v, (str, list)):
                continue
            t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                else v)
            if t.is_floating_point():
                t = t.float()
            self.data[k] = t.to(self.device)

    def optimize_parameters(self):
        from .train import step_generator
        gen = step_generator(self.seed, self.state.step, self.device)
        self.state, metrics = self._train_step(
            self.state, {k: self.data[k] for k in ("HR", "SR")}, gen)
        self.log_dict["l_pix"] = float(metrics["l_pix"])

    def set_new_noise_schedule(self, schedule_opt=None,
                               schedule_phase: str = "train"):
        """Sample with the ``schedule_phase`` schedule from now on (its
        opt replaced by ``schedule_opt`` when given); training keeps the
        train schedule."""
        if schedule_opt is not None:
            self._schedules[schedule_phase] = schedule_opt
        self.engine = self._engine(self._schedules[schedule_phase])

    def test(self, continous: bool = False, use_ema: bool = False):
        """Super-resolve ``data['SR']`` (the bicubic batch); with
        ``continous`` the result is the (T,B,H,W,C) trajectory (ancestral
        sampler)."""
        from .cli.infer import resolve_fused
        from .train import make_sample_fn
        denoise = self._denoiser(self.state.ema_or_params(use_ema),
                                 resolve_fused(self.variant, None))
        cond = self.data["SR"]
        out = make_sample_fn(self.engine, denoise,
                             return_trajectory=continous)(
            cond, self._generators(cond.shape[0]))
        self.SR = out[1] if continous else out
        return self.SR

    def sample(self, batch_size: int = 1, continous: bool = False):
        """Unconditional sampling of ``batch_size`` images with the live
        parameters. The unconditional path returns the raw sampled tensor
        (no res2img), as the reference does (model.py:70-77,
        diffusion.py:196-203)."""
        d = self.opt["model"]["diffusion"]
        r, c = int(d["image_size"]), int(d["channels"])
        from .diffusion import DiffusionEngine
        eng = DiffusionEngine(
            dataclasses.replace(self.engine.spec, conditional=False),
            self.engine.buffers)
        out = eng.sample(self._denoiser(self.state.ema_or_params(False),
                                        False),
                         None, self._generators(batch_size),
                         shape=(batch_size, r, r, c),
                         return_trajectory=continous)
        self.SR = out[1] if continous else out
        return self.SR

    # ------------------------------------------------------------------ #

    def get_current_log(self):
        return self.log_dict

    def get_current_visuals(self, need_LR: bool = True,
                            sample: bool = False):
        def host(t):
            return t.detach().cpu().numpy()
        out = OrderedDict()
        if sample:
            out["SAM"] = host(self.SR)
            return out
        out["SR"] = host(self.SR) if self.SR is not None else None
        if self.data:
            out["INF"] = host(self.data["SR"])
            out["HR"] = host(self.data["HR"])
            if need_LR and "LR" in self.data:
                out["LR"] = host(self.data["LR"])
        return out

    def count_parameters(self) -> int:
        from .utils.profiling import param_count
        return param_count(self.state.net)

    def print_network(self):
        logging.getLogger("base").info(
            f"Network G [{type(self.net).__name__}] with "
            f"{self.count_parameters():,} params")

    def save_network(self, epoch: int, iter_step: int) -> str:
        """Write ``path.checkpoint/I{iter_step}_E{epoch}`` and return it."""
        from .train.checkpoint import save_state
        self.state.epoch = int(epoch)
        return save_state(self.state, self.opt["path"]["checkpoint"],
                          it=iter_step, epoch=epoch)

    def load_network(self):
        """Resume from ``path.resume_state`` (a checkpoint directory of
        either package) when it is set."""
        from .train.checkpoint import load_state
        path = (self.opt.get("path") or {}).get("resume_state")
        if path:
            load_state(path, self.state, self.variant)
            self.begin_step = int(self.state.step)
            self.begin_epoch = int(self.state.epoch)
