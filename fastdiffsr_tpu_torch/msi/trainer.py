"""The shared supervised trainer of the MSI baselines: counterpart of
``fastdiffsr_tpu/msi/trainer.py`` (the reference's five trainers,
model/{swinir,hsenet,transenet,ndsrgan,hat}.py, as one).

- Loss: Charbonnier, eps 1e-6 (swinir.py:846-852); the VGG content term
  only with ``vgg_loss_weight > 0`` (it needs the VGG19 pack,
  ``models/vgg_feat.py``; the reference computes it and never adds it).
- Adam(lr, b1, b2) from the args, eps 1e-8 as optax's.
- ``train``: a loss_log.txt row every ``log_freq`` steps, a validation
  of up to 8 images at each epoch's end on cuDNN's heuristics (training
  times cuDNN's algorithms), its best PSNR logged, one
  ``train/checkpoint.py::save_state`` per epoch (``ckpt/I{it}_E{epoch}``;
  the JAX trainer's "best" save writes that same directory), and the
  per-epoch loss curve. A step's draws (SwinIR's drop-path masks) come
  from ``train.step_generator(1, step)``.
- ``load``: a checkpoint directory of either package (a JAX MSI
  ``state.pkl`` through ``flax_converter(<arch>)`` and its Adam moments
  through ``optax_state_to_torch``), or a parameter file: a reference
  ``.pth`` or ``models.convert --arch <arch>``'s output
  (``load_reference_msi_pth``).
- ``validate`` / ``validate_by_class`` / ``test_single``: batched
  inference at ``eval_batch_size`` with the tail padded by the first
  image (outputs do not depend on the grouping), PSNR, SSIM, ERGAS and
  MSE of the uint8 images, the bicubic baseline's PSNR, and LPIPS on the
  trainer's device where an LPIPS pack is found (``metrics.
  calculate_lpips``); the panels and bar charts where matplotlib imports
  (one warning where it does not).

One device: the JAX trainer's data-parallel mesh is not ported
(ROADMAP.md queue 1 item 2).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import metrics as M
from ..device import resolve_device, set_cudnn_autotuning
from ..train.checkpoint import load_state, save_state
from ..train.state import create_train_state
from ..train.steps import step_generator
from .data import MSIDataLoader, RGBSRDataset, load_rgb

# the converter / reference-layout name of each model class
ARCH_OF = {"SwinIR": "swinir", "HAT": "hat", "HSENet": "hsenet",
           "TransENet": "transenet", "DRRDBNet": "ndsrgan"}


def charbonnier(pred: torch.Tensor, target: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    return torch.sqrt((pred - target) ** 2 + eps * eps).mean()


def to_u8(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, 0, 1) * 255).round().astype(np.uint8)


class SupervisedSRTrainer:
    def __init__(self, model: torch.nn.Module, args, logger=None,
                 device="cuda", seed: int = 0):
        from .logger import MSILogger
        from .main import init_weights

        self.args = args
        self.device = resolve_device(device)
        self.scale = int(getattr(args, "scale_factor", 4))
        self.save_dir = getattr(args, "save_dir", "Result")
        os.makedirs(self.save_dir, exist_ok=True)
        self.logger = logger or logging.getLogger("msi")
        self.arch = ARCH_OF[type(model).__name__]
        self.model_name = getattr(args, "model_name", type(model).__name__)
        self.run_logger = MSILogger(
            self.model_name, os.path.join(self.save_dir, "logs"),
            print_freq=int(getattr(args, "log_freq", 200) or 200))
        self.net = init_weights(model, seed).to(self.device)
        opt = torch.optim.Adam(
            self.net.parameters(), lr=float(getattr(args, "lr", 2e-4)),
            betas=(float(getattr(args, "b1", 0.9)),
                   float(getattr(args, "b2", 0.999))), eps=1e-8)
        self.state = create_train_state(self.net, opt)
        self.vgg_w = float(getattr(args, "vgg_loss_weight", 0.0) or 0.0)
        self.vgg = None
        if self.vgg_w > 0:
            from ..models.vgg_feat import load_default
            # the MSI extractor: features[:12], no input norm
            self.vgg = load_default(feature_layer=11, use_input_norm=False,
                                    device=self.device)
        self.eval_batch = int(getattr(args, "eval_batch_size", 8) or 8)
        self._plots_ok = None

    def train_step(self, lr: torch.Tensor, hr: torch.Tensor,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """One Adam step on a (B,h,w,3) LR / (B,H,W,3) HR batch on the
        device; returns the loss (not synchronised)."""
        self.net.train()
        out = self.net(lr, generator=generator)
        loss = charbonnier(out, hr)
        if self.vgg is not None:
            with torch.no_grad():
                target = self.vgg(hr)
            loss = loss + self.vgg_w * charbonnier(self.vgg(out), target)
        self.state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.state.optimizer.step()
        self.state.step += 1
        return loss.detach()

    # ------------------------------------------------------------------ #

    def train(self, train_dirs, val_dirs=None, num_epochs: int = None,
              batch_size: int = None, max_steps: Optional[int] = None
              ) -> dict:
        """Train; returns {steps, loss (per step), steady_steps_per_s
        (each epoch's first step excluded), validations, best_psnr,
        checkpoint}."""
        args = self.args
        num_epochs = num_epochs or int(getattr(args, "num_epochs", 50))
        batch_size = batch_size or int(getattr(args, "batch_size", 1))
        ds = RGBSRDataset(train_dirs, int(getattr(args, "crop_size", 256)),
                          self.scale, split="train")
        # shuffle=True implies drop_last
        loader = MSIDataLoader(ds, batch_size=batch_size, shuffle=True)
        step = start = int(self.state.step)
        best_psnr, path = -1.0, None
        all_losses, avg_losses, validations = [], [], []
        log_freq = self.run_logger.print_freq
        t_start, busy, timed = time.time(), 0.0, 0
        for epoch in range(num_epochs):
            t0 = time.time()
            losses, t_prev = [], None
            set_cudnn_autotuning(True)
            for batch in loader:
                loss = self.train_step(
                    torch.from_numpy(batch["LR"]).to(self.device),
                    torch.from_numpy(batch["HR"]).to(self.device),
                    step_generator(1, step, self.device))
                losses.append(float(loss))
                step += 1
                # steady rate: step intervals within an epoch (loading
                # the next batch included), each epoch's first excluded
                now = time.time()
                if t_prev is not None:
                    busy, timed = busy + now - t_prev, timed + 1
                t_prev = now
                if step % log_freq == 0:
                    self.run_logger.scalar_summary("loss_G", losses[-1],
                                                   step)
                    self.run_logger.print_format_results("train", {
                        "epoch": epoch + 1, "iters": step,
                        "time": time.time() - t_start,
                        "model": self.model_name,
                        "loss_G": float(np.mean(losses[-log_freq:]))})
                if max_steps and step >= max_steps:
                    break
            all_losses += losses
            avg_losses.append(float(np.mean(losses)))
            self.logger.info(
                f"epoch {epoch + 1}/{num_epochs}: loss "
                f"{np.mean(losses):.4e} ({time.time() - t0:.1f}s)")
            if val_dirs:
                set_cudnn_autotuning(False)
                res = self.validate(val_dirs, max_images=8,
                                    save_images=False)
                validations.append(res)
                if res["psnr"] > best_psnr:
                    best_psnr = res["psnr"]
                    self.logger.info(f"best psnr {best_psnr:.4f} at epoch "
                                     f"{epoch + 1}, step {step}")
            path = self.save(epoch + 1)
            if max_steps and step >= max_steps:
                break
        if self._plots():
            from .plots import plot_loss
            plot_loss(avg_losses, len(avg_losses), save_dir=self.save_dir)
        return {"steps": step - start, "loss": all_losses,
                "steady_steps_per_s": timed / busy if timed else None,
                "validations": validations, "best_psnr": best_psnr,
                "checkpoint": path}

    def save(self, epoch: int) -> str:
        return save_state(self.state, os.path.join(self.save_dir, "ckpt"),
                          it=int(self.state.step), epoch=epoch)

    def load(self, path: str) -> None:
        """A checkpoint directory of either package, or a parameter
        file (a reference ``.pth`` or a converted state dict)."""
        if os.path.isfile(path):
            from ..models.convert import load_reference_msi_pth
            self.net.load_state_dict(load_reference_msi_pth(path, self.arch))
        else:
            load_state(path, self.state, variant=self.arch)

    def _plots(self) -> bool:
        """Whether matplotlib imports (checked once, one warning if not)."""
        if self._plots_ok is None:
            try:
                import matplotlib  # noqa: F401
                self._plots_ok = True
            except ImportError:
                self.logger.warning("matplotlib does not import: the loss "
                                    "curve and the test panels are skipped")
                self._plots_ok = False
        return self._plots_ok

    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _infer(self, lr: np.ndarray) -> np.ndarray:
        self.net.eval()
        return self.net(torch.from_numpy(lr).to(self.device)).cpu().numpy()

    def _infer_batched(self, samples: list) -> np.ndarray:
        """SR of the samples' LR images in one forward at ``eval_batch``:
        the tail is padded with the first image and its rows dropped."""
        lr = np.stack([s["LR"] for s in samples])
        if lr.shape[0] < self.eval_batch:
            lr = np.concatenate([lr, np.repeat(
                lr[:1], self.eval_batch - lr.shape[0], axis=0)])
        return self._infer(lr)[:len(samples)]

    def _eval_one(self, sample: dict, save_dir: Optional[str] = None,
                  idx: int = 0, plot_dir: Optional[str] = None,
                  classname: Optional[str] = None,
                  sr: Optional[np.ndarray] = None) -> dict:
        if sr is None:
            sr = self._infer_batched([sample])[0]
        sr8, hr8, bc8 = to_u8(sr), to_u8(sample["HR"]), to_u8(
            sample["Bicubic"])
        res = {"psnr": M.calculate_psnr(sr8, hr8),
               "ssim": M.calculate_ssim(sr8, hr8),
               "ergas": M.calculate_ergas(sr8, hr8, scale=self.scale),
               "mse": M.calculate_mse(sr8, hr8),
               "psnr_bicubic": M.calculate_psnr(bc8, hr8)}
        lp = M.calculate_lpips(sr8, hr8, device=self.device)
        if lp is not None:
            res["lpips"] = lp
        if save_dir:
            M.save_img(sr8, os.path.join(save_dir, f"{idx}_sr.png"))
        if plot_dir is not None and self._plots():
            from .plots import plot_test_result
            bc_m = {"psnr": res["psnr_bicubic"],
                    "ssim": M.calculate_ssim(bc8, hr8),
                    "ergas": M.calculate_ergas(bc8, hr8, scale=self.scale),
                    "mse": M.calculate_mse(bc8, hr8)}
            plot_test_result([hr8, sample["LR"], bc8, sr8], idx,
                             save_dir=plot_dir, metrics=[None, None, bc_m,
                                                         res],
                             classname=classname)
        return res

    def validate(self, val_dirs, max_images: Optional[int] = None,
                 save_images: bool = True, crop: Optional[int] = None,
                 save_plots: bool = False) -> dict:
        """mfeNew_validate (swinir.py:1288+): mean metrics over the set,
        and ``infer_time``, the forward's seconds per image (the first
        batch's set-up included), plus a val_log.txt row."""
        ds = RGBSRDataset(val_dirs, crop or int(
            getattr(self.args, "test_crop_size", 256)), self.scale,
            split="val")
        save_dir = os.path.join(self.save_dir, "validate") \
            if save_images else None
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
        plot_dir = self.save_dir if save_plots else None
        agg, n, t_infer = {}, 0, 0.0
        total = min(len(ds), max_images) if max_images else len(ds)
        for start in range(0, total, self.eval_batch):
            samples = [ds[i] for i in range(
                start, min(start + self.eval_batch, total))]
            t0 = time.time()
            srs = self._infer_batched(samples)
            t_infer += time.time() - t0
            for j, s in enumerate(samples):
                res = self._eval_one(s, save_dir, start + j,
                                     plot_dir=plot_dir, sr=srs[j])
                for k, v in res.items():
                    agg[k] = agg.get(k, 0.0) + v
                n += 1
        out = {k: v / max(n, 1) for k, v in agg.items()}
        if n:
            out["infer_time"] = t_infer / n
        self.logger.info("validate: " + " ".join(
            f"{k} {v:.4f}" for k, v in out.items()))
        self.run_logger.print_format_results("val", {
            "epoch": 0, "iters": int(self.state.step), "time": 0.0,
            "model": self.model_name, **out})
        for k, v in out.items():
            self.run_logger.scalar_summary(f"val/{k}", v,
                                           int(self.state.step))
        return out

    def validate_by_class(self, val_dirs,
                          max_per_class: Optional[int] = None,
                          save_images: bool = False,
                          save_plots: bool = False) -> dict:
        """mfeNew_validateByClass (swinir.py:1430+): mean metrics per
        class subfolder and their mean (``__overall__``); with
        ``save_plots`` the panels under testplot/<class>/ and per-class
        PSNR/ERGAS bar charts."""
        ds = RGBSRDataset(val_dirs, int(getattr(self.args, "test_crop_size",
                                                256)),
                          self.scale, split="val")
        per_class: dict = {}
        picked = []
        for i in range(len(ds)):
            sample = ds[i]
            slot = per_class.setdefault(sample["class"], {"_n": []})
            if max_per_class and len(slot["_n"]) >= max_per_class:
                continue
            slot["_n"].append(1)
            picked.append((i, sample))
        for start in range(0, len(picked), self.eval_batch):
            chunk = picked[start:start + self.eval_batch]
            srs = self._infer_batched([s for _, s in chunk])
            for (i, sample), sr in zip(chunk, srs):
                cls = sample["class"]
                res = self._eval_one(
                    sample, idx=i,
                    plot_dir=self.save_dir if save_plots else None,
                    classname=cls if save_plots else None, sr=sr)
                slot = per_class[cls]
                for k, v in res.items():
                    slot[k] = slot.get(k, 0.0) + v
        report = {}
        for cls, slot in per_class.items():
            n = len(slot.pop("_n"))
            report[cls] = {k: v / n for k, v in slot.items()}
            self.logger.info(f"class {cls}: " + " ".join(
                f"{k} {v:.4f}" for k, v in report[cls].items()))
        overall = {}
        for cls_res in report.values():
            for k, v in cls_res.items():
                overall[k] = overall.get(k, 0.0) + v / len(report)
        report["__overall__"] = overall
        self.logger.info("overall: " + " ".join(
            f"{k} {v:.4f}" for k, v in overall.items()))
        if save_plots and len(report) > 1 and self._plots():
            from .plots import plot_class_report
            for metric in ("psnr", "ergas"):
                plot_class_report(report, metric, os.path.join(
                    self.save_dir, "testplot", f"by_class_{metric}.png"))
        return report

    def test_single(self, img_path: str, out_path: str) -> str:
        """dm_test_single (swinir.py:1648+): SR of one image file, at
        batch 1 (the JAX trainer pads it to ``eval_batch`` to reuse its
        compiled program; here that would only multiply the work, which
        HSENet's (H·W)^2 non-local maps make large at real sizes)."""
        lr = load_rgb(img_path).astype(np.float32) / 255.0
        M.save_img(to_u8(self._infer(lr[None])[0]), out_path)
        return out_path
