"""Weights & Biases logger (reference core/wandb_logger.py:3-117).

Counterpart of ``fastdiffsr_tpu/utils/wandb_logger.py``. Where ``wandb``
does not import, the logger warns once and every method is a no-op, so
the CLI flags (``-enable_wandb``, ``-log_wandb_ckpt``, ``-log_eval``,
``-log_infer``) run without it.
"""

from __future__ import annotations

import os
import warnings


class WandbLogger:
    def __init__(self, opt):
        self._wandb = None
        try:
            import wandb
        except ImportError as e:
            warnings.warn(f"wandb unavailable, logging disabled: {e}")
        else:
            self._wandb = wandb
            if wandb.run is None:
                wandb.init(project=(opt.get("wandb") or {}).get(
                    "project", "fastdiffsr_tpu"), config=dict(opt))
        self._eval_table = None

    @property
    def enabled(self) -> bool:
        return self._wandb is not None

    def log_metrics(self, metrics: dict, commit=True):
        if self.enabled:
            self._wandb.log(metrics, commit=commit)

    def log_image(self, key, image):
        if self.enabled:
            self._wandb.log({key: self._wandb.Image(image)})

    def log_checkpoint(self, current_epoch, current_step, ckpt_path=None):
        """Attach the ``I{it}_E{epoch}`` checkpoint directory (or file) to
        a model artifact."""
        if not self.enabled:
            return
        art = self._wandb.Artifact(
            f"model-{self._wandb.run.id}", type="model",
            metadata={"epoch": current_epoch, "iter": current_step})
        if ckpt_path and os.path.isdir(ckpt_path):
            art.add_dir(ckpt_path)
        elif ckpt_path and os.path.isfile(ckpt_path):
            art.add_file(ckpt_path)
        self._wandb.log_artifact(art, aliases=["latest",
                                               f"it{current_step}"])

    def log_eval_data(self, fake_img, psnr, ssim, real_img=None):
        if not self.enabled:
            return
        if self._eval_table is None:
            cols = (["fake", "real", "psnr", "ssim"] if real_img is not None
                    else ["fake", "psnr", "ssim"])
            self._eval_table = self._wandb.Table(columns=cols)
        row = [self._wandb.Image(fake_img)]
        if real_img is not None:
            row.append(self._wandb.Image(real_img))
        self._eval_table.add_data(*row, psnr, ssim)

    def log_eval_table(self, commit=False):
        if self.enabled and self._eval_table is not None:
            self._wandb.log({"eval_data": self._eval_table}, commit=commit)
