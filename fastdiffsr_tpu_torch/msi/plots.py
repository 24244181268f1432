"""MSI reporting/plot suites, numpy HWC [0,1] images: counterpart of
``fastdiffsr_tpu/msi/plots.py``. matplotlib is imported when a plot is
made; the trainer checks once that it imports and skips the plots with
one warning where it does not (the card's machine has none).

Parity targets in MSI_SR_model/utils/utils.py:
- ``plot_loss`` (:54) — per-epoch loss curve png.
- ``mfe_plot_test_result2`` (:251) — N-panel HR | LR | Bicubic | SR figure
  with per-panel MSE/PSNR/SSIM/ERGAS/LPIPS captions, saved under
  ``plot/Train_result_{n}.png`` (training) or
  ``testplot/Test_result_{n}.png``.
- ``plot_test_result_by_class`` (:572) — same panel, saved under the
  scene-class subdirectory.

The reference passes CHW torch tensors; these take HWC numpy float [0,1]
(our pipeline's native format) — layout conversion is the only delta.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_loss(avg_losses: Sequence[float], num_epochs: int,
              save_dir: str = "", label: str = "loss",
              show: bool = False) -> str:
    """Loss curve over epochs (utils.py:54-83)."""
    plt = _plt()
    fig, ax = plt.subplots()
    ax.set_xlim(0, num_epochs)
    tmp = [float(v) for v in avg_losses]
    ax.plot(range(1, len(tmp) + 1), tmp, label=label)
    ax.set_xlabel("# of Epochs")
    ax.set_ylabel("Loss values")
    ax.legend()
    os.makedirs(save_dir or ".", exist_ok=True)
    path = os.path.join(save_dir, f"Loss_values_epoch_{num_epochs}.png")
    fig.savefig(path)
    plt.close(fig)
    return path


_PANEL_NAMES = ("HR image", "LR image", "Bicubic", "SR image")


def _caption(name: str, m: Optional[dict]) -> str:
    if not m:
        return name
    parts = [name]
    for key, fmt in (("mse", "MSE: %.2f"), ("psnr", "PSNR: %.2fdB"),
                     ("ssim", "SSIM: %.4f"), ("ergas", "ERGAS: %.2f"),
                     ("lpips", "LPIPS: %.4f")):
        if m.get(key) is not None:
            parts.append(fmt % m[key])
    return "\n".join(parts)


def plot_test_result(imgs: Sequence, img_num: int, save_dir: str = "",
                     metrics: Optional[Sequence[Optional[dict]]] = None,
                     is_training: bool = False, show_label: bool = True,
                     names: Sequence[str] = _PANEL_NAMES,
                     classname: Optional[str] = None) -> str:
    """N-panel comparison figure with metric captions
    (mfe_plot_test_result2, utils.py:251-313; by-class variant :572).

    imgs: HWC float [0,1] (or uint8) arrays, typically
    (hr, lr, bicubic, sr); metrics: per-panel dicts with any of
    mse/psnr/ssim/ergas/lpips (None for unlabeled panels).
    """
    import numpy as np

    plt = _plt()
    n = len(imgs)
    metrics = metrics or [None] * n
    if show_label:
        h, w = 3.6, 3.6 * n
    else:
        h = imgs[0].shape[0] / 100
        w = imgs[0].shape[1] * n / 100
    fig, axes = plt.subplots(1, n, figsize=(w, h))
    if n == 1:
        axes = [axes]
    for ax, img, name, m in zip(np.ravel(axes), imgs, names, metrics):
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        ax.imshow(arr, aspect="equal")
        ax.set_xticks([]), ax.set_yticks([])
        if show_label:
            ax.set_xlabel(_caption(name, m), fontsize=8)
        else:
            ax.axis("off")
    if show_label:
        fig.tight_layout()
    else:
        fig.subplots_adjust(wspace=0, hspace=0, left=0, right=1,
                            top=1, bottom=0)

    if classname is not None:
        result_dir = os.path.join(save_dir, "testplot", classname)
        save_fn = os.path.join(result_dir, f"Test_result_{img_num}.png")
    elif is_training:
        result_dir = os.path.join(save_dir, "plot")
        save_fn = os.path.join(result_dir, f"Train_result_{img_num}.png")
    else:
        result_dir = os.path.join(save_dir, "testplot")
        save_fn = os.path.join(result_dir, f"Test_result_{img_num}.png")
    os.makedirs(result_dir, exist_ok=True)
    fig.savefig(save_fn)
    plt.close(fig)
    return save_fn


def plot_class_report(report: dict, metric: str, path: str) -> str:
    """Per-class metric bar chart from validate_by_class output (the
    reporting role of the reference's compare_* suites)."""
    plt = _plt()
    classes = [c for c in report if c != "__overall__"
               and report[c].get(metric) is not None]
    vals = [report[c][metric] for c in classes]
    fig, ax = plt.subplots(figsize=(max(4, 0.6 * len(classes)), 4))
    ax.bar(range(len(classes)), vals)
    ax.set_xticks(range(len(classes)))
    ax.set_xticklabels(classes, rotation=45, ha="right", fontsize=8)
    ax.set_ylabel(metric)
    overall = (report.get("__overall__") or {}).get(metric)
    if overall is not None:
        ax.axhline(overall, color="k", linestyle="--", linewidth=1,
                   label=f"overall {overall:.3f}")
        ax.legend(fontsize=8)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)
    return path
