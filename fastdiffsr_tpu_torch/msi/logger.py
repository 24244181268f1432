"""MSI run logger: counterpart of ``fastdiffsr_tpu/msi/logger.py``
(reference MSI_SR_model/utils/logger.py).

The reference trainers build a TensorFlow-summary ``Logger`` writing
scalar/image summaries plus two formatted text logs under
``<save_dir>/logs`` — ``loss_log.txt`` (one row per print_freq train
steps, written by ``print_format_results('train', ...)``,
utils/logger.py:113-143) and ``val_log.txt`` (one row per validation) —
and tee stdout into ``print_log.txt`` via ``PrintLogger``
(utils/logger.py:17-27, swinir.py:884).

Here the summaries ride tensorboardX (same event-file format, no
TensorFlow dependency, gated no-op when unavailable), the text logs keep
the reference's exact row format, and the stdout tee is replaced by the
package's standard logging FileHandler (utils/logging.setup_logger) —
the python-native equivalent of PrintLogger.
"""

from __future__ import annotations

import os
import time

from ..utils.logging import get_logger, make_tb_writer


def get_timestamp() -> str:
    """utils/utils.py get_timestamp equivalent."""
    return time.strftime("%y%m%d-%H%M%S")


class MSILogger:
    """Reference ``Logger`` interface: scalar_summary / image_summary /
    print_format_results (utils/logger.py:29-143)."""

    def __init__(self, name: str, log_dir: str, print_freq: int = 200):
        self.exp_name = name
        self.print_freq = int(print_freq)
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.writer = make_tb_writer(log_dir)  # None without tensorboardX
        self._log = get_logger("msi")
        self.loss_log_path = os.path.join(log_dir, "loss_log.txt")
        self.val_log_path = os.path.join(log_dir, "val_log.txt")
        with open(self.loss_log_path, "a") as f:
            f.write(f"=============== Time: {get_timestamp()} "
                    "=============\n")
            f.write("================ Training Losses "
                    "================\n")
        with open(self.val_log_path, "a") as f:
            f.write(f"================ Time: {get_timestamp()} "
                    "===============\n")
            f.write("================ Validation Results "
                    "================\n")

    def scalar_summary(self, tag: str, value, step: int) -> None:
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), int(step))
            self.writer.flush()

    def image_summary(self, tag: str, images, step: int) -> None:
        """Log a list of HWC uint8/float arrays."""
        if self.writer is None:
            return
        for i, img in enumerate(images):
            self.writer.add_image(f"{tag}/{i}", img, int(step),
                                  dataformats="HWC")
        self.writer.flush()

    def print_format_results(self, mode: str, rlt: dict) -> str:
        """Format one train/val row exactly like the reference
        (utils/logger.py:113-143), print it through the 'msi' logger,
        and append it to loss_log.txt / val_log.txt."""
        rlt = dict(rlt)
        epoch = rlt.pop("epoch")
        iters = rlt.pop("iters")
        t = rlt.pop("time")
        model = rlt.pop("model")
        if "lr" in rlt:
            lr = rlt.pop("lr")
            message = (f"<epoch:{epoch:3d}, iter:{iters:8,d}, "
                       f"time:{t:.2f}, lr:{lr:.1e}> ")
        else:
            message = (f"<epoch:{epoch:3d}, iter:{iters:8,d}, "
                       f"time:{t:.2f}> ")
        message += f"dataset: {model} "
        fmt = "{:s}: {:.2e} " if mode == "train" else "{:s}: {:.4e} "
        for label, value in rlt.items():
            message += fmt.format(label, value)
        self._log.info(message)
        path = (self.loss_log_path if mode == "train"
                else self.val_log_path)
        with open(path, "a") as f:
            f.write(message + "\n")
        return message
