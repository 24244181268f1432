"""Dual file/console loggers (reference core/logger.py:128-141): a 'base'
train logger and a 'val' logger, each writing ``{phase}.log`` under the run
dir, plus optional TensorBoard via tensorboardX.

Counterpart of ``fastdiffsr_tpu/utils/logging.py``. In a process group
(``-dist``) only rank 0 writes logs and TensorBoard events; the other
ranks' loggers pass warnings and errors to stderr and drop the rest."""

from __future__ import annotations

import logging
import os


def setup_logger(logger_name: str, root: str, phase: str,
                 level=logging.INFO, screen: bool = False) -> logging.Logger:
    from ..parallel import is_main
    logger = logging.getLogger(logger_name)
    if not is_main():
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
        logger.setLevel(logging.WARNING)
        return logger
    target = os.path.abspath(os.path.join(root, f"{phase}.log"))
    if any(isinstance(h, logging.FileHandler)
           and getattr(h, "baseFilename", None) == target
           for h in logger.handlers):
        return logger
    # a second run dir in the same process (val after train, notebooks,
    # tests) must not keep logging into the previous run's file
    for h in list(logger.handlers):
        logger.removeHandler(h)
        if isinstance(h, logging.FileHandler):
            h.close()
    formatter = logging.Formatter(
        "%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
        datefmt="%y-%m-%d %H:%M:%S")
    os.makedirs(root, exist_ok=True)
    # divergence from the reference (core/logger.py:134 uses mode='w'):
    # resuming into an existing experiment dir must not clobber the
    # previous run's history — append, with a separator per run
    path = os.path.join(root, f"{phase}.log")
    existed = os.path.exists(path) and os.path.getsize(path) > 0
    fh = logging.FileHandler(path, mode="a")
    fh.setFormatter(formatter)
    if existed:
        fh.stream.write("\n# ---- new run ----\n")
    logger.setLevel(level)
    logger.addHandler(fh)
    if screen:
        sh = logging.StreamHandler()
        sh.setFormatter(formatter)
        logger.addHandler(sh)
    return logger


def get_logger(name: str = "base") -> logging.Logger:
    return logging.getLogger(name)


def make_tb_writer(log_dir: str):
    """TensorBoard writer or None when tensorboardX is unavailable (or
    on a rank other than 0)."""
    from ..parallel import is_main
    if not is_main():
        return None
    try:
        from tensorboardX import SummaryWriter
        return SummaryWriter(log_dir=log_dir)
    except Exception:
        return None
