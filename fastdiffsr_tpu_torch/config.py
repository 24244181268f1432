"""Config system: JSON-with-//-comments, reference-schema compatible.

Parity target: core/logger.py:21-112 of the reference —
- line-wise ``//`` comment stripping (core/logger.py:26-32)
- per-run experiment dirs ``experiments/<name>_<timestamp>/{logs,tb_logger,
  results,checkpoint}`` (core/logger.py:37-43)
- ``-debug`` shrink mode (core/logger.py:62-70)
- train phase forces ``val.data_len = 13`` (core/logger.py:73-74)
- missing-key-access returns None (NoneDict, core/logger.py:97-112)

Counterpart of ``fastdiffsr_tpu/config.py``. The reference's gpu_ids ->
CUDA_VISIBLE_DEVICES plumbing is replaced by torchrun's ranks:
``distributed`` is true in a ``torch.distributed`` group of more than
one rank (``-dist``), and the ranks of a group share rank 0's
experiment directory.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from datetime import datetime


class NoneDict(dict):
    """dict whose missing keys read as None (reference core/logger.py:97)."""

    def __missing__(self, key):
        return None


def dict_to_nonedict(opt):
    if isinstance(opt, dict):
        return NoneDict({k: dict_to_nonedict(v) for k, v in opt.items()})
    if isinstance(opt, list):
        return [dict_to_nonedict(x) for x in opt]
    return opt


def strip_json_comments(text: str) -> str:
    out = []
    for line in text.split("\n"):
        pos = line.find("//")
        out.append(line if pos < 0 else line[:pos] + ("\n" if line.endswith("\n") else ""))
    return "\n".join(out)


def load_json_config(path: str) -> OrderedDict:
    with open(path, "r") as f:
        return json.loads(strip_json_comments(f.read()),
                          object_pairs_hook=OrderedDict)


def get_timestamp() -> str:
    return datetime.now().strftime("%y%m%d_%H%M%S")


def mkdirs(paths):
    if isinstance(paths, str):
        paths = [paths]
    for p in paths:
        os.makedirs(p, exist_ok=True)


def parse(config_path: str, phase: str, debug: bool = False,
          enable_wandb: bool = False, log_wandb_ckpt: bool = False,
          log_eval: bool = False, root: str = ".") -> NoneDict:
    """Parse a reference-schema JSON config into a NoneDict opt."""
    opt = load_json_config(config_path)
    opt["phase"] = phase

    # experiment dirs (reference core/logger.py:34-46)
    if opt["path"].get("resume_state"):
        # A resume_state may contain glob wildcards (e.g.
        # "experiments/<name>_*/checkpoint/I60000_E1000") so configs need
        # not hardcode the timestamped run dir of one machine; the latest
        # matching run wins. A wildcard with zero matches is a clear error
        # here rather than a missing-file failure deep in load_state.
        rs = opt["path"]["resume_state"]
        if any(ch in rs for ch in "*?["):
            import glob
            matches = sorted(glob.glob(os.path.join(root, rs)))
            if not matches:
                raise FileNotFoundError(
                    f"resume_state pattern matched nothing: {rs}")
            opt["path"]["resume_state"] = matches[-1]
        experiments_root = os.path.dirname(
            os.path.dirname(opt["path"]["resume_state"]))
    else:
        from .parallel import broadcast_object
        experiments_root = os.path.join(
            root, "experiments",
            f"{opt['name']}_{broadcast_object(get_timestamp())}")
    opt["path"]["experiments_root"] = experiments_root
    for key, sub in list(opt["path"].items()):
        if "resume" not in key and "experiments" not in key and \
                isinstance(sub, str):
            opt["path"][key] = os.path.join(experiments_root, sub)
            mkdirs(opt["path"][key])

    from .parallel import world_size
    opt["distributed"] = world_size() > 1

    # debug shrink (reference core/logger.py:62-70)
    if debug:
        opt["name"] = "debug_{}".format(opt["name"])
        if "train" in opt:
            opt["train"]["val_freq"] = 2
            opt["train"]["print_freq"] = 2
            opt["train"]["save_checkpoint_freq"] = 3
            # divergence from the reference: it leaves n_iter at the full
            # 915,200 even in debug, so the "smoke run" never terminates.
            # Cap it so `-debug` completes in about a minute.
            opt["train"]["n_iter"] = min(int(opt["train"]["n_iter"]), 8)
        opt["datasets"]["train"]["batch_size"] = 2
        opt["model"]["beta_schedule"]["train"]["n_timestep"] = 10
        opt["model"]["beta_schedule"]["val"]["n_timestep"] = 10
        opt["datasets"]["train"]["data_len"] = 6
        opt["datasets"]["val"]["data_len"] = 3

    # validation length during training (reference core/logger.py:73-74)
    if phase == "train" and not debug:
        opt["datasets"]["val"]["data_len"] = 13

    for ds_phase, dataset in opt["datasets"].items():
        dataset["phase"] = "train" if ds_phase == "train" else "val"
        if "lmdb" in str(dataset.get("datatype", "")):
            dataset["data_type"] = "lmdb"
        else:
            dataset["data_type"] = "img"

    opt["enable_wandb"] = enable_wandb
    opt["log_wandb_ckpt"] = log_wandb_ckpt
    opt["log_eval"] = log_eval
    return dict_to_nonedict(opt)


def dict2str(opt, indent_l=1) -> str:
    """Pretty printer (reference core/logger.py:115-126)."""
    msg = ""
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_l * 2) + k + ":[\n"
            msg += dict2str(v, indent_l + 1)
            msg += " " * (indent_l * 2) + "]\n"
        else:
            msg += " " * (indent_l * 2) + k + ": " + str(v) + "\n"
    return msg


def infer_scale(opt) -> int:
    """SR scale inferred from the train l_resolution
    (reference sr_mfe.py:38-42: 64 -> x4, 32 -> x8 for r=256)."""
    train_ds = opt["datasets"]["train"]
    return int(round(int(train_ds["r_resolution"])
                     / int(train_ds["l_resolution"])))
