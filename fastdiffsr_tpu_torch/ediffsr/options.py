"""YAML options of EDiffSR: counterpart of ``fastdiffsr_tpu/ediffsr/
options.py`` (reference EDiffSR/codes/config/sisr/options.py:19-145):
scale injection into the network setting, the experiments/results dir
layout and NoneDict wrapping.

The files are read by :func:`load_yaml`, a reader of the YAML subset the
shipped option files use (block maps, ``- `` lists, comments, plain and
quoted scalars), which resolves scalars as PyYAML's ``safe_load`` does
(YAML 1.1: ``null``/``~``, ``true``/``yes``/``on``..., ints, floats with
a dot such as ``4.0e-05``). It raises on anything else (flow
collections, anchors, tags, block scalars, several documents), so a file
it reads means the same to both. :func:`dump_yaml` writes that subset
back. PyYAML is not needed, and not used where it is installed.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Tuple

from ..config import NoneDict, dict_to_nonedict

_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*(?:[eE][-+][0-9]+)?$")
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                              "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF")}}
_NULL = ("", "~", "null", "Null", "NULL")
_SPECIAL_FLOAT = {".inf": float("inf"), ".Inf": float("inf"),
                  ".INF": float("inf"), "-.inf": float("-inf"),
                  "-.Inf": float("-inf"), "-.INF": float("-inf"),
                  "+.inf": float("inf"), ".nan": float("nan"),
                  ".NaN": float("nan"), ".NAN": float("nan")}


class YamlSubsetError(ValueError):
    pass


def _strip_comment(line: str) -> str:
    """The line without a trailing ``# comment`` (outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _scalar(text: str, where: str) -> Any:
    text = text.strip()
    if text[:1] == "'":
        if len(text) < 2 or text[-1] != "'":
            raise YamlSubsetError(f"{where}: unterminated quote")
        return text[1:-1].replace("''", "'")
    if text[:1] == '"':
        if len(text) < 2 or text[-1] != '"':
            raise YamlSubsetError(f"{where}: unterminated quote")
        body = text[1:-1]
        if "\\" in body:
            body = body.encode("latin-1", "backslashreplace").decode(
                "unicode_escape")
        return body
    if text in ("[]", "{}"):
        return [] if text == "[]" else {}
    if text[:1] in "[{&*!|>%@`" or text.startswith("- "):
        raise YamlSubsetError(f"{where}: {text!r} is outside the YAML "
                              "subset of the option files")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if text in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[text]
    if _FLOAT.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    return text


def _split_key(content: str, where: str) -> Tuple[str, str]:
    """'key: value' / 'key:' -> (key, value text)."""
    m = re.match(r"""((?:'[^']*'|"[^"]*"|[^'"#:][^:]*?)):(?:\s+(.*)|$)""",
                 content)
    if m is None:
        raise YamlSubsetError(f"{where}: expected 'key: value', got "
                              f"{content!r}")
    key = _scalar(m.group(1), where)
    if not isinstance(key, str):
        key = str(key) if not isinstance(key, bool) else key
    return key, (m.group(2) or "")


def load_yaml(text: str) -> Any:
    """Parse ``text`` (the option files' YAML subset) into dicts, lists
    and scalars."""
    lines: List[Tuple[int, str, int]] = []
    for no, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError(f"line {no}: tab indentation")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.strip() in ("---", "..."):
            if lines:
                raise YamlSubsetError(f"line {no}: a second document")
            continue
        lines.append((len(line) - len(line.lstrip(" ")), line.strip(), no))
    if not lines:
        return None
    value, pos = _parse_block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise YamlSubsetError(f"line {lines[pos][2]}: bad indentation")
    return value


def _parse_block(lines, pos, indent):
    if lines[pos][1].startswith("- ") or lines[pos][1] == "-":
        return _parse_list(lines, pos, indent)
    return _parse_map(lines, pos, indent)


def _child(lines, pos, parent_indent, where, list_parent=False):
    """The value of a 'key:' with nothing after it: a nested block, or a
    list at the key's own indentation, or null."""
    if pos < len(lines):
        ind, content, _ = lines[pos]
        if ind > parent_indent:
            return _parse_block(lines, pos, ind)
        if (ind == parent_indent and not list_parent
                and (content.startswith("- ") or content == "-")):
            return _parse_list(lines, pos, ind)
    return None, pos


def _parse_map(lines, pos, indent):
    out = {}
    while pos < len(lines):
        ind, content, no = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise YamlSubsetError(f"line {no}: bad indentation")
        if content.startswith("- ") or content == "-":
            break
        where = f"line {no}"
        key, rest = _split_key(content, where)
        if key in out:
            raise YamlSubsetError(f"{where}: duplicate key {key!r}")
        pos += 1
        if rest.strip():
            out[key] = _scalar(rest, where)
        else:
            out[key], pos = _child(lines, pos, indent, where)
    return out, pos


def _parse_list(lines, pos, indent):
    out = []
    while pos < len(lines):
        ind, content, no = lines[pos]
        if ind != indent or not (content.startswith("- ") or content == "-"):
            if ind > indent:
                raise YamlSubsetError(f"line {no}: bad indentation")
            break
        item = content[1:].strip()
        pos += 1
        if not item:
            value, pos = _child(lines, pos, indent, f"line {no}",
                                list_parent=True)
            out.append(value)
        elif re.match(r"""(?:'[^']*'|"[^"]*"|[^'"#:\[{][^:]*?):(\s|$)""",
                      item):
            raise YamlSubsetError(f"line {no}: a map inside a list is "
                                  "outside the option files' subset")
        else:
            out.append(_scalar(item, f"line {no}"))
    return out, pos


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "e" in text or "E" in text:
            mant, exp = text.lower().split("e")
            if "." not in mant:
                mant += ".0"
            sign = "-" if exp.startswith("-") else "+"
            text = f"{mant}e{sign}{exp.lstrip('+-').zfill(2)}"
        elif "." not in text:
            text += ".0"
        return text
    s = str(v)
    if _scalar_or_none(s) != s:
        return "'" + s.replace("'", "''") + "'"
    return s


def _scalar_or_none(s: str):
    try:
        if s != s.strip() or ": " in s or " #" in s or s.endswith(":"):
            return None
        return _scalar(s, "dump")
    except YamlSubsetError:
        return None


def dump_yaml(obj, indent: int = 0) -> str:
    """Block-style YAML of nested dicts, lists of scalars and scalars,
    which :func:`load_yaml` (and PyYAML) read back unchanged."""
    pad = " " * indent
    out = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            key = _dump_scalar(k)
            if isinstance(v, dict) and v:
                out.append(f"{pad}{key}:\n{dump_yaml(v, indent + 2)}")
            elif isinstance(v, (list, tuple)) and v:
                out.append(f"{pad}{key}:\n{dump_yaml(list(v), indent)}")
            elif isinstance(v, (dict, list, tuple)):
                empty = "{}" if isinstance(v, dict) else "[]"
                out.append(f"{pad}{key}: {empty}\n")
            else:
                out.append(f"{pad}{key}: {_dump_scalar(v)}\n")
        return "".join(out)
    if isinstance(obj, list):
        for v in obj:
            if isinstance(v, (dict, list, tuple)):
                raise YamlSubsetError("nested collections in a list are "
                                      "outside the option files' subset")
            out.append(f"{pad}- {_dump_scalar(v)}\n")
        return "".join(out)
    return f"{pad}{_dump_scalar(obj)}\n"


def parse_options(path: str, is_train: bool = True,
                  root: str = ".") -> NoneDict:
    with open(path, "r") as f:
        opt = load_yaml(f.read())

    opt["is_train"] = is_train
    scale = (opt.get("degradation") or {}).get("scale", 4)

    for phase, dataset in (opt.get("datasets") or {}).items():
        phase = phase.split("_")[0]
        dataset["phase"] = phase
        dataset["scale"] = scale
        is_lmdb = any(str(dataset.get(k) or "").endswith("lmdb")
                      for k in ("dataroot_GT", "dataroot_LQ"))
        dataset["data_type"] = "lmdb" if is_lmdb else "img"

    if opt.get("network_G") is not None:
        opt["network_G"].setdefault("setting", {})
        opt["network_G"]["setting"]["upscale"] = scale

    name = opt.get("name", "ediffsr")
    opt.setdefault("path", {})
    if is_train:
        experiments_root = os.path.join(root, "experiments", name)
        # a fresh (non-resume) run archives a non-empty experiment dir
        # (reference train.py:96-100, file_utils.mkdir_and_rename)
        if (not opt["path"].get("resume_state")
                and os.path.isdir(experiments_root)
                and os.listdir(experiments_root)):
            import time
            new_name = (experiments_root + "_archived_"
                        + time.strftime("%y%m%d-%H%M%S"))
            print(f"Path already exists. Rename it to [{new_name}]")
            os.rename(experiments_root, new_name)
        paths = {"experiments_root": experiments_root,
                 "models": os.path.join(experiments_root, "models"),
                 "training_state": os.path.join(experiments_root,
                                                "training_state"),
                 "log": experiments_root,
                 "val_images": os.path.join(experiments_root, "val_images")}
    else:
        results_root = os.path.join(root, "results", name)
        paths = {"results_root": results_root, "log": results_root}
    opt["path"].update(paths)
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    return dict_to_nonedict(opt)


def check_resume(opt) -> None:
    """With ``path.resume_state`` set, an explicit ``pretrain_model_G``
    is ignored with a warning (reference options.py:125-145): the
    checkpoint directory holds the params, the optimizer and the EMA."""
    import logging

    if opt["path"]["resume_state"] and opt["path"].get("pretrain_model_G"):
        logging.getLogger("ediffsr").warning(
            "pretrain_model path will be ignored when resuming training.")
        opt["path"]["pretrain_model_G"] = None
