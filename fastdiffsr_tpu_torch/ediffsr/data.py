"""EDiffSR datasets: counterpart of ``fastdiffsr_tpu/ediffsr/data.py``,
all 7 reference modes.

Parity targets under EDiffSR/codes/data/:
- ``LQGT_dataset.py`` — paired GT/LQ trees; train = fresh random crop per
  access (GT_size window in GT, GT_size/scale in LQ) + flip/rot
  augmentation (util.augment); val = modcrop GT (+ optional center crop
  when LR_size is set); on-the-fly LR via MATLAB-bicubic ``imresize``
  when no LQ root is given (LQGT_dataset.py:128).
- ``GT_dataset.py`` — GT-only (train random crop + augment, val modcrop).
- ``LQ_dataset.py`` — LQ-only (val modcrop; train random crop + augment).
- ``StereoLQGT_dataset.py`` / ``StereoLQ_dataset.py`` — left/right pairs
  interleaved in the folder (index*2, index*2+1), the SAME crop/augment
  applied to both views, channel-concatenated output.
- ``BokehLQGT_dataset.py`` / ``BokehLQ_dataset.py`` — LQ/GT (+alpha) at
  equal resolution plus a meta file of (src_lens, tgt_lens, disparity).

Images load as RGB float32 in [0, 1] through ``metrics.load_img``, which
decodes PNGs without an image library (other formats need PIL). The
bicubic conditioning upsample happens on the device in the trainer
(``deg.upscale``). ``_bilinear_resize`` is PIL's BILINEAR resize of a
float image (the triangle filter, widened by the scale on downsampling,
weights renormalised per output pixel, horizontal pass first, each pass
accumulated in float64 and stored in float32), written out in numpy.

LQGT/GT/LQ roots ending in ``lmdb`` are read as BasicSR-style LMDB
environments (raw uint8 bytes + ``meta_info.pkl``, reference
data/util.py:29-63) through ``data.lmdb_lite``; the ``lmdb`` package is
not needed. The stereo/bokeh variants are folder-only (the reference
ships no lmdb configs for them).

Crops/augments draw from a per-dataset ``np.random.Generator`` behind a
lock: fresh randomness per access, thread-safe under the prefetching
DataLoader, and the same draws as the JAX package's for the same seed.
Each rank of a process group draws its own rows' crops in its own
sequence, as each JAX process does, so a W-rank run crops other windows
than a 1-rank run (the same images, the same order).
"""

from __future__ import annotations

import os
import threading

import numpy as np

from ..data.dataset import DataLoader, get_paths_from_images
from ..metrics import load_img
from .imgproc import augment, channel_convert, imresize, modcrop

def _read01(path: str) -> np.ndarray:
    """RGB HWC float32 in [0,1] (reference util.read_img semantics minus
    the BGR detour)."""
    return load_img(path).astype(np.float32) / 255.0


def _open_source(root: str):
    """-> (paths, read01_fn) for a folder tree or a BasicSR-style LMDB env
    (root ends in 'lmdb': raw uint8 image bytes per key, shapes in
    ``meta_info.pkl`` as 'C_H_W' strings, reference data/util.py:29-63).
    BasicSR lmdb stores cv2-order (BGR) pixels, so channels are reversed
    here to match _read01's RGB (the reference flips BGR->RGB at tensor
    time, LQGT_dataset.py:180-184)."""
    if not str(root).endswith("lmdb"):
        return get_paths_from_images(root), _read01

    import pickle
    # meta_info.pkl is written by the dataset's own preparation tool
    # (BasicSR's create_lmdb), beside the data it describes
    with open(os.path.join(root, "meta_info.pkl"), "rb") as f:
        meta = pickle.load(f)
    keys = [str(k) for k in meta["keys"]]
    sizes = list(meta["resolution"])
    if len(sizes) == 1:
        sizes = sizes * len(keys)
    shapes = dict(zip(keys, sizes))
    from ..data.lmdb_lite import LmdbReader
    env = LmdbReader(root)

    def read01(key: str) -> np.ndarray:
        c, h, w = (int(v) for v in shapes[key].split("_"))
        buf = env.get(key.encode("ascii"))
        if buf is None:
            raise KeyError(f"lmdb key {key!r} missing under {root}")
        img = np.frombuffer(buf, np.uint8).reshape(h, w, c)
        if c == 3:
            img = img[..., ::-1]           # BGR (cv2 order) -> RGB
        elif c == 1:
            img = np.repeat(img, 3, axis=2)
        return img.astype(np.float32) / 255.0

    return keys, read01


def _pil_bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float64 weights of PIL's BILINEAR resample of one axis
    (libImaging/Resample.c precompute_coeffs)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale                      # the triangle's support is 1
    w = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        x = np.arange(xmin, xmax, dtype=np.float64)
        k = np.maximum(0.0, 1.0 - np.abs((x - center + 0.5) / filterscale))
        total = k.sum()
        w[xx, xmin:xmax] = k / total if total != 0.0 else k
    return w


def _bilinear_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Host-side bilinear resize of an HWC float [0,1] image (the
    reference's cv2.INTER_LINEAR in LQGT_dataset.py:119; the JAX package
    calls PIL's BILINEAR on each channel, which this reproduces)."""
    x = img.astype(np.float32)
    x = np.einsum("ow,hwc->hoc", _pil_bilinear_weights(x.shape[1], w),
                  x.astype(np.float64)).astype(np.float32)
    x = np.einsum("oh,hwc->owc", _pil_bilinear_weights(x.shape[0], h),
                  x.astype(np.float64)).astype(np.float32)
    return x


class _EDiffSRDataset:
    """Shared plumbing: option access, lengths, a lock-guarded RNG so every
    __getitem__ draws fresh crop/flip decisions (the reference uses the
    global ``random`` module)."""

    split = "val"  # loader-side flips disabled; augmentation lives here

    def __init__(self, opt: dict):
        self.opt = opt
        self.phase = opt["phase"]
        self.scale = int(opt.get("scale") or 1)
        self.gt_size = opt.get("GT_size")
        self.lr_size = opt.get("LR_size")
        if self.gt_size and not self.lr_size:
            self.lr_size = int(self.gt_size) // self.scale
        self.use_flip = bool(opt.get("use_flip", True))
        self.use_rot = bool(opt.get("use_rot", True))
        self.color = opt.get("color")
        self._rng = np.random.default_rng(opt.get("seed"))
        self._lock = threading.Lock()
        data_len = opt.get("data_len") or -1
        self._data_len = int(data_len)

    def _truncate(self, n: int) -> int:
        return n if self._data_len <= 0 else min(self._data_len, n)

    def _draw_crop(self, h: int, w: int, size: int):
        with self._lock:
            y = int(self._rng.integers(0, max(0, h - size) + 1))
            x = int(self._rng.integers(0, max(0, w - size) + 1))
        return y, x

    def _augment(self, imgs):
        with self._lock:
            return augment(imgs, self.use_flip, self.use_rot, self._rng)

    def _color_convert(self, imgs):
        if not self.color:
            return imgs
        return channel_convert(imgs[0].shape[2], self.color, imgs)


class LQGTDataset(_EDiffSRDataset):
    """Paired GT/LQ (LQGT_dataset.py:18-194)."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.paths_GT, self._read_GT = _open_source(opt["dataroot_GT"])
        self.paths_LQ, self._read_LQ = (
            _open_source(opt["dataroot_LQ"])
            if opt.get("dataroot_LQ") else (None, None))
        if self.paths_LQ:
            assert len(self.paths_GT) == len(self.paths_LQ), \
                "GT and LQ folder lengths differ"
        self.data_len = self._truncate(len(self.paths_GT))

    def __len__(self):
        return self.data_len

    def __getitem__(self, index: int) -> dict:
        gt = self._read_GT(self.paths_GT[index])
        gt_path = self.paths_GT[index]

        if self.phase != "train":
            gt = modcrop(gt, self.scale)

        if self.paths_LQ:
            lq = self._read_LQ(self.paths_LQ[index])
            lq_path = self.paths_LQ[index]
        else:
            if self.phase == "train" and self.gt_size:
                # force GT dims to multiples of scale (>= GT_size) before
                # the downscale so LQ*scale == GT exactly and edge crops
                # cannot overflow (LQGT_dataset.py:107-121: random_scale
                # from [1] + _mod + cv2 INTER_LINEAR resize)
                gs = int(self.gt_size)

                def _mod(n):
                    return max((n // self.scale) * self.scale, gs)

                hs, ws = _mod(gt.shape[0]), _mod(gt.shape[1])
                if (hs, ws) != gt.shape[:2]:
                    gt = _bilinear_resize(gt, hs, ws)
            # on-the-fly degradation: MATLAB-bicubic downscale of GT
            # (LQGT_dataset.py:128 util.imresize(img_GT, 1/scale, True))
            lq = imresize(gt, 1.0 / self.scale, antialiasing=True)
            lq = lq.astype(np.float32)
            lq_path = gt_path

        if self.phase == "train" and self.gt_size:
            gs, ls = int(self.gt_size), int(self.lr_size)
            assert ls == gs // self.scale, "GT size does not match LR size"
            h, w = lq.shape[:2]
            y, x = self._draw_crop(h, w, ls)
            lq = lq[y:y + ls, x:x + ls]
            gt = gt[y * self.scale:y * self.scale + gs,
                    x * self.scale:x * self.scale + gs]
            lq, gt = self._augment([lq, gt])
        elif self.lr_size:
            # center crop (LQGT_dataset.py:153-166)
            gs, ls = int(self.gt_size or self.lr_size * self.scale), \
                int(self.lr_size)
            h, w = lq.shape[:2]
            if ls < h and ls < w:
                y, x = h // 2 - ls // 2, w // 2 - ls // 2
                lq = lq[y:y + ls, x:x + ls]
                gt = gt[y * self.scale:y * self.scale + gs,
                        x * self.scale:x * self.scale + gs]

        lq, gt = self._color_convert([lq, gt])
        return {"GT": np.ascontiguousarray(gt),
                "LQ": np.ascontiguousarray(lq),
                "GT_path": gt_path, "LQ_path": lq_path,
                "Index": np.int32(index)}


class GTDataset(_EDiffSRDataset):
    """GT-only (GT_dataset.py:18-105)."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.paths_GT, self._read_GT = _open_source(opt["dataroot_GT"])
        self.data_len = self._truncate(len(self.paths_GT))

    def __len__(self):
        return self.data_len

    def __getitem__(self, index: int) -> dict:
        gt = self._read_GT(self.paths_GT[index])
        if self.phase == "train" and self.gt_size:
            gs = int(self.gt_size)
            y, x = self._draw_crop(gt.shape[0], gt.shape[1], gs)
            gt = gt[y:y + gs, x:x + gs]
            (gt,) = self._augment([gt])
        else:
            gt = modcrop(gt, self.scale)
        (gt,) = self._color_convert([gt])
        return {"GT": np.ascontiguousarray(gt),
                "GT_path": self.paths_GT[index], "Index": np.int32(index)}


class LQDataset(_EDiffSRDataset):
    """LQ-only (LQ_dataset.py:18-110)."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.paths_LQ, self._read_LQ = _open_source(opt["dataroot_LQ"])
        self.data_len = self._truncate(len(self.paths_LQ))

    def __len__(self):
        return self.data_len

    def __getitem__(self, index: int) -> dict:
        lq = self._read_LQ(self.paths_LQ[index])
        if self.phase != "train":
            lq = modcrop(lq, self.scale)
        elif self.lr_size:
            ls = int(self.lr_size)
            y, x = self._draw_crop(lq.shape[0], lq.shape[1], ls)
            lq = lq[y:y + ls, x:x + ls]
            (lq,) = self._augment([lq])
        (lq,) = self._color_convert([lq])
        return {"LQ": np.ascontiguousarray(lq),
                "LQ_path": self.paths_LQ[index], "Index": np.int32(index)}


class StereoLQGTDataset(_EDiffSRDataset):
    """Left/right pairs interleaved in the folder; one crop/augment
    decision for both views (StereoLQGT_dataset.py:74-174)."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.paths_GT = get_paths_from_images(opt["dataroot_GT"])
        self.paths_LQ = get_paths_from_images(opt["dataroot_LQ"])
        self.data_len = self._truncate(len(self.paths_GT) // 2)

    def __len__(self):
        return self.data_len

    def __getitem__(self, index: int) -> dict:
        gt_l = _read01(self.paths_GT[index * 2])
        gt_r = _read01(self.paths_GT[index * 2 + 1])
        lq_l = _read01(self.paths_LQ[index * 2])
        lq_r = _read01(self.paths_LQ[index * 2 + 1])
        if self.phase != "train":
            gt_l, gt_r = modcrop(gt_l, self.scale), modcrop(gt_r, self.scale)
        if self.phase == "train" and self.gt_size:
            gs, ls = int(self.gt_size), int(self.lr_size)
            y, x = self._draw_crop(lq_l.shape[0], lq_l.shape[1], ls)
            lq_l = lq_l[y:y + ls, x:x + ls]
            lq_r = lq_r[y:y + ls, x:x + ls]
            gy, gx = y * self.scale, x * self.scale
            gt_l = gt_l[gy:gy + gs, gx:gx + gs]
            gt_r = gt_r[gy:gy + gs, gx:gx + gs]
            lq_l, lq_r, gt_l, gt_r = self._augment([lq_l, lq_r, gt_l, gt_r])
        return {"GT": np.ascontiguousarray(
                    np.concatenate([gt_l, gt_r], axis=2)),
                "LQ": np.ascontiguousarray(
                    np.concatenate([lq_l, lq_r], axis=2)),
                "GT_path": self.paths_GT[index * 2],
                "LQ_path": self.paths_LQ[index * 2],
                "Index": np.int32(index)}


class StereoLQDataset(StereoLQGTDataset):
    """LQ-only stereo (StereoLQ_dataset.py): same layout, no GT tree.
    The reference applies no crop/augment in any phase
    (StereoLQ_dataset.py:55-89); the val modcrop here is a divisibility
    convenience beyond it."""

    def __init__(self, opt: dict):
        _EDiffSRDataset.__init__(self, opt)
        self.paths_LQ = get_paths_from_images(opt["dataroot_LQ"])
        self.paths_GT = None
        self.data_len = self._truncate(len(self.paths_LQ) // 2)

    def __getitem__(self, index: int) -> dict:
        lq_l = _read01(self.paths_LQ[index * 2])
        lq_r = _read01(self.paths_LQ[index * 2 + 1])
        if self.phase != "train":
            lq_l, lq_r = modcrop(lq_l, self.scale), modcrop(lq_r, self.scale)
        return {"LQ": np.ascontiguousarray(
                    np.concatenate([lq_l, lq_r], axis=2)),
                "LQ_path": self.paths_LQ[index * 2],
                "Index": np.int32(index)}


def _lens_to_float(lenstr: str, scale: float = 1.0) -> np.float32:
    """Canon50mmf... -> negative, Sony50mmf... -> positive
    (BokehLQGT_dataset.py lenstr2tensor)."""
    lenstr = lenstr.replace("Canon50mmf", "-").replace("Sony50mmf", "")
    lenstr = lenstr.replace("BS", "")
    return np.float32(float(lenstr) * scale)


def _read_bokeh_meta(path: str) -> dict:
    if not os.path.isfile(path):
        raise ValueError(f"Meta file missing under {path}.")
    meta = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            iid, src, tgt, disp = [p.strip() for p in line.split(",")]
            meta[iid] = (src, tgt, disp)
    return meta


class BokehLQGTDataset(_EDiffSRDataset):
    """Bokeh-transform pairs at equal resolution + lens metadata
    (BokehLQGT_dataset.py:30-188)."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.paths_GT = get_paths_from_images(opt["dataroot_GT"])
        self.paths_LQ = get_paths_from_images(opt["dataroot_LQ"])
        self.paths_alpha = (get_paths_from_images(opt["dataroot_alpha"])
                            if opt.get("dataroot_alpha") else None)
        self.metas = _read_bokeh_meta(opt["dataroot_meta"])
        self.data_len = self._truncate(len(self.paths_GT))

    def __len__(self):
        return self.data_len

    def __getitem__(self, index: int) -> dict:
        gt = _read01(self.paths_GT[index])
        lq = _read01(self.paths_LQ[index])
        key_path = (self.paths_alpha[index] if self.paths_alpha
                    else self.paths_LQ[index])
        iid = os.path.basename(key_path).split(".")[0]
        src, tgt, disp = self.metas[iid]
        out_meta = {"src_lens": _lens_to_float(src, 10.0),
                    "tgt_lens": _lens_to_float(tgt, 10.0),
                    "disparity": _lens_to_float(disp, 1.0)}
        if self.phase == "train" and self.gt_size:
            gs = int(self.gt_size)
            # bokeh LQ/GT are same-resolution (assert LR_size == GT_size)
            y, x = self._draw_crop(lq.shape[0], lq.shape[1], gs)
            lq = lq[y:y + gs, x:x + gs]
            gt = gt[y:y + gs, x:x + gs]
            lq, gt = self._augment([lq, gt])
        return {"GT": np.ascontiguousarray(gt),
                "LQ": np.ascontiguousarray(lq),
                "GT_path": self.paths_GT[index],
                "LQ_path": self.paths_LQ[index],
                "Index": np.int32(index), **out_meta}


class BokehLQDataset(BokehLQGTDataset):
    """LQ-only bokeh (BokehLQ_dataset.py)."""

    def __init__(self, opt: dict):
        _EDiffSRDataset.__init__(self, opt)
        self.paths_LQ = get_paths_from_images(opt["dataroot_LQ"])
        self.paths_GT = None
        self.paths_alpha = None
        self.metas = _read_bokeh_meta(opt["dataroot_meta"])
        self.data_len = self._truncate(len(self.paths_LQ))

    def __getitem__(self, index: int) -> dict:
        lq = _read01(self.paths_LQ[index])
        iid = os.path.basename(self.paths_LQ[index]).split(".")[0]
        src, tgt, disp = self.metas[iid]
        return {"LQ": np.ascontiguousarray(lq),
                "LQ_path": self.paths_LQ[index], "Index": np.int32(index),
                "src_lens": _lens_to_float(src, 10.0),
                "tgt_lens": _lens_to_float(tgt, 10.0),
                "disparity": _lens_to_float(disp, 1.0)}


_MODES = {"LQGT": LQGTDataset, "GT": GTDataset, "LQ": LQDataset,
          "SteLQGT": StereoLQGTDataset, "SteLQ": StereoLQDataset,
          "BokehLQGT": BokehLQGTDataset, "BokehLQ": BokehLQDataset}


def create_ediffsr_dataset(dataset_opt: dict):
    """Mode dispatch (reference data/__init__.py:36-60)."""
    mode = dataset_opt.get("mode", "LQGT")
    if mode not in _MODES:
        raise NotImplementedError(
            f"Dataset [{mode}] is not recognized.")
    return _MODES[mode](dataset_opt)


def create_ediffsr_loaders(opt, shard_by_process: bool = False) -> dict:
    """train: cfg batch + shuffle; val: batch=1 sequential
    (reference data/__init__.py:8-33).

    ``shard_by_process`` (-launcher pytorch): the configured batch_size
    is the GLOBAL batch and this rank's train loader yields
    batch_size/world rows of it — the reference's dist-aware batch split
    (data/__init__.py:10-19)."""
    loaders = {}
    # train.manual_seed drives the crop/augment RNG (the reference seeds
    # the global random module from it, train.py util.set_random_seed);
    # per-phase offset keeps train/val streams distinct
    seed = (opt.get("train") or {}).get("manual_seed")
    for i, (phase, ds_opt) in enumerate(opt["datasets"].items()):
        if seed is not None and ds_opt.get("seed") is None:
            ds_opt["seed"] = int(seed) + i
        ds = create_ediffsr_dataset(ds_opt)
        if ds_opt["phase"] == "train":
            bsz = int(ds_opt.get("batch_size") or 2)
            if shard_by_process:
                from ..parallel import local_batch
                bsz = local_batch(bsz)
            loaders["train"] = DataLoader(
                ds, batch_size=bsz,
                shuffle=bool(ds_opt.get("use_shuffle", True)),
                num_workers=int(ds_opt.get("n_workers") or 1),
                shard_by_process=shard_by_process,
                enlarge_ratio=int(
                    ds_opt.get("dataset_enlarge_ratio") or 1))
        else:
            loaders["val"] = DataLoader(ds, batch_size=1, shuffle=False)
    return loaders
