"""LRHR paired dataset + host input pipeline.

Counterpart of ``fastdiffsr_tpu/data/dataset.py``, copied with two
changes: PNG and JPEG files decode with the port's own native decoder
(``fastdiffsr_tpu_torch.native``) and PIL is imported only for the rest
(other formats, LMDB tiles), and process sharding reads the rank and
world of the ``torch.distributed`` group (``parallel.multihost``).

Parity target: data/LRHR_dataset.py + data/util.py of the reference —
- folder tree ``{dataroot}/sr_{l}_{r}``, ``{dataroot}/hr_{r}``, optional
  ``lr_{l}`` and ``hr_mask_{r}`` (LRHR_dataset.py:28-46)
- sorted os.walk path collection (util.py:15-24)
- images -> float32 in [-1, 1] (util.py:68-75 with min_max=(-1,1))
- train-time random horizontal flip applied to the stacked pair so SR/HR
  flip together (util.py:68-75). NOTE: the reference flips LR with an
  *independent* random draw (LR_transform_augment is a separate call,
  LRHR_dataset.py:106-112) which desynchronizes LR from HR/SR; LR is unused
  by the diffusion trainer, but we fix the quirk and flip everything with
  one draw.
- ``data_len`` truncation (LRHR_dataset.py:46-50)

Batching is NHWC numpy with epoch-seeded shuffling (each process reads
its ``process_index``-strided shard) and a background thread prefetcher.

Packed storage: datatype 'npy'/'pack' memory-maps one contiguous uint8
array per split (fastest host reads, no image decoder needed); datatype
'lmdb' reads the reference's LMDB layout (keys ``length`` +
``{hr,sr,lr}_..._{idx:05d}`` holding TIFF-encoded bytes,
LRHR_dataset.py:18-27,61-96, as ``data/prepare.py --lmdb`` writes it)
through ``lmdb_lite.LmdbReader``; the ``lmdb`` package is not needed.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np

IMG_EXTENSIONS = (".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG",
                  ".ppm", ".PPM", ".bmp", ".BMP", "tif")


def is_image_file(filename: str) -> bool:
    return filename.endswith(IMG_EXTENSIONS)


def get_paths_from_images(path: str) -> list:
    assert os.path.isdir(path), f"{path} is not a valid directory"
    images = []
    for dirpath, _, fnames in sorted(os.walk(path)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(dirpath, fname))
    assert images, f"{path} has no valid image file"
    return sorted(images)


def _load_image(path: str) -> np.ndarray:
    """uint8 HWC RGB. PNG and JPEG files go through the port's native
    decoder (``fastdiffsr_tpu_torch.native``, libpng / libjpeg:
    bit-identical to PIL for PNG) unless ``FASTDIFFSR_TPU_NO_NATIVE=1``;
    PIL (imported here, so the npy-pack path needs no image library)
    decodes every other format, and any file where that decoder is
    unavailable (its build failure is logged once) or fails."""
    if os.environ.get("FASTDIFFSR_TPU_NO_NATIVE") != "1" and \
            path.lower().endswith((".png", ".jpg", ".jpeg")):
        from ..native import decode_rgb
        arr = decode_rgb(path)
        if arr is not None:
            return arr
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def to_minus1_1(img_u8: np.ndarray) -> np.ndarray:
    return img_u8.astype(np.float32) / 255.0 * 2.0 - 1.0


class LRHRDataset:
    """Paired SR(bicubic-up)/HR dataset from a folder tree or a .npy pack."""

    def __init__(self, dataroot: str, datatype: str = "img",
                 l_resolution: int = 64, r_resolution: int = 256,
                 split: str = "train", data_len: int = -1,
                 need_LR: bool = False, img_mask: str = "no"):
        self.datatype = datatype
        self.l_res = l_resolution
        self.r_res = r_resolution
        self.split = split
        self.need_LR = need_LR
        self._lmdb = None

        if datatype == "img":
            self.sr_path = get_paths_from_images(
                f"{dataroot}/sr_{l_resolution}_{r_resolution}")
            self.hr_path = get_paths_from_images(
                f"{dataroot}/hr_{r_resolution}")
            self.hr_mask_path = (
                get_paths_from_images(f"{dataroot}/hr_mask_{r_resolution}")
                if img_mask != "no" else None)
            self.lr_path = (get_paths_from_images(
                f"{dataroot}/lr_{l_resolution}") if need_LR else None)
            self.dataset_len = len(self.hr_path)
            self._pack = None
        elif datatype in ("npy", "pack"):
            self._pack = {
                "SR": np.load(f"{dataroot}/sr_{l_resolution}_{r_resolution}.npy",
                              mmap_mode="r"),
                "HR": np.load(f"{dataroot}/hr_{r_resolution}.npy",
                              mmap_mode="r"),
            }
            if need_LR:
                lr_file = f"{dataroot}/lr_{l_resolution}.npy"
                if os.path.exists(lr_file):
                    self._pack["LR"] = np.load(lr_file, mmap_mode="r")
            self.hr_mask_path = None
            self.dataset_len = int(self._pack["HR"].shape[0])
        elif datatype == "lmdb":
            from .lmdb_lite import LmdbReader
            self._lmdb = LmdbReader(dataroot)
            length = self._lmdb.get(b"length")
            # the reference stores the running count under 'length'
            # (prepare_data_mfe_dm.py:91-93); files written by other tools
            # are counted by their hr_* keys
            self.dataset_len = (int(length) if length is not None else
                                sum(1 for k in self._lmdb.keys()
                                    if k.startswith(b"hr_")))
            self.hr_mask_path = None
            self._pack = None
        else:
            raise NotImplementedError(f"data_type [{datatype}] unknown")

        self.data_len = (self.dataset_len if data_len <= 0
                         else min(data_len, self.dataset_len))

    def __len__(self) -> int:
        return self.data_len

    def raw_uint8(self, materialize: bool = True) -> dict:
        """The whole (truncated-to-data_len) dataset as uint8 arrays
        {'HR': (N,r,r,3), 'SR': (N,r,r,3)} — the host-side half of the
        device-resident dataset mode (train/steps.make_cached_train_step).

        With ``materialize=False`` a pack dataset returns the mmap-backed
        slices instead of host copies, so a chunked device upload never
        holds the full corpus in host RAM (folder datasets still stack)."""
        if self._lmdb is not None:
            n = range(self.data_len)
            return {"SR": np.stack([self._lmdb_image(
                        f"sr_{self.l_res}_{self.r_res}_{i:05d}") for i in n]),
                    "HR": np.stack([self._lmdb_image(
                        f"hr_{self.r_res}_{i:05d}") for i in n])}
        if self._pack is not None:
            view = {"SR": self._pack["SR"][:self.data_len],
                    "HR": self._pack["HR"][:self.data_len]}
            if materialize:
                view = {k: np.asarray(v) for k, v in view.items()}
            return view
        sr = np.stack([_load_image(p)
                       for p in self.sr_path[:self.data_len]])
        hr = np.stack([_load_image(p)
                       for p in self.hr_path[:self.data_len]])
        return {"SR": sr, "HR": hr}

    def _lmdb_image(self, key: str) -> np.ndarray:
        buf = self._lmdb.get(key)
        if buf is None:
            # the reference silently redraws a random index on a missing
            # key (LRHR_dataset.py:76-90), which hides corruption
            raise KeyError(f"lmdb key {key!r} missing from the dataset")
        import io

        from PIL import Image
        with Image.open(io.BytesIO(buf)) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)

    def __getitem__(self, index: int) -> dict:
        if self._lmdb is not None:
            img_hr = self._lmdb_image(f"hr_{self.r_res}_{index:05d}")
            img_sr = self._lmdb_image(
                f"sr_{self.l_res}_{self.r_res}_{index:05d}")
            img_lr = (self._lmdb_image(f"lr_{self.l_res}_{index:05d}")
                      if self.need_LR else None)
            img_mask = None
        elif self._pack is not None:
            img_sr = np.asarray(self._pack["SR"][index])
            img_hr = np.asarray(self._pack["HR"][index])
            img_lr = (np.asarray(self._pack["LR"][index])
                      if self.need_LR and "LR" in self._pack else None)
            img_mask = None
        else:
            img_sr = _load_image(self.sr_path[index])
            img_hr = _load_image(self.hr_path[index])
            img_lr = (_load_image(self.lr_path[index])
                      if self.need_LR else None)
            img_mask = (_load_image(self.hr_mask_path[index])
                        if self.hr_mask_path else None)

        out = {"HR": to_minus1_1(img_hr), "SR": to_minus1_1(img_sr),
               "Index": np.int32(index)}
        if img_lr is not None:
            out["LR"] = to_minus1_1(img_lr)
        if img_mask is not None:
            out["HR_Mask"] = to_minus1_1(img_mask)
        return out


def _maybe_flip(sample: dict, seed: int, epoch: int) -> dict:
    """One flip draw applied consistently to every image in the sample.

    The draw is keyed by (seed, epoch, dataset index) — NOT by position in
    a per-process stream — so the augmented sample is identical no matter
    which process loads it or where it lands in a batch (required for the
    single-process == multi-process training equality of
    tests/test_torch_dist_cli.py)."""
    rng = np.random.default_rng((seed, epoch, int(sample["Index"])))
    if rng.random() < 0.5:
        sample = {k: (np.ascontiguousarray(v[:, ::-1, :])
                      if isinstance(v, np.ndarray) and v.ndim == 3 else v)
                  for k, v in sample.items()}
    return sample


class DataLoader:
    """Epoch-seeded shuffling batcher with background prefetch.

    Per-process sharding: pass process_index / process_count, or
    ``shard_by_process=True`` for this process's rank and world in the
    ``torch.distributed`` group (0 and 1 without one).

    Sharded shuffling implements the reference DistIterSampler semantics
    (EDiffSR/codes/data/data_sampler.py:13-60): every epoch draws ONE
    epoch-seeded global permutation — identical on every process because
    it depends only on (seed, epoch) — of the ×``enlarge_ratio`` index
    stream taken modulo n, wraparound-padded so every process gets
    exactly the same number of samples (unequal shards would
    desynchronize the ranks' lockstep steps). Processes iterating in step
    therefore partition each epoch's permutation exactly
    (tests/test_data_config.py::test_loader_dist_iter_semantics).

    Split rule: with P processes the stream is padded to whole GLOBAL
    batches (P × batch_size) and process p takes the p-th contiguous
    batch_size sub-block of every global batch window — not the
    reference's element stride. Both rules partition the permutation;
    the block rule additionally makes the global batch of the ranks'
    rows (concatenated in rank order) bit-identical to the
    single-process batch drawn from the same permutation, so
    multi-process training is testably equivalent to single-process
    (tests/test_torch_dist_cli.py loss parity).
    """

    def __init__(self, dataset: LRHRDataset, batch_size: int = 1,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: Optional[bool] = None,
                 prefetch: int = 4,
                 num_workers: int = 1,
                 shard_by_process: bool = False,
                 process_index: int = 0, process_count: int = 1,
                 enlarge_ratio: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = shuffle if drop_last is None else drop_last
        self.prefetch = prefetch
        self.num_workers = max(1, int(num_workers or 1))
        self.epoch = 0
        if shard_by_process:
            from ..parallel import rank, world_size
            process_index, process_count = rank(), world_size()
        self.process_index = process_index
        self.process_count = process_count
        self.enlarge_ratio = max(1, int(enlarge_ratio or 1))

    def set_epoch(self, epoch: int) -> None:
        """Pin the permutation epoch explicitly (the reference's
        sampler.set_epoch, data_sampler.py:58-60). Normally unnecessary:
        each __iter__ advances the epoch implicitly and processes iterating
        in lockstep stay in agreement."""
        self.epoch = int(epoch)

    def __len__(self):
        if self.shuffle:
            n = -(-len(self.dataset) * self.enlarge_ratio
                  // self._pad_unit()) * self._pad_unit() \
                // self.process_count
        else:
            n = len(self.dataset) // self.process_count
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _pad_unit(self) -> int:
        # multi-process: pad the shuffled stream to whole global batches
        # (see the class docstring's split rule); single-process keeps the
        # exact ×ratio stream length (tail handled by drop_last)
        if self.process_count > 1:
            return self.process_count * self.batch_size
        return 1

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        P = self.process_count
        if self.shuffle:
            # global permutation of the (enlarged, padded) index stream,
            # mod n — identical across processes for a given (seed, epoch)
            unit = self._pad_unit()
            total = -(-n * self.enlarge_ratio // unit) * unit
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(total) % n
            if P == 1:
                return idx
            # process p <- the p-th batch_size block of each global batch
            return idx.reshape(-1, P, self.batch_size)[
                :, self.process_index, :].reshape(-1)
        idx = np.arange(n)
        return idx[self.process_index::P]

    def __iter__(self) -> Iterator[dict]:
        aug_epoch = self.epoch
        idx = self._indices()
        batches = []
        for start in range(0, len(idx), self.batch_size):
            chunk = idx[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            batches.append(chunk)
        self.epoch += 1

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()

        # image decode drops the GIL in libpng/libjpeg (PIL), so
        # intra-batch threads parallelize like the
        # reference's num_workers DataLoader processes (config:23)
        pool = None
        if self.num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(max_workers=self.num_workers)

        def fetch(chunk):
            if pool is not None:
                return list(pool.map(self.dataset.__getitem__,
                                     [int(i) for i in chunk]))
            return [self.dataset[int(i)] for i in chunk]

        def worker():
            try:
                for chunk in batches:
                    samples = fetch(chunk)
                    if self.dataset.split == "train":
                        samples = [_maybe_flip(s, self.seed, aug_epoch)
                                   for s in samples]
                    batch = {k: np.stack([s[k] for s in samples])
                             for k in samples[0]}
                    q.put(batch)
            except BaseException as e:  # surface in the consumer thread
                q.put(e)
            finally:
                q.put(stop)
                if pool is not None:
                    pool.shutdown(wait=False)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item


def create_dataset(dataset_opt: dict, phase: str) -> LRHRDataset:
    """Reference factory semantics (data/__init__.py:24-40)."""
    mode = dataset_opt["mode"]
    return LRHRDataset(
        dataroot=dataset_opt["dataroot"],
        datatype=dataset_opt["datatype"],
        l_resolution=dataset_opt["l_resolution"],
        r_resolution=dataset_opt["r_resolution"],
        split=phase,
        data_len=dataset_opt["data_len"] if dataset_opt["data_len"]
        is not None else -1,
        need_LR=(mode == "LRHR"),
        img_mask=dataset_opt.get("img_mask", "no") or "no",
    )


def create_dataloader(dataset: LRHRDataset, dataset_opt: dict,
                      phase: str,
                      shard_by_process: bool = False) -> DataLoader:
    """train: cfg batch/shuffle; val: batch=1 sequential
    (reference data/__init__.py:7-21).

    ``shard_by_process`` (cli/sr_mfe.py -dist): the configured batch_size
    is the GLOBAL batch; this rank's loader yields its
    batch_size/world rows of it (the reference's per-rank batch split,
    EDiffSR data/__init__.py:10-19)."""
    if phase == "train":
        bsz = int(dataset_opt["batch_size"])
        if shard_by_process:
            from ..parallel import local_batch
            bsz = local_batch(bsz)
        return DataLoader(dataset,
                          batch_size=bsz,
                          shuffle=bool(dataset_opt.get("use_shuffle", True)),
                          num_workers=dataset_opt.get("num_workers") or 1,
                          shard_by_process=shard_by_process,
                          enlarge_ratio=int(
                              dataset_opt.get("dataset_enlarge_ratio")
                              or 1))
    if phase == "val":
        # the reference forces batch=1 for val (data/__init__.py:15-18); a
        # larger datasets.val.batch_size batches the sampler (per-image
        # metrics/saves are unchanged)
        return DataLoader(dataset,
                          batch_size=int(dataset_opt.get("batch_size") or 1),
                          shuffle=False)
    raise NotImplementedError(f"Dataloader [{phase}] is not found.")
