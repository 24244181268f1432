"""Data-prep pipeline: source images -> paired {lr, hr, sr} tiles.

Counterpart of ``fastdiffsr_tpu/data/prepare.py``, a copy of its own
(the port imports nothing of the JAX package) that writes the same
files. Run it as ``python -m fastdiffsr_tpu_torch.data.prepare -p
<source dir> -o <out> --size 16,64 [--pack | --lmdb] [--n_worker N]``;
the output goes to ``<out>_<l>_<r>``.

Parity target: data/prepare_data_mfe_dm.py of the reference —
for each source image produce
  lr_{l}:      PIL-bicubic resize to l (shorter side) + center crop
  hr_{r}:      PIL-bicubic resize to r + center crop
  sr_{l}_{r}:  PIL-bicubic re-upsample of the LR tile to r
(reference :17-40). PIL bicubic is kept byte-compatible on purpose: every
metric the port reports is taken against tiles made this way.

Output formats:
  folder (default): ``{out}/{lr_l,hr_r,sr_l_r}/{stem}.png``
  pack:             one mmap-able uint8 ``.npy`` per stream
                    (``datatype: npy``; the fastest to read).
  lmdb:             the reference's LMDB layout (``--lmdb``,
                    prepare_data_mfe_dm.py:113,82-93: TIFF bytes under
                    sequential ``{lr,hr,sr}_..._{i:05d}`` keys +
                    ``length``), written by ``lmdb_lite`` so the output
                    interchanges with reference users' ``lmdb`` readers.

Host-side parallelism uses a process pool of ``spawn`` workers
(reference: manual Process + shared counter, :115-134).
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np


def resize_and_convert(img, size: int, resample):
    """Resize shorter side to ``size`` then center-crop to size x size
    (reference :17-21; trans_fn.resize + trans_fn.center_crop semantics)."""
    if img.size[0] != size:
        w, h = img.size
        nw, nh = ((size, int(round(size * h / w))) if w <= h
                  else (int(round(size * w / h)), size))
        # torchvision resize(size:int) maps shorter side to size
        img = img.resize((nw, nh), resample)
        left = (nw - size) // 2
        top = (nh - size) // 2
        img = img.crop((left, top, left + size, top + size))
    return img


def resize_multiple(img, sizes=(64, 256), resample=None):
    from PIL import Image
    resample = resample or Image.BICUBIC
    lr = resize_and_convert(img, sizes[0], resample)
    hr = resize_and_convert(img, sizes[1], resample)
    sr = lr.resize((sizes[1], sizes[1]), resample)
    return lr, hr, sr


def _tif_bytes(img) -> bytes:
    """TIFF-encode (reference image_convert_bytes,
    prepare_data_mfe_dm.py:24-27)."""
    import io
    buf = io.BytesIO()
    img.save(buf, format="TIFF")
    return buf.getvalue()


def _worker(task):
    from PIL import Image
    path, out_path, sizes, fmt = task
    with Image.open(path) as img:
        img = img.convert("RGB")
        lr, hr, sr = resize_multiple(img, sizes=sizes)
    stem = Path(path).name.split(".")[0].zfill(5)
    if fmt == "pack":
        return stem, (np.asarray(lr, np.uint8), np.asarray(hr, np.uint8),
                      np.asarray(sr, np.uint8))
    if fmt == "lmdb":
        return stem, (_tif_bytes(lr), _tif_bytes(hr), _tif_bytes(sr))
    lr.save(f"{out_path}/lr_{sizes[0]}/{stem}.png")
    hr.save(f"{out_path}/hr_{sizes[1]}/{stem}.png")
    sr.save(f"{out_path}/sr_{sizes[0]}_{sizes[1]}/{stem}.png")
    return stem, None


def prepare(img_path: str, out_path: str, n_worker: int = 4,
            sizes=(64, 256), pack: bool = False, lmdb: bool = False,
            verbose: bool = True):
    fmt = "lmdb" if lmdb else ("pack" if pack else "folder")
    files = sorted(p for p in Path(img_path).glob("**/*") if p.is_file())
    if fmt == "folder":
        for sub in (f"lr_{sizes[0]}", f"hr_{sizes[1]}",
                    f"sr_{sizes[0]}_{sizes[1]}"):
            os.makedirs(f"{out_path}/{sub}", exist_ok=True)
    else:
        os.makedirs(out_path, exist_ok=True)

    tasks = [(str(f), out_path, tuple(sizes), fmt) for f in files]
    results = []
    if n_worker > 1:
        with ProcessPoolExecutor(
                max_workers=n_worker,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            for i, res in enumerate(ex.map(_worker, tasks, chunksize=16)):
                results.append(res)
                if verbose and (i + 1) % 200 == 0:
                    print(f"\r{i + 1}/{len(tasks)} images processed",
                          end=" ", flush=True)
    else:
        for i, task in enumerate(tasks):
            results.append(_worker(task))
            if verbose and (i + 1) % 200 == 0:
                print(f"\r{i + 1}/{len(tasks)} images processed",
                      end=" ", flush=True)
    if verbose:
        print(f"\rdone: {len(tasks)} images")

    if fmt == "pack":
        results.sort(key=lambda r: r[0])
        lrs = np.stack([r[1][0] for r in results])
        hrs = np.stack([r[1][1] for r in results])
        srs = np.stack([r[1][2] for r in results])
        np.save(f"{out_path}/lr_{sizes[0]}.npy", lrs)
        np.save(f"{out_path}/hr_{sizes[1]}.npy", hrs)
        np.save(f"{out_path}/sr_{sizes[0]}_{sizes[1]}.npy", srs)
    elif fmt == "lmdb":
        from .lmdb_lite import write_lmdb
        # keys use the SEQUENTIAL stem-sorted index, not the filename stem
        # the reference writes (prepare_data_mfe_dm.py:82-89): the LMDB
        # read contract on both sides is 'hr_{r}_{index:05d}'
        # (LRHR_dataset.py:63-69), which the reference's own writer only
        # satisfies for numerically-named sources — sequential indices
        # satisfy it for any source and stay readable by reference users
        results.sort(key=lambda r: r[0])
        entries = {"length": str(len(results)).encode()}
        for i, (_stem, (lr_b, hr_b, sr_b)) in enumerate(results):
            entries[f"lr_{sizes[0]}_{i:05d}"] = lr_b
            entries[f"hr_{sizes[1]}_{i:05d}"] = hr_b
            entries[f"sr_{sizes[0]}_{sizes[1]}_{i:05d}"] = sr_b
        write_lmdb(out_path, entries)
    return len(tasks)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Tile source images into paired lr/hr/sr sets")
    p.add_argument("--path", "-p", type=str, required=True)
    p.add_argument("--out", "-o", type=str, required=True)
    p.add_argument("--size", type=str, default="64,256")
    p.add_argument("--n_worker", type=int, default=4)
    p.add_argument("--pack", action="store_true",
                   help="write mmap-able .npy packs instead of folders "
                        "(datatype npy)")
    p.add_argument("--lmdb", "-l", action="store_true",
                   help="write the reference's LMDB layout "
                        "(prepare_data_mfe_dm.py --lmdb)")
    args = p.parse_args(argv)
    if args.pack and args.lmdb:
        raise SystemExit("--pack and --lmdb are mutually exclusive")
    sizes = [int(s.strip()) for s in args.size.split(",")]
    out = f"{args.out}_{sizes[0]}_{sizes[1]}"
    prepare(args.path, out, args.n_worker, sizes=sizes, pack=args.pack,
            lmdb=args.lmdb)


if __name__ == "__main__":
    main()
