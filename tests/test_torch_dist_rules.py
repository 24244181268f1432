"""The port's data-parallel rules against the JAX package's
(``fastdiffsr_tpu_torch/parallel``, the loader's process split), in one
process: ``auto_world`` against ``auto_mesh`` on the conftest's 8 CPU
devices, the rank split of the loader's index stream against JAX's
numpy ``DataLoader`` for the same arguments, the batches a rank loads,
and the row-sliced global draws. Exact equality throughout: these are
integer rules and the same numpy draws."""

import itertools

import jax
import numpy as np
import pytest
import torch

from fastdiffsr_tpu.data import dataset as jdata
from fastdiffsr_tpu.parallel import auto_mesh
from fastdiffsr_tpu_torch import parallel
from fastdiffsr_tpu_torch.data import dataset as tdata
from fastdiffsr_tpu_torch.data import write_pack
from fastdiffsr_tpu_torch.parallel import (RowGenerator, auto_world,
                                           rand_rows, rank_rows, sample_rows)

torch.set_num_threads(2)


def test_auto_world_is_auto_mesh():
    devices = jax.devices()
    assert len(devices) == 8
    for b, n in itertools.product(range(1, 17), range(1, 9)):
        mesh = auto_mesh(b, devices[:n])
        want = 1 if mesh is None else mesh.devices.size
        assert auto_world(b, n) == want, (b, n)
    # the gcd counter-examples of auto_mesh's comment
    assert auto_world(6, 4) == 3 and auto_world(3, 8) == 3


class _Sized:
    def __init__(self, n):
        self.n = n
        self.split = "train"

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n,batch,P,seed,epoch,ratio", [
    (10, 2, 2, 0, 0, 1), (10, 3, 2, 5, 1, 1), (7, 2, 3, 1, 2, 3),
    (16, 4, 4, 2, 0, 2), (5, 1, 4, 3, 4, 1), (9, 2, 1, 0, 3, 2)])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_rank_split_is_jaxs(n, batch, P, seed, epoch, ratio, shuffle):
    ds = _Sized(n)
    for p in range(P):
        kw = dict(batch_size=batch, shuffle=shuffle, seed=seed,
                  process_index=p, process_count=P, enlarge_ratio=ratio)
        ours, theirs = tdata.DataLoader(ds, **kw), jdata.DataLoader(ds, **kw)
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        np.testing.assert_array_equal(ours._indices(), theirs._indices())
        assert len(ours) == len(theirs)


def _fake_world(monkeypatch, world):
    """A process group of ``world`` ranks as the loaders see it."""
    for mod in (parallel, parallel.multihost):
        monkeypatch.setattr(mod, "world_size", lambda: world)


def test_rank_batches_concatenate_to_the_global_batch(tmp_path,
                                                      monkeypatch):
    """Two ranks' loaders of a global batch of 4 (flips included) give
    the one-process batches row for row, and JAX's loader the same rows.
    The set divides into global batches: otherwise the multi-process
    stream is padded to whole global batches and permuted at that
    length, as in JAX."""
    root = write_pack(str(tmp_path / "pack"), 8, 0, 8, 16)
    ds = tdata.LRHRDataset(root, datatype="npy", l_resolution=8,
                           r_resolution=16, split="train")
    jds = jdata.LRHRDataset(root, datatype="npy", l_resolution=8,
                            r_resolution=16, split="train")
    opt = {"batch_size": 4, "use_shuffle": True, "num_workers": 1}
    one = list(tdata.create_dataloader(ds, opt, "train",
                                       shard_by_process=True))
    _fake_world(monkeypatch, 2)
    ranks = []
    for r in range(2):
        monkeypatch.setattr(parallel, "rank", lambda r=r: r)
        loader = tdata.create_dataloader(ds, opt, "train",
                                         shard_by_process=True)
        assert loader.batch_size == 2 and loader.process_index == r
        ranks.append(list(loader))
        jl = jdata.DataLoader(jds, batch_size=2, shuffle=True,
                              process_index=r, process_count=2)
        for got, want in zip(ranks[-1], jl):
            np.testing.assert_array_equal(got["HR"], want["HR"])
    assert len(one) == len(ranks[0]) == len(ranks[1]) > 0
    for full, a, b in zip(one, *ranks):
        for k in ("HR", "SR", "Index"):
            np.testing.assert_array_equal(full[k],
                                          np.concatenate([a[k], b[k]]))


def test_loader_refuses_a_batch_that_does_not_divide(tmp_path,
                                                     monkeypatch):
    root = write_pack(str(tmp_path / "pack"), 6, 0, 8, 16)
    ds = tdata.LRHRDataset(root, datatype="npy", l_resolution=8,
                           r_resolution=16, split="train")
    _fake_world(monkeypatch, 3)
    with pytest.raises(ValueError, match="divide evenly over 3"):
        tdata.create_dataloader(ds, {"batch_size": 4}, "train",
                                shard_by_process=True)


def test_row_rules():
    assert [rank_rows(6, r, 3) for r in range(3)] == [
        slice(0, 2), slice(2, 4), slice(4, 6)]
    with pytest.raises(ValueError):
        rank_rows(5, 0, 2)
    # batch 6 over 4 ranks: 3 ranks hold 2 rows each, the 4th none
    assert [sample_rows(6, r, 4) for r in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(0, 0)]
    assert sample_rows(1, 0, 8) == slice(0, 1)


def test_rand_rows_keeps_the_global_draws_rows():
    full = torch.rand((6, 1, 1), generator=torch.Generator().manual_seed(3))
    for r in range(3):
        g = RowGenerator(torch.Generator().manual_seed(3), rank_rows(6, r, 3),
                         6)
        torch.testing.assert_close(rand_rows((2, 1, 1), g, "cpu"),
                                   full[2 * r:2 * r + 2], rtol=0, atol=0)
    plain = torch.Generator().manual_seed(3)
    torch.testing.assert_close(rand_rows((6, 1, 1), plain, "cpu"), full,
                               rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["infer", "msi"])
def test_other_entry_points_refuse_dist_without_torchrun(entry, tmp_path,
                                                         monkeypatch):
    """infer -dist and msi.main --launcher pytorch raise, naming the
    missing variables, as sr_mfe -dist and ediffsr -launcher do."""
    from fastdiffsr_tpu_torch.cli import infer
    from fastdiffsr_tpu_torch.msi import main as msi_main
    names = parallel.multihost.TORCHRUN_VARS
    for k in names:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="torchrun") as err:
        if entry == "infer":
            infer.main(["-c", "absent.json", "-dist", "--device", "cpu"])
        else:
            msi_main.main(["--launcher", "pytorch", "--device", "cpu",
                           "--save_dir", str(tmp_path)])
    assert all(k in str(err.value) for k in names)
