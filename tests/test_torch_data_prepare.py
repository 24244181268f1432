"""The port's data-prep path against the JAX package: ``data/lmdb_lite.py``
(the same file bytes, each package reading the other's files),
``data/prepare.py`` in its three formats, ``datatype: lmdb`` in
``LRHRDataset`` (and through ``cli.sr_mfe``'s device cache), EDiffSR's
``*lmdb`` dataroots, and the 17 ``demo_ucm_native_*`` configs (byte-equal
copies, parsed, built at their width). Tiny seeded inputs."""

import functools
import json
import logging
import os
import pickle
import random

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from fastdiffsr_tpu.data import lmdb_lite as jlmdb
from fastdiffsr_tpu.data import prepare as jprep
from fastdiffsr_tpu.data.dataset import LRHRDataset as JaxLRHRDataset
from fastdiffsr_tpu.diffusion import DiffusionSpec as JaxSpec
from fastdiffsr_tpu.ediffsr import data as jedata
from fastdiffsr_tpu_torch.data import LRHRDataset, create_dataloader
from fastdiffsr_tpu_torch.data import lmdb_lite as tlmdb
from fastdiffsr_tpu_torch.data import prepare as tprep
from fastdiffsr_tpu_torch.ediffsr import data as tedata
from tests.conftest import REPO_ROOT

torch.set_num_threads(2)

JAX_CONFIGS = REPO_ROOT / "fastdiffsr_tpu" / "configs"
PORT_CONFIGS = REPO_ROOT / "fastdiffsr_tpu_torch" / "configs"
DEMO = sorted(p.name for p in JAX_CONFIGS.glob("demo_ucm_native_*.json"))


# ------------------------------------------------------------- LMDB --

def _items(case):
    """Entries of one LMDB case: a dict, or (key, value) pairs with a
    repeated key (the last value wins)."""
    rnd = random.Random(0)
    if case == "small":
        return {f"k{i:03d}": bytes([i]) * (i * 7 % 50 + 1) for i in range(10)}
    if case == "multilevel_overflow":
        # ~1000 leaves of large values: a three-level tree with overflow
        # chains of up to three pages
        return {f"key_{rnd.randrange(10 ** 9):09d}_{i}":
                rnd.randbytes(rnd.choice([5, 40, 300, 2000, 2500, 12000]))
                for i in range(3000)}
    if case == "empty":
        return {}
    if case == "pairs":
        return [(b"b", b"1"), (b"a", b"2"), (b"b", b"3")]
    size = int(case.split("_")[1])       # the inline -> overflow threshold
    return {f"s{size}": b"z" * size, "tiny": b"q"}


LMDB_CASES = ["small", "multilevel_overflow", "empty", "pairs"] + [
    f"boundary_{n}" for n in (2020, 2030, 2031, 4080, 4081, 8176, 8177,
                              100000)]


def _as_dict(items):
    pairs = items.items() if isinstance(items, dict) else items
    return {(k.encode() if isinstance(k, str) else k): v for k, v in pairs}


@pytest.mark.parametrize("case", LMDB_CASES)
def test_write_lmdb_bytes_equal_jax_and_cross_read(tmp_path, case):
    """write_lmdb writes JAX's bytes for the same entries, and each
    package's reader reads the other's file: every entry, its length,
    sorted iteration, a missing key."""
    items = _items(case)
    info = tlmdb.write_lmdb(str(tmp_path / "port"), items)
    jinfo = jlmdb.write_lmdb(str(tmp_path / "jax"), items)
    assert info == jinfo
    ours = (tmp_path / "port" / "data.mdb").read_bytes()
    assert ours == (tmp_path / "jax" / "data.mdb").read_bytes()
    want = _as_dict(items)
    for reader, root in ((tlmdb.LmdbReader, "jax"),
                         (jlmdb.LmdbReader, "port")):
        with reader(str(tmp_path / root)) as r:
            assert len(r) == len(want)
            assert dict(r.items()) == want
            assert r.keys() == sorted(want)
            assert r.get(b"missing") is None
            if case == "multilevel_overflow":
                assert r.depth >= 3 and info["depth"] >= 3
                for k in random.Random(1).sample(sorted(want), 200):
                    assert r.get(k) == want[k]


def test_lmdb_file_form_and_str_keys(tmp_path):
    """subdir=False writes the file itself; a reader takes the file or its
    directory, and str keys as utf-8."""
    path = str(tmp_path / "one" / "x.mdb")
    tlmdb.write_lmdb(path, {"é": b"v"}, subdir=False)
    jlmdb.write_lmdb(str(tmp_path / "j.mdb"), {"é": b"v"}, subdir=False)
    assert (tmp_path / "one" / "x.mdb").read_bytes() == \
        (tmp_path / "j.mdb").read_bytes()
    r = tlmdb.LmdbReader(path)
    assert r.get("é") == b"v" and len(r) == 1
    r.close()


@pytest.mark.parametrize("key", ["", "x" * 600])
def test_write_lmdb_rejects_bad_keys(tmp_path, key):
    with pytest.raises(tlmdb.LmdbError):
        tlmdb.write_lmdb(str(tmp_path / "bad"), {key: b"v"})


def test_lmdb_reader_rejects_other_files(tmp_path):
    (tmp_path / "data.mdb").write_bytes(b"\0" * 8192)
    with pytest.raises(tlmdb.LmdbError, match="magic"):
        tlmdb.LmdbReader(str(tmp_path))


# ---------------------------------------------------------- prepare --

def _write_sources(root, n=5, seed=0):
    """Seeded RGB PNG sources: smoothed noise, square and oblong (the
    shorter side is resized, then centre-cropped)."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        h, w = (40, 48) if i % 2 else (36, 36)
        small = rng.integers(0, 256, (h // 4, w // 4, 3), dtype=np.uint8)
        img = Image.fromarray(small).resize((w, h), Image.BICUBIC)
        img.save(f"{root}/{i}.png")
    return str(root)


def _tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """The sources prepared at (8, 32) by both packages in the three
    formats: {(package, format): dir}. The port's folder run uses its
    process pool (2 spawn workers)."""
    base = tmp_path_factory.mktemp("prep")
    src = _write_sources(str(base / "src"))
    out = {}
    for fmt in ("folder", "pack", "lmdb"):
        kw = dict(sizes=(8, 32), pack=fmt == "pack", lmdb=fmt == "lmdb",
                  verbose=False)
        out["port", fmt] = str(base / f"port_{fmt}")
        n = tprep.prepare(src, out["port", fmt],
                          n_worker=2 if fmt == "folder" else 1, **kw)
        assert n == 5
        out["jax", fmt] = str(base / f"jax_{fmt}")
        jprep.prepare(src, out["jax", fmt], n_worker=1, **kw)
    return out


@pytest.mark.parametrize("fmt", ["folder", "pack", "lmdb"])
def test_prepare_writes_jax_bytes(prepared, fmt):
    """Every file the port's prepare writes equals JAX's, byte for byte:
    PNGs (folder), .npy packs, the LMDB file of TIFF tiles."""
    ours, theirs = (_tree_bytes(prepared[p, fmt]) for p in ("port", "jax"))
    assert sorted(ours) == sorted(theirs)
    want = {"folder": 15, "pack": 3, "lmdb": 1}[fmt]
    assert len(ours) == want
    for k in ours:
        assert ours[k] == theirs[k], k


def test_prepare_main_and_its_format_flags(tmp_path):
    src = _write_sources(str(tmp_path / "src"), n=2)
    tprep.main(["-p", src, "-o", str(tmp_path / "o"), "--size", "8,32",
                "--pack", "--n_worker", "1"])
    hr = np.load(tmp_path / "o_8_32" / "hr_32.npy")
    assert hr.shape == (2, 32, 32, 3) and hr.dtype == np.uint8
    with pytest.raises(SystemExit):
        tprep.main(["-p", src, "-o", str(tmp_path / "o"), "--pack",
                    "--lmdb"])


def _dataset(cls, root, datatype, **kw):
    return cls(root, datatype=datatype, l_resolution=8, r_resolution=32,
               need_LR=True, **kw)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lmdb_dataset_equals_folder(prepared, writer):
    """LRHRDataset(datatype='lmdb') on an LMDB the port or JAX prepared
    equals 'img' on the port's folder and JAX's lmdb dataset: every item
    (HR, SR, LR), raw_uint8, and a missing index raises KeyError."""
    ds_img = _dataset(LRHRDataset, prepared["port", "folder"], "img",
                      split="val")
    ds_l = _dataset(LRHRDataset, prepared[writer, "lmdb"], "lmdb",
                    split="val")
    ds_j = _dataset(JaxLRHRDataset, prepared[writer, "lmdb"], "lmdb",
                    split="val")
    assert len(ds_l) == len(ds_img) == len(ds_j) == 5
    for i in range(5):
        a, b, c = ds_img[i], ds_l[i], ds_j[i]
        for k in ("HR", "SR", "LR"):
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(c[k], b[k])
    raw_l, raw_img = ds_l.raw_uint8(), ds_img.raw_uint8()
    for k in ("HR", "SR"):
        assert raw_l[k].dtype == np.uint8
        assert raw_l[k].shape == (5, 32, 32, 3)
        np.testing.assert_array_equal(raw_l[k], raw_img[k])
        np.testing.assert_array_equal(raw_l[k], ds_j.raw_uint8()[k])
    with pytest.raises(KeyError, match="hr_32_00099"):
        ds_l[99]
    # data_len truncates the raw arrays too
    short = LRHRDataset(prepared[writer, "lmdb"], datatype="lmdb",
                        l_resolution=8, r_resolution=32, data_len=2)
    assert short.raw_uint8()["HR"].shape[0] == len(short) == 2


def test_lmdb_dataset_counts_hr_keys_without_length(tmp_path):
    """Files without a 'length' key: the hr_* keys are counted."""
    tile = tprep._tif_bytes(Image.fromarray(np.zeros((4, 4, 3), np.uint8)))
    tlmdb.write_lmdb(str(tmp_path / "env"), {
        f"{s}_{i:05d}": tile for s in ("hr_4", "sr_2_4") for i in range(3)})
    ds = LRHRDataset(str(tmp_path / "env"), datatype="lmdb",
                     l_resolution=2, r_resolution=4)
    assert len(ds) == 3 and ds[2]["HR"].shape == (4, 4, 3)


def test_lmdb_train_loader_equals_folder(prepared):
    """A shuffled, flipped train epoch over the LMDB (two loader threads
    sharing its reader) yields the folder's batches."""
    opt = {"batch_size": 2, "use_shuffle": True, "num_workers": 2}
    got = [list(create_dataloader(_dataset(
        LRHRDataset, prepared["port", fmt], dt, split="train"), opt,
        "train")) for fmt, dt in (("folder", "img"), ("lmdb", "lmdb"))]
    assert len(got[0]) == len(got[1]) == 2
    for a, b in zip(*got):
        for k in ("HR", "SR", "LR", "Index"):
            np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture
def _fresh_loggers(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    yield
    for name in ("base", "val"):
        lg = logging.getLogger(name)
        for h in list(lg.handlers):
            lg.removeHandler(h)
            h.close()


@pytest.mark.parametrize("cache", [True, False])
def test_sr_mfe_trains_s8hg_on_lmdb_like_on_folder(prepared, tmp_path,
                                                   _fresh_loggers, cache):
    """cli.sr_mfe -p train of demo_ucm_native_8_64_s8hg.json (the SSIM
    term on, weight 0.2, pow 2), narrowed to inner 8 at 8->32, on the LMDB
    and on the folder the port prepared: the l_pix sequences are equal
    bit for bit, with the device cache (its raw_uint8 upload) and with the
    loader."""
    from fastdiffsr_tpu_torch.cli import sr_mfe
    cfg = json.loads((PORT_CONFIGS / "demo_ucm_native_8_64_s8hg.json")
                     .read_text())
    cfg["path"]["resume_state"] = None
    cfg["model"]["unet"].update(inner_channel=8, norm_groups=4,
                                channel_multiplier=[1, 2], res_blocks=1,
                                attn_res=[])
    cfg["model"]["diffusion"]["image_size"] = 32
    cfg["train"].update(n_iter=3, val_freq=1000, print_freq=1,
                        save_checkpoint_freq=1000)
    losses = {}
    for fmt, dt in (("folder", "img"), ("lmdb", "lmdb")):
        cfg["name"] = f"s8hg_{fmt}"
        for ds in cfg["datasets"].values():
            ds.update(dataroot=prepared["port", fmt], datatype=dt,
                      r_resolution=32, batch_size=2, num_workers=1)
        cfg["datasets"]["train"]["device_cache"] = cache
        path = tmp_path / f"{fmt}.json"
        path.write_text(json.dumps(cfg))
        out = sr_mfe.main(["-p", "train", "-c", str(path), "--device",
                           "cpu"])
        losses[fmt] = out["l_pix"]
    assert len(losses["lmdb"]) == 3 and np.isfinite(losses["lmdb"]).all()
    assert losses["lmdb"] == losses["folder"]


# ------------------------------------------------------ EDiffSR lmdb --

def _basicsr_env(root, imgs, one_resolution=False):
    """A BasicSR-style LMDB env of ``imgs``: cv2-order (BGR) raw bytes per
    key, meta_info.pkl with the keys and 'C_H_W' shapes."""
    keys = [f"{i:05d}" for i in range(len(imgs))]
    items = {k: (a[..., ::-1] if a.shape[2] == 3 else a).tobytes()
             for k, a in zip(keys, imgs)}
    tlmdb.write_lmdb(root, items)
    res = [f"{a.shape[2]}_{a.shape[0]}_{a.shape[1]}" for a in imgs]
    with open(os.path.join(root, "meta_info.pkl"), "wb") as f:
        pickle.dump({"name": "t", "keys": keys,
                     "resolution": res[:1] if one_resolution else res}, f)
    return root


def _ediffsr_roots(tmp_path, channels=3):
    rng = np.random.default_rng(1)
    roots = {}
    for name, size in (("gt", 32), ("lq", 8)):
        folder = tmp_path / name
        folder.mkdir()
        imgs = [rng.integers(0, 256, (size, size, channels), dtype=np.uint8)
                for _ in range(3)]
        for i, a in enumerate(imgs):
            Image.fromarray(a if channels == 3 else a[..., 0]).save(
                folder / f"{i:05d}.png")
        env = _basicsr_env(str(tmp_path / f"{name}.lmdb"), imgs,
                           one_resolution=channels == 1)
        roots[name] = (str(folder), env)
    return roots


@pytest.mark.parametrize("mode", ["LQGT", "GT", "LQ"])
@pytest.mark.parametrize("phase", ["val", "train"])
def test_ediffsr_lmdb_root_equals_folder_and_jax(tmp_path, mode, phase):
    """An EDiffSR dataset over lmdb GT/LQ roots equals the port's over the
    folders (val: deterministic) and JAX's over the same lmdb roots with
    the same seed (train: the same crops and flips)."""
    roots = _ediffsr_roots(tmp_path)
    base = {"mode": mode, "phase": phase, "scale": 4, "seed": 0,
            "GT_size": 16}

    def opt(i):
        o = dict(base)
        if mode in ("LQGT", "GT"):
            o["dataroot_GT"] = roots["gt"][i]
        if mode in ("LQGT", "LQ"):
            o["dataroot_LQ"] = roots["lq"][i]
        return o

    ours = tedata.create_ediffsr_dataset(opt(1))
    theirs = jedata.create_ediffsr_dataset(opt(1))
    folder = tedata.create_ediffsr_dataset(opt(0))
    assert len(ours) == len(theirs) == len(folder) == 3
    for i in range(3):
        a, b = ours[i], theirs[i]
        keys = [k for k in ("GT", "LQ") if k in a]
        assert keys and keys == [k for k in ("GT", "LQ") if k in b]
        for k in keys:
            np.testing.assert_array_equal(a[k], b[k])
            if phase == "val":
                np.testing.assert_array_equal(a[k], folder[i][k])


def test_ediffsr_lmdb_one_channel_and_missing_key(tmp_path):
    """A 1-channel env with one shared resolution reads as gray RGB, equal
    to the folder of L PNGs; a key missing from the file raises."""
    roots = _ediffsr_roots(tmp_path, channels=1)
    base = {"mode": "LQGT", "phase": "val", "scale": 4}
    ds_l = tedata.create_ediffsr_dataset(
        {**base, "dataroot_GT": roots["gt"][1], "dataroot_LQ": roots["lq"][1]})
    ds_f = tedata.create_ediffsr_dataset(
        {**base, "dataroot_GT": roots["gt"][0], "dataroot_LQ": roots["lq"][0]})
    for i in range(3):
        for k in ("GT", "LQ"):
            np.testing.assert_array_equal(ds_l[i][k], ds_f[i][k])
    keys, read01 = tedata._open_source(roots["gt"][1])
    with open(os.path.join(roots["gt"][1], "meta_info.pkl"), "rb") as f:
        meta = pickle.load(f)
    meta["keys"].append("99999")
    with open(os.path.join(roots["gt"][1], "meta_info.pkl"), "wb") as f:
        pickle.dump(meta, f)
    keys, read01 = tedata._open_source(roots["gt"][1])
    with pytest.raises(KeyError, match="99999"):
        read01(keys[-1])


# ---------------------------------------------------- demo configs --

def _resume_root(tmp_path, cfg):
    """A run directory under ``tmp_path`` that the config's resume_state
    pattern matches (the configs resume from their own earlier runs)."""
    rs = cfg["path"].get("resume_state")
    if rs:
        os.makedirs(tmp_path / rs.replace("*", "run1"))
    return str(tmp_path)


@pytest.mark.parametrize("name", DEMO)
def test_demo_config_is_jax_copy_and_parses_like_jax(tmp_path, name):
    """The port's copy is byte-equal to JAX's, and both packages' config
    parse of it agree on every section (resume_state resolved by its glob
    in both)."""
    from fastdiffsr_tpu.config import parse as jax_parse
    from fastdiffsr_tpu_torch.config import parse
    assert len(DEMO) == 17
    ours_path = PORT_CONFIGS / name
    assert ours_path.read_bytes() == (JAX_CONFIGS / name).read_bytes()
    cfg = json.loads(ours_path.read_text())
    ours = parse(str(ours_path), "train",
                 root=_resume_root(tmp_path / "a", cfg))
    theirs = jax_parse(str(JAX_CONFIGS / name), "train",
                       root=_resume_root(tmp_path / "b", cfg))
    for key in ("datasets", "model", "train", "phase", "name"):
        assert ours[key] == theirs[key], key
    rs = ours["path"]["resume_state"]
    assert (rs is None) == (cfg["path"].get("resume_state") is None)
    if rs:
        assert os.path.isdir(rs) and "run1" in rs


@functools.lru_cache(maxsize=None)
def _jax_param_count(variant, unet_json, image_size):
    """Parameters of the JAX package's UNet for a config, from
    ``jax.eval_shape`` of its init (nothing is computed)."""
    from fastdiffsr_tpu.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu.models.unet_guided import guided_unet_from_config
    from fastdiffsr_tpu.models.unet_sr3 import sr3_unet_from_config
    unet = json.loads(unet_json)
    net = (unet_from_config(unet) if variant == "fastdiffsr" else
           guided_unet_from_config(unet, image_size=image_size)
           if variant == "gdp" else
           sr3_unet_from_config(unet, image_size=image_size))
    shapes = jax.eval_shape(
        net.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, image_size, image_size, net.in_channel),
                             jnp.float32),
        jax.ShapeDtypeStruct((1,), jnp.float32))
    return sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("name", DEMO)
def test_demo_config_builds_at_its_width(monkeypatch, name):
    """sr_mfe.build_all builds the config's engines and UNet at its width
    (the weight initialisers stubbed out: their values are not under
    test): the variant's spec, the SSIM term's weight and power as the
    config gives them, and as many parameters as the JAX package's UNet."""
    from fastdiffsr_tpu_torch.cli import sr_mfe
    from fastdiffsr_tpu_torch.config import load_json_config
    for fn in ("trunc_normal_", "kaiming_uniform_", "uniform_", "normal_"):
        monkeypatch.setattr(torch.nn.init, fn, lambda t, *a, **k: t)
    opt = load_json_config(str(PORT_CONFIGS / name))
    eng_train, eng_val, net = sr_mfe.build_all(opt, torch.device("cpu"))
    variant = opt["model"]["which_model_G"]
    diff = opt["model"]["diffusion"]
    for eng in (eng_train, eng_val):
        assert vars(eng.spec) == vars(JaxSpec.for_variant(variant))
    assert eng_train.aux_ssim_weight == float(diff.get("aux_ssim_weight", 0))
    assert eng_train.aux_ssim_gamma_pow == float(
        diff.get("aux_ssim_gamma_pow", 0))
    assert eng_val.aux_ssim_weight == 0.0
    assert eng_train.buffers.num_timesteps == int(
        opt["model"]["beta_schedule"]["train"]["n_timestep"])
    n = sum(p.numel() for p in net.parameters())
    assert n == _jax_param_count(variant, json.dumps(opt["model"]["unet"]),
                                 int(diff["image_size"]))
