"""The harness itself: new files are found by name, a run without a card
exits non-zero with no result, a sound run of a narrow cell on the CPU
is correct, and a run whose timed path is broken underneath is not, for
each fault the cells can have. On the card (``-m gpu``) the controls, the
references in the precision below each cell's, fail the cells' limits
at the cells' own sizes."""

import json
import pathlib
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench.harness import cells, check
from perfbench.tests.tiny import tiny_cell

ROOT = pathlib.Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 1001
SAMPLE, TRAIN = "fastdiffsr_x4.infer_b1_f32", "sr3_x4.train_b4"


def drive(cell, seed=SEED):
    out = cells.load_runner(cell.runner).run(
        cell, seed, 0.3, False, torch.device("cpu"), time.perf_counter())
    ok, _ = check.verdict(out.checks, cell.spec["limits"])
    return ok and out.failed == 0 and out.attempted > 0, out


def test_new_workload_and_metric_are_found(tmp_path):
    root = tmp_path / "perfbench"
    for sub in ("workloads", "configs", "traffic", "metrics", "runners"):
        shutil.copytree(cells.ROOT / sub, root / sub)
    spec = json.loads((root / "workloads" / f"{SAMPLE}.json").read_text())
    spec["traffic"] = "serve_b4_f32"
    (root / "workloads" / "fastdiffsr_x4.serve_b4_f32.json").write_text(
        json.dumps(spec))
    mix = json.loads((root / "traffic" / "infer_b1_f32.json").read_text())
    (root / "traffic" / "serve_b4_f32.json").write_text(
        json.dumps(dict(mix, batch=4)))
    (root / "metrics" / "evals_per_s.sample.py").write_text(
        'LAYER = "model step"\nUNIT = "1/s"\nMOVES = "sr_img_per_s"\n\n\n'
        'def read(ctx):\n    return ctx.evals / ctx.window_s\n')
    cell = cells.load_cell("fastdiffsr_x4.serve_b4_f32", root)
    assert cell.traffic["batch"] == 4 and cell.config["name"] == \
        "fastdiffsr_x4"
    readers = cells.metric_readers(root)
    assert "evals_per_s.sample" in readers
    assert set(readers) >= {"k3_roofline", "step_mfu.train"}
    # a mix of a new kind names a runner of its own, which brings the
    # units of the end-to-end metrics it reports
    (root / "traffic" / "open_loop.json").write_text(
        json.dumps({"runner": "open_loop", "rate_per_s": 8}))
    (root / "runners" / "open_loop.py").write_text(
        "from perfbench.harness.outcome import Outcome\n\n\n"
        "def run(cell, seed, seconds, traced, device, t_start):\n"
        "    return Outcome(e2e={'goodput': 1.0}, units={'goodput': "
        "'img/s'}, attempted=1, failed=0, checks={}, peak_bytes=0,\n"
        "                   setup_peak_bytes=0, setup_parts={}, "
        "summary=None, work={})\n")
    spec["traffic"] = "open_loop"
    (root / "workloads" / "fastdiffsr_x4.open_loop.json").write_text(
        json.dumps(spec))
    cell = cells.load_cell("fastdiffsr_x4.open_loop", root)
    out = cells.load_runner(cell.runner, root).run(
        cell, 1, 1.0, False, torch.device("cpu"), 0.0)
    assert out.units == {"goodput": "img/s"}
    assert cells.load_runner("train_steps", root).first_step(
        cell.config["train"]) == 5000
    with pytest.raises(SystemExit):
        cells.load_runner("../run", root)


def test_run_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", SAMPLE, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=str(ROOT),
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.parametrize("name", [SAMPLE, TRAIN, "fastdiffsr_x4.train_b4"])
def test_sound_narrow_run_is_correct(name):
    ok, out = drive(tiny_cell(name))
    assert ok, out.checks


def _half_batch_loss(orig):
    def loss(self, denoise_fn, batch, generator=None, *, noise=None,
             gamma=None, t=None):
        half = batch["HR"].shape[0] // 2
        cut = {k: v[:half] for k, v in batch.items()}
        return orig(self, denoise_fn, cut, generator,
                    noise=None if noise is None else noise[:half],
                    gamma=None if gamma is None else gamma[:half],
                    t=None if t is None else t[:half])
    return loss


def _half_batch_sampler(orig):
    def make(*a, **kw):
        fn = orig(*a, **kw)

        def sample_fn(cond, gens, **k):
            half = cond.shape[0] // 2
            out = fn(cond[:half], gens[:half], **k)
            return torch.cat([out, out])[:cond.shape[0]]
        return sample_fn
    return make


def _altered_answer(orig):
    def finish(self, x, cond):
        out = orig(self, x, cond).clone()
        out[0] += 0.05
        return out
    return finish


def _ema_copies(orig):
    return lambda decay, start, step: 0.0


FAULTS = {
    # a sampler step that returns its state unchanged
    "sample_step_unchanged": (SAMPLE, "diffusion.engine.DiffusionEngine."
                              "_ancestral_update",
                              lambda orig: lambda self, carry, *a: carry),
    # half of each batch served, the rest left out
    "sample_half_batch": (SAMPLE, "train.make_sample_fn", _half_batch_sampler),
    # one image's answer altered where it is produced
    "sample_answer_altered": (SAMPLE, "diffusion.engine.DiffusionEngine."
                              "_finish", _altered_answer),
    # a train step that leaves the state unchanged
    "train_state_unchanged": (TRAIN, "torch.optim.Adam.step",
                              lambda orig: lambda self, *a, **k: None),
    # half of the batch left out, the mean taken over the rest
    "train_half_batch": (TRAIN, "diffusion.engine.DiffusionEngine."
                         "training_loss", _half_batch_loss),
    # the EMA copies the parameters where it should blend them
    "train_ema_copies": (TRAIN, "train.steps._ema_decay", _ema_copies),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    import importlib
    name, target, wrap = FAULTS[fault]
    if not target.startswith("torch."):
        target = "fastdiffsr_tpu_torch." + target
    parts = target.split(".")
    for cut in range(len(parts) - 1, 0, -1):
        try:
            owner = importlib.import_module(".".join(parts[:cut]))
            break
        except ImportError:
            continue
    for attr in parts[cut:-1]:
        owner = getattr(owner, attr)
    monkeypatch.setattr(owner, parts[-1], wrap(getattr(owner, parts[-1])))
    ok, out = drive(tiny_cell(name))
    assert not ok, out.checks


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fastdiffsr_x4.serve_b16_bf16",
                                  "fastdiffsr_x4.infer_b1_f32",
                                  "sr3_x4.train_b4", "fastdiffsr_x4.train_b4"])
def test_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench.tools import controls
    cell = cells.load_cell(name)
    dev = torch.device("cuda", 0)
    if cell.runner == "sample_closed_loop":
        values = {"sr_gap": controls.sample_control(
            cell, SEED, dev, controls.CONTROL[cell.traffic["dtype"]])}
    else:
        values = controls.train_control(cell, SEED, dev, "tf32")
    ok, rows = check.verdict(values, cell.spec["limits"])
    assert not ok, rows


def test_manifest_matches_the_files():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    readers = cells.metric_readers()
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        mod = readers[m["name"]]
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"],
                                                    m["moves"])
    for w in manifest["workloads"]:
        cell = cells.load_cell(w["name"])
        assert (cell.spec["config"], cell.spec["traffic"], cell.chips,
                cell.spec["why"]) == (w["config"], w["traffic"], w["chips"],
                                      w["why"])
        reported = {n for n, m in e2e.items()
                    if w["name"] in m.get("workloads", [w["name"]])}
        assert set(cell.spec["end_to_end"]) == reported


class _Event:
    def __init__(self, name, start_s, end_s, device="cuda"):
        from torch.autograd import DeviceType
        self.name = name
        self.device_type = (DeviceType.CUDA if device == "cuda"
                            else DeviceType.CPU)
        self.is_user_annotation = False
        self.time_range = type("R", (), {"start": start_s * 1e6,
                                         "end": end_s * 1e6})()


def test_trace_summary_maps_the_device_clock_onto_the_host():
    # the device's clock reads 100 s more than the host's; the marker
    # starts 10 us after the window opens at host time 5.0
    from perfbench.harness.trace import Summary
    d = 100.0
    events = [_Event("spin_kernel(long)", 5.00001 + d, 5.00002 + d),
              _Event("conv_a", 5.1 + d, 5.3 + d),
              _Event("conv_b", 5.2 + d, 5.4 + d),     # overlaps conv_a
              _Event("cudaLaunchKernel", 5.0 + d, 5.9 + d, device="cpu"),
              _Event("late", 6.5 + d, 6.6 + d)]       # after the window
    spans = [("batch_draw", 5.0, 5.1), ("sample_fn", 5.1, 5.5),
             ("sync", 5.5, 6.0)]
    s = Summary(events, 5.0, 6.0, spans)
    assert s.window_s == pytest.approx(1.0)
    assert s.busy_s == pytest.approx(0.3, abs=1e-5)
    assert s.kernel_s("conv_") == pytest.approx(0.4, abs=1e-5)
    gaps = dict(s.idle_gaps())
    assert gaps["sync"] == pytest.approx(0.6, abs=1e-4)
    assert gaps["batch_draw"] == pytest.approx(0.1, abs=1e-4)
    assert [n for n, _ in s.top_kernels()] == ["conv_a", "conv_b"]
    with pytest.raises(RuntimeError):
        Summary(events[1:], 5.0, 6.0, spans)


@pytest.mark.parametrize("name", [SAMPLE, TRAIN])
def test_traced_run_reports_its_layers_at_the_untraced_pace(name,
                                                            monkeypatch):
    # the CPU has no CUPTI: a window whose one device event spans half of
    # it stands in for the profiler; the rest of the run is as on the card
    import contextlib

    from perfbench.harness import report, trace

    @contextlib.contextmanager
    def window(spans, sync):
        w = trace.Window(None, spans)
        spans.on = True
        w.t0 = time.perf_counter()
        yield w
        w.t1 = time.perf_counter()
        spans.on = False
        mid = (w.t0 + w.t1) / 2
        events = [_Event("spin_kernel", w.t0 + 1e-6, w.t0 + 2e-6),
                  _Event("gn_swish_apply_kernel", w.t0, mid)]
        w.summary = lambda: trace.Summary(events, w.t0, w.t1, spans.items)

    monkeypatch.setattr(trace, "traced_window", window)
    cell = tiny_cell(name)
    out = cells.load_runner(cell.runner).run(
        cell, SEED, 0.3, True, torch.device("cpu"), time.perf_counter())
    assert out.work["pace_s"] > 0
    line, _ = report.result(cell, out, True, cells.metric_readers(), "cpu")
    assert line["correct"], line["checks"]
    idle = [v["value"] for k, v in line["metrics"].items()
            if k.startswith("device_idle.")]
    assert len(idle) == 1
    busy = line["device"]["busy_s"]
    assert idle[0] == pytest.approx(100 * (1 - busy / out.work["pace_s"]))
    assert any(k.startswith("step_mfu.") for k in line["metrics"])
    assert line["breakdown"]["device_ops"][0][0] == "gn_swish_apply_kernel"
    assert list(line)[-1] == "checks"
