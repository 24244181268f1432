"""Narrow copies of the benchmark's cells for tests on the CPU: the same
depth and the same code paths at inner width 8, 4 groups, 16x16 tiles
(attention at 16 in SR3), batches of 2."""

from __future__ import annotations

import copy

from perfbench.harness.cells import Cell, load_cell


def tiny_cell(name: str, **traffic) -> Cell:
    cell = load_cell(name)
    cfg = copy.deepcopy(cell.config)
    unet = cfg["model"]["unet"]
    unet.update(inner_channel=8, norm_groups=4, channel_multiplier=[1, 2])
    cfg["model"]["diffusion"]["image_size"] = 16
    tr = dict(cell.traffic)
    if tr["runner"] == "sample_closed_loop":
        tr.update(batch=2, pool_tiles=6, max_batches=8, warmup_batches=1,
                  trace_batches=1, check_images=2, dtype="f32")
    else:
        tr.update(batch=2, pool_tiles=8, max_steps=16, warmup_steps=3,
                  trace_steps=1)
    tr.update(traffic)
    return Cell(name=name, spec=cell.spec, config=cfg, traffic=tr)
