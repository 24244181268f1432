"""How a batch splits over the ranks of a process group.

Counterpart of ``fastdiffsr_tpu/parallel/mesh.py``. JAX shards a batch
over a device mesh inside one SPMD program; here each rank is a process
that owns one GPU (``multihost.py``) and holds a contiguous block of the
global batch's rows:

- :func:`auto_world` is ``auto_mesh``'s rule: the largest divisor of the
  batch that fits the ranks (a gcd is wrong: batch 6 on 4 ranks has gcd
  2 but a valid 3-way split; batch 3 on 8 ranks has gcd 1 but 3 works).
- :func:`rank_rows` is ``shard_batch``'s split: rank p of W holds rows
  ``p*B/W .. (p+1)*B/W``, so the ranks' rows concatenated in rank order
  are the global batch.
- :func:`sample_rows` splits an evaluation batch over the ``auto_world``
  ranks that divide it; the others hold no rows of it.

Random draws that belong to the global batch (a rank keeps its rows of
them, so a W-rank step equals the 1-rank step) go through
:class:`RowGenerator` and :func:`rand_rows`.
"""

from __future__ import annotations

import torch


def auto_world(batch_size: int, world: int) -> int:
    """The largest divisor of ``batch_size`` that is <= ``world``."""
    b = int(batch_size)
    return next((d for d in range(min(b, int(world)), 1, -1)
                 if b % d == 0), 1)


def rank_rows(batch_size: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s contiguous block of a global batch split over
    ``world`` ranks; the batch must divide."""
    if batch_size % world:
        raise ValueError(f"batch {batch_size} does not divide over {world} "
                         "ranks")
    n = batch_size // world
    return slice(rank * n, (rank + 1) * n)


def sample_rows(batch_size: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of an evaluation batch split over
    ``auto_world(batch_size, world)`` ranks: an empty slice for a rank
    past them."""
    w = auto_world(batch_size, world)
    if rank >= w:
        return slice(0, 0)
    return rank_rows(batch_size, rank, w)


class RowGenerator:
    """A ``torch.Generator`` of a global batch of ``total`` rows, of which
    the holder computes ``rows``: :func:`rand_rows` draws the global
    batch's values and keeps those rows."""

    __slots__ = ("generator", "rows", "total")

    def __init__(self, generator: torch.Generator, rows: slice, total: int):
        self.generator = generator
        self.rows = rows
        self.total = int(total)


def rand_rows(shape, generator, device) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator``; from a
    :class:`RowGenerator`, its rows of the (total, *shape[1:]) draw."""
    if isinstance(generator, RowGenerator):
        full = torch.rand((generator.total, *shape[1:]),
                          generator=generator.generator, device=device)
        return full[generator.rows]
    return torch.rand(tuple(shape), generator=generator, device=device)
