"""Multi-process data parallelism on ``torch.distributed``.

Counterpart of ``fastdiffsr_tpu/parallel/multihost.py`` (the reference's
EDiffSR DDP over NCCL, EDiffSR/codes/config/sisr/train.py:28-40). One
process per GPU, launched by ``torchrun``, which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``:

    torchrun --nproc_per_node=<GPUs> -m fastdiffsr_tpu_torch.cli.sr_mfe \\
        -p train -dist -c <config.json>

:func:`initialize_from_env` joins the group: NCCL on ``cuda:{LOCAL_RANK}``,
gloo for ``--device cpu`` (the CPU tests). It raises when a variable is
missing (a ``-dist`` run never quietly becomes one process) and when
NCCL is missing on CUDA (no gloo on the GPU). The other helpers are
no-ops without a process group, so the single-process paths call them
unchanged: :func:`data_parallel` wraps a net in
``DistributedDataParallel`` (gradients averaged over the ranks in the
backward), :func:`broadcast_from_main` is ``replicate`` (every rank
takes rank 0's tensors), :func:`all_reduce_mean` / :func:`all_reduce_sum`
reduce logged scalars and metric sums. :func:`average_gradients` is
DDP's averaging without DDP, for the chained train step's CUDA graph.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")
# rank 0 validates and saves while the others wait at a barrier
TIMEOUT = datetime.timedelta(minutes=30)


def initialize_from_env(device="cuda", flag: str = "-dist") -> torch.device:
    """Join the process group torchrun describes and return this rank's
    device: ``cuda:{LOCAL_RANK}`` (set as the current device) for a CUDA
    ``device``, the CPU for ``"cpu"``. Joins once per process; a later
    call returns the device only. ``flag`` names the caller's option in
    the error messages."""
    missing = [k for k in TORCHRUN_VARS if not os.environ.get(k)]
    if missing:
        raise RuntimeError(
            f"{flag} joins the process group torchrun describes, but "
            f"{', '.join(missing)} {'is' if len(missing) == 1 else 'are'} "
            "not set: launch with torchrun --nproc_per_node=<GPUs> -m ...")
    from ..device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dist.is_initialized():
        return dev
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError(f"{flag} on CUDA needs NCCL, which this "
                               "PyTorch build lacks (there is no gloo "
                               "fallback on the GPU)")
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, timeout=TIMEOUT)
    else:
        dist.init_process_group("gloo", timeout=TIMEOUT)
    return dev


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def local_batch(batch_size: int) -> int:
    """This rank's rows of a global batch of ``batch_size``, which must
    divide over the ranks."""
    world = world_size()
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} must divide evenly over "
                         f"{world} processes")
    return batch_size // world


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Leave the process group (the end of a ``-dist`` CLI run)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _comm_device() -> torch.device:
    """Where a collective's tensors live: the rank's GPU under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_from_main(obj):
    """Overwrite, in place, every rank's tensors with rank 0's: a
    module's parameters and buffers, or the values of a dict or the items
    of a sequence of tensors. Returns ``obj``."""
    if not dist.is_initialized():
        return obj
    if isinstance(obj, torch.nn.Module):
        tensors = list(obj.state_dict().values())
    elif isinstance(obj, dict):
        tensors = list(obj.values())
    else:
        tensors = list(obj)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)
    return obj


def broadcast_object(value):
    """Rank 0's ``value`` (picklable) on every rank."""
    if not dist.is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of a tensor on the rank's device (a new
    tensor; ``x`` is unchanged)."""
    if not dist.is_initialized():
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y / dist.get_world_size()


def average_gradients(params) -> None:
    """Average the gradients of ``params`` over the ranks in place, as DDP
    does: each scaled by 1/W (the reducer's factor), then summed by one
    all-reduce over ``WORLD`` of a flat buffer of them. Nothing without a
    process group. It keeps no host state between calls, so a CUDA graph
    can hold it (the chained train step's, ``train.steps``), and runs
    eagerly on gloo as on NCCL."""
    if not dist.is_initialized():
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    flat.mul_(1.0 / dist.get_world_size())
    dist.all_reduce(flat, group=dist.group.WORLD)
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def all_reduce_sum(x) -> np.ndarray:
    """The sum over the ranks of an array of numbers, as float64 numpy."""
    arr = np.array(x, dtype=np.float64)
    if not dist.is_initialized():
        return arr
    t = torch.from_numpy(arr).to(_comm_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def sample_group(batch_size: int):
    """The process group of the ranks that sample a batch of
    ``batch_size`` split over them (``mesh.sample_rows``: the first
    ``auto_world`` ranks), for collectives among them alone; None without
    a process group or where one rank samples the whole batch. Every rank
    calls it, in the same order (``new_group`` is collective)."""
    if not dist.is_initialized():
        return None
    from .mesh import auto_world
    w = auto_world(batch_size, dist.get_world_size())
    if w == 1:
        return None
    if w == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(list(range(w)))


def data_parallel(net: torch.nn.Module) -> torch.nn.Module:
    """``net`` in ``DistributedDataParallel`` under a process group (its
    parameters broadcast from rank 0 at the wrap; its gradients averaged
    over the ranks during the backward), ``net`` itself otherwise. The
    buffers are not broadcast per forward: the port's nets hold constant
    buffers that every rank builds alike."""
    if not dist.is_initialized():
        return net
    from torch.nn.parallel import DistributedDataParallel
    dev = next(net.parameters()).device
    return DistributedDataParallel(
        net, device_ids=[dev] if dev.type == "cuda" else None,
        broadcast_buffers=False)
