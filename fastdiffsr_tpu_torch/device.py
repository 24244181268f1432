"""Device resolution for the port's entry points.

Entry points take ``device`` and default to ``"cuda"``. Asking for CUDA
where none is visible raises: the port never moves to the CPU on its own.
Only an explicit ``"cpu"`` runs there (the tests do).

:func:`use_ieee_float32` fixes what "float32" means for the entry points:
PyTorch lets cuDNN run float32 convolutions in TF32 by default, and the
port's float32 results, its parity checks against the JAX package and its
measured training rates all assume full float32.
:func:`set_cudnn_autotuning` sets how cuDNN picks each convolution's
algorithm. For those full-float32 convolutions PyTorch's default
heuristics pick algorithms that train several times slower, with several
times the workspace, than the ones cuDNN finds by timing them; at the
evaluation CLIs' shapes the timed ones were no faster, and the timing
costs set-up and workspace (``PERF.md``). So training times them and
evaluation keeps the heuristics.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested (the default) but no CUDA "
            "device is visible; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    return dev


def use_ieee_float32() -> None:
    """Run float32 convolutions and matmuls in full float32 (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def set_cudnn_autotuning(on: bool) -> None:
    """``on``: cuDNN times its algorithms for each new convolution shape
    and keeps the fastest, once per shape and process; off: it picks by
    its heuristics (PyTorch's default)."""
    torch.backends.cudnn.benchmark = bool(on)
