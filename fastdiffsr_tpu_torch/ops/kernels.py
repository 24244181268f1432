"""Build, load and count the port's hand-written CUDA kernels.

The sources in ``fastdiffsr_tpu_torch/csrc`` are compiled with ``nvcc``
for ``sm_90a`` (H100) at first use, one ``nvcc -c`` per source started
together, then linked into one shared library with a plain C interface
that is loaded with ``ctypes``. The library lands in ``build/kernels/``
at the repository root (listed in ``.gitignore``) under a name that
hashes the sources and flags, so an edited source is rebuilt. The ranks
of a ``torchrun`` job reach the first use together: one builds while the
others wait on a file lock beside the directory and then load its
library.

Each wrapper that launches a kernel adds one to its entry in
``LAUNCHES`` right after the launch, and nowhere else; a run resets the
counts with :func:`reset_launch_counts` and reads them afterwards to
show that its path went through the kernels.

A wrapper that is :func:`traced` (by ``torch.export``, or under a
dispatch mode such as ``FlopCounterMode``) calls its registered operator
(``ops/library.py``) instead: those see registered operators only, not a
``ctypes`` launch. Eager calls launch directly.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parent.parent.parent
             / "build" / "kernels")
SOURCES = ("fused_conv.cu", "fused_conv_wgmma.cu", "channel_stats.cu",
           "reduce_partials.cu", "gn_swish.cu", "quant_conv.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"fused_gn_swish_conv3x3": 0, "channel_stats": 0, "gn_swish": 0,
            "quant_conv3": 0}

_LIB = None
_LOCK = threading.Lock()


def traced() -> bool:
    """Whether the current call is traced by ``torch.export`` or watched
    by a dispatch mode (``FlopCounterMode``, ``FakeTensorMode``)."""
    import torch
    return (torch.compiler.is_exporting()
            or torch._C._len_torch_dispatch_stack() > 0)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def _find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, /usr/local/cuda "
        "and $PATH): the port's CUDA kernels are built from "
        f"{CSRC} at first use and need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the kernels (if this source tree was not built yet) and
    return the path of the shared library."""
    out_dir = BUILD_DIR / _digest()
    lib_path = out_dir / "libfdsr_kernels.so"
    if lib_path.is_file():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir.parent / f"{out_dir.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)       # released when it closes
        if not lib_path.is_file():
            _compile(out_dir, lib_path)
    return lib_path


def _compile(out_dir: pathlib.Path, lib_path: pathlib.Path) -> None:
    nvcc = _find_nvcc()
    t0 = time.time()
    procs = []
    for src in SOURCES:
        obj = out_dir / (src + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = []
    for cmd, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    tmp = out_dir / f"libfdsr_kernels.{os.getpid()}.so"
    # the CUDA runtime is linked statically (nvcc's default); it shares the
    # device's primary context, and so torch's streams, with PyTorch
    cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed: {' '.join(cmd)}\n{res.stdout}")
    (out_dir / "build.log").write_text(
        f"built in {time.time() - t0:.1f} s\n" + "\n".join(logs))
    os.replace(tmp, lib_path)


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.fdsr_fused_conv_wgmma_tiles.argtypes = [i, i]   # H W
            lib.fdsr_fused_conv_tiles.argtypes = [i, i, i, i]   # B H W Co
            for fn in (lib.fdsr_fused_conv_tiles,
                       lib.fdsr_fused_conv_wgmma_tiles):
                fn.restype = i
            # x1 x2 C1 C2 stats1 stats2 gamma beta groups eps apply_norm
            # w conv_b shift res y partial stats B H W Co stream
            for fn in (lib.fdsr_fused_gn_swish_conv3x3,
                       lib.fdsr_fused_gn_swish_conv3x3_wgmma):
                fn.argtypes = [p, p, i, i, p, p, p, p, i, f, i, p, p, p, p,
                               p, p, p, i, i, i, i, p]
                fn.restype = i
            for fn in (lib.fdsr_fused_conv_max_channels,
                       lib.fdsr_fused_conv_wgmma_max_channels):
                fn.argtypes = []
                fn.restype = i
            for fn in (lib.fdsr_channel_stats_threads,
                       lib.fdsr_channel_stats_slab,
                       lib.fdsr_channel_stats_final_lanes,
                       lib.fdsr_channel_stats_unroll,
                       lib.fdsr_channel_stats_counter_slots,
                       lib.fdsr_channel_stats_slot_counters):
                fn.argtypes = []
                fn.restype = i
            # x partial stats B HW C is_bf16 vec n_blocks slot stream
            lib.fdsr_channel_stats.argtypes = [p, p, p, i, i, i, i, i, i, i,
                                               p]
            lib.fdsr_channel_stats.restype = i
            lib.fdsr_graph_kernel_nodes.argtypes = [p, ctypes.POINTER(i)]
            lib.fdsr_graph_kernel_nodes.restype = i
            lib.fdsr_gn_swish_apply.argtypes = [p, p, i, f, p, p, p, i, i, i,
                                                i, p]
            lib.fdsr_gn_swish_apply.restype = i
            bind_quant_conv3(lib)
            lib.fdsr_error_string.argtypes = [i]
            lib.fdsr_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def bind_quant_conv3(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare Q1's C entry points (``csrc/quant_conv.cu``) on ``lib``: the
    port's library, or a library built from that source alone."""
    p, i = ctypes.c_void_p, ctypes.c_int
    # h wq s_w s_a bias y acc B H W Ci Ci_pad Co Co_pad in_bf16 out_bf16
    # stream
    lib.fdsr_quant_conv3.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                     i, i, i, p]
    lib.fdsr_quant_conv3.restype = i
    for fn in (lib.fdsr_quant_conv3_co_tile, lib.fdsr_quant_conv3_tile_rows,
               lib.fdsr_quant_conv3_tile_cols):
        fn.argtypes = [i]
        fn.restype = i
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.fdsr_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptr(t) -> "ctypes.c_void_p | None":
    """data pointer of a tensor (None -> NULL)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream_of(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def kernels_per_call(fn) -> int:
    """How many kernels one call of ``fn`` launches on the card: the kernel
    nodes of a CUDA graph that captured one call. ``fn`` is called once on
    a side stream first, so that nothing is built or cached for the first
    time inside the capture."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    lib = load()
    n = ctypes.c_int(0)
    check(lib, lib.fdsr_graph_kernel_nodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.byref(n)),
        "graph_kernel_nodes")
    return n.value
