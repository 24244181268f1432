"""fastdiffsr_tpu_torch: the FastDiffSR super-resolution diffusion system
in PyTorch, with hand-written CUDA kernels for the NVIDIA H100.

It mirrors the module paths of the JAX package ``fastdiffsr_tpu``, which
stays beside it as the reference, and imports nothing from it. Public
functions take and return NHWC tensors. Entry points run on CUDA unless
the caller passes ``device="cpu"``; on CPU tensors each kernel wrapper
runs its plain PyTorch version.

Ported so far: the T-step ancestral serving path of the ``fastdiffsr``
variant (config, schedules, engine, UNet and its fused inference forward,
data, metrics, ``cli/infer.py``) and its training path (training loss,
optimizers, EMA, train steps, checkpoints, ``cli/sr_mfe.py``), with
kernels K1 (GroupNorm -> Swish), K2 (channel statistics) and K3 (fused
GroupNorm -> Swish -> 3x3 conv) in ``csrc/``; the ddpm/tesr/gdp variants,
the DDIM and DPM-Solver++ samplers, ``cli/fid.py``; and EDiffSR (the
IR-SDE in ``diffusion/sde.py``, ``models/nafnet.py``,
``models/cond_unet.py``, ``ediffsr/``), which has no kernel of its own;
and the five MSI baselines with their shared trainer and CLI (``msi/``,
``models/vgg_feat.py``), which have none either.
"""

__version__ = "0.1.0"
