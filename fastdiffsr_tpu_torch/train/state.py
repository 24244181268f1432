"""Train state: the net, its optimizer, the EMA parameters and counters.

Counterpart of ``fastdiffsr_tpu/train/state.py``. JAX keeps an immutable
pytree and returns a new one per step; here :class:`TrainState` holds the
live ``nn.Module`` and ``torch.optim.Optimizer`` and the train step
updates them in place. The EMA parameters (decay 0.9999 from step 5000 by
default) are a dict of tensors keyed by parameter name. Under a
``torch.distributed`` group the train step calls ``train_net``, the net
in ``DistributedDataParallel`` (``parallel.data_parallel``); ``net``,
the EMA and the checkpoints stay the bare module, so saved keys carry no
``module.`` prefix.

:func:`make_optimizer` builds the optimizers of the JAX package with
optax's defaults: ``adam`` (b1 0.9, b2 0.999, eps 1e-8), ``adamw`` (the
same, decoupled weight decay 1e-4, where torch's default is 1e-2) and
``lion`` (b1 0.9, b2 0.99, weight decay 1e-3), which torch lacks and
:class:`Lion` writes out. Adam and AdamW on CUDA parameters are built
``capturable`` (their step counts on the device), so that an unchained
step and a step replayed from a CUDA graph (``train.steps``) take the
same arithmetic; :func:`keep_capturable` holds that over a checkpoint's
load.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    epoch: int
    net: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: Dict[str, torch.Tensor]
    train_net: torch.nn.Module          # net, or its DDP wrapper

    def ema_or_params(self, use_ema: bool = True) -> Dict[str, torch.Tensor]:
        """The EMA parameters, or the live ones, as a state dict."""
        if use_ema:
            return self.ema_params
        return {k: v.detach() for k, v in self.net.state_dict().items()}


def create_train_state(net: torch.nn.Module,
                       optimizer: torch.optim.Optimizer) -> TrainState:
    """The state at step 0; under a process group ``train_net`` wraps
    ``net`` in DDP, which starts every rank from rank 0's parameters."""
    from ..parallel import data_parallel
    train_net = data_parallel(net)
    return TrainState(step=0, epoch=0, net=net, optimizer=optimizer,
                      ema_params={k: p.detach().clone()
                                  for k, p in net.named_parameters()},
                      train_net=train_net)


class Lion(torch.optim.Optimizer):
    """optax.lion: u = sign(b1*m + (1-b1)*g); p -= lr*(u + wd*p);
    m <- b2*m + (1-b2)*g."""

    def __init__(self, params: Iterable, lr: float = 1e-4,
                 betas=(0.9, 0.99), weight_decay: float = 1e-3):
        super().__init__(params, dict(lr=lr, betas=tuple(betas),
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Lion.step takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p)
                m, g = state["exp_avg"], p.grad
                update = torch.sign(g * (1.0 - b1) + m * b1)
                p.add_(update + p * group["weight_decay"],
                       alpha=-group["lr"])
                m.mul_(b2).add_(g, alpha=1.0 - b2)


def make_optimizer(params: Iterable,
                   opt_cfg: Optional[dict] = None) -> torch.optim.Optimizer:
    """Adam at lr 2e-4 by default (reference model/model.py:36-38)."""
    opt_cfg = opt_cfg or {}
    lr = float(opt_cfg.get("lr", 2e-4))
    kind = str(opt_cfg.get("type", "adam")).lower()
    params = list(params)
    cap = any(p.is_cuda for p in params)
    if kind == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                capturable=cap)
    if kind == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4, capturable=cap)
    if kind == "lion":
        return Lion(params, lr=lr)
    raise ValueError(f"unknown optimizer type: {kind}")


def keep_capturable(optimizer: torch.optim.Optimizer, flags) -> None:
    """Set each param group's ``capturable`` back to ``flags`` (their
    values before ``load_state_dict``, which takes the saved groups'),
    with the step counts of a capturable group on its parameters'
    device, as a capturable optimizer keeps them."""
    for group, flag in zip(optimizer.param_groups, flags):
        if flag is None:
            continue
        group["capturable"] = flag
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if flag and torch.is_tensor(st.get("step")):
                st["step"] = st["step"].to(device=p.device,
                                           dtype=torch.float32)
