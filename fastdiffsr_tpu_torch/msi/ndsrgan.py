"""NDSRGAN: the dense DRRDB generator, the patch discriminator and the
LSGAN trainer. Counterpart of ``fastdiffsr_tpu/msi/ndsrgan.py``
(reference MSI_SR_model/model/ndsrgan.py).

- DenseBlock: 4 conv + LeakyReLU(0.2) growth layers, a 3x3 fuse,
  x + 0.2·res; DCRDB: 3 DenseBlocks with the cumulative 0.2 mixing and a
  conv, x + 0.2·out; DRRDBNet: 23 DCRDBs, each fed the running
  x + 0.2·sum of the earlier outputs, a conv + skip, nearest-upsample ->
  conv -> LeakyReLU per 2x (or 3x), conv -> LeakyReLU -> conv. Module
  names are the reference's state-dict keys (``conv1.0``,
  ``DCRDB_block.DRRDB{n}.RDB{j}.{CL_blocks.{i}.0,conv}``,
  ``upsampling.{3k+1}``, ``conv3.{0,2}``).
- Discriminator: 4x4 convs at stride 2, 2, 2, 1 with GroupNorm(1, C),
  eps 1e-5 (the JAX package's stand-in for the reference's BatchNorm),
  LeakyReLU 0.2, and a 4x4 conv to one logit map.
- GANTrainer: LSGAN; per step D first ((D(hr) - 1)^2 + D(G(lr))^2 with
  G's output detached), then G (L1 + ``weight_gan`` 1e-3 · (D(G(lr)) -
  1)^2) against the updated D, each with Adam(lr, 0.9, 0.999), as JAX
  ``:186-213`` does. G's forward is taken once per step: its output is
  the same before and after D's update.
"""

from __future__ import annotations

import logging
import time

import torch
import torch.nn as nn

from ..parallel import all_reduce_mean, data_parallel, local_batch


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class DenseBlock(nn.Module):
    def __init__(self, nf: int, nc: int, cl_num: int = 4):
        super().__init__()
        self.CL_blocks = nn.ModuleList(
            nn.Sequential(_conv3(nf + j * nc, nc), nn.LeakyReLU(0.2))
            for j in range(cl_num))
        self.conv = _conv3(nf + cl_num * nc, nf)

    def forward(self, x):
        feats = x
        for cl in self.CL_blocks:
            feats = torch.cat([feats, cl(feats)], dim=1)
        return x + self.conv(feats) * 0.2


class DCRDB(nn.Module):
    def __init__(self, nf: int, nc: int):
        super().__init__()
        self.RDB1 = DenseBlock(nf, nc)
        self.RDB2 = DenseBlock(nf, nc)
        self.RDB3 = DenseBlock(nf, nc)
        self.conv = _conv3(nf, nf)

    def forward(self, x):
        out1 = self.RDB1(x)
        out2 = self.RDB2(x + 0.2 * out1)
        out3 = self.RDB3(x + 0.2 * out1 + 0.2 * out2)
        out4 = self.conv(x + 0.2 * out1 + 0.2 * out2 + 0.2 * out3)
        return out4 * 0.2 + x


def upsample_factors(scale: int) -> list:
    """2x stages for 2^n, 3x for 3^n; the reference builds no other
    stack (ndsrgan.py:192-196), so other scales raise."""
    factors, s = [], scale
    while s > 1:
        r = 3 if s % 3 == 0 else 2
        factors.append(r)
        s //= r
    if len(set(factors)) > 1:
        raise ValueError(f"DRRDBNet upscale_factor={scale} unsupported: the "
                         "reference generator only builds 2^n or 3^n stacks")
    return factors


class DRRDBNet(nn.Module):
    def __init__(self, scale: int = 4, in_channels: int = 3,
                 out_channels: int = 3, nf: int = 64, nc: int = 32,
                 n_blocks: int = 23):
        super().__init__()
        self.conv1 = nn.Sequential(_conv3(in_channels, nf))
        self.DCRDB_block = nn.Module()
        for n in range(n_blocks):
            self.DCRDB_block.add_module(f"DRRDB{n + 1}", DCRDB(nf, nc))
        self.conv2 = _conv3(nf, nf)
        layers = []
        for r in upsample_factors(scale):
            layers += [nn.Upsample(scale_factor=r, mode="nearest"),
                       _conv3(nf, nf), nn.LeakyReLU(0.2)]
        self.upsampling = nn.Sequential(*layers)
        self.conv3 = nn.Sequential(_conv3(nf, nf), nn.LeakyReLU(0.2),
                                   _conv3(nf, out_channels))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """(B,H,W,3) -> (B, H*scale, W*scale, 3); draws nothing."""
        feat = self.conv1(x.permute(0, 3, 1, 2))
        acc = feat
        for block in self.DCRDB_block.children():
            acc = acc + 0.2 * block(acc)
        out = self.upsampling(feat + self.conv2(acc))
        return self.conv3(out).permute(0, 2, 3, 1)


class Discriminator(nn.Module):
    CFG = ((64, 2, False), (128, 2, True), (256, 2, True), (512, 1, True))

    def __init__(self, in_channels: int = 3):
        super().__init__()
        blocks, cin = [], in_channels
        for nf, stride, norm in self.CFG:
            layers = [nn.Conv2d(cin, nf, 4, stride=stride, padding=1)]
            if norm:
                layers.append(nn.GroupNorm(1, nf, eps=1e-5))
            layers.append(nn.LeakyReLU(0.2))
            blocks.append(nn.Sequential(*layers))
            cin = nf
        self.blocks = nn.Sequential(*blocks)
        self.out = nn.Conv2d(cin, 1, 4, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B,H,W,3) -> (B, H', W', 1) patch logits."""
        return self.out(self.blocks(x.permute(0, 3, 1, 2))).permute(
            0, 2, 3, 1)


class GANTrainer:
    """NDSRGAN adversarial training on the MSI data path (reference
    ndsrgan.py train():310+, LS penalty). ``args`` as the JAX trainer's:
    scale_factor, g_nf, g_nc, g_blocks, crop_size, lr, weight_gan; the
    initial weights come from ``seed`` (Flax defaults, ``msi.main.
    init_weights``).

    Under a ``torch.distributed`` group (torchrun) each network trains in
    its own DistributedDataParallel wrapper (JAX msi/ndsrgan.py:215-233):
    the D step through D's, the G step through G's, with the G step's
    adversarial term on the bare, frozen discriminator (its gradient
    flows only into G, whose wrapper averages it). ``batch_size`` is the
    global batch; a rank loads its rows. The discriminator's
    GroupNorm(1, C) normalises each image alone, so the ranks' rows need
    no SyncBatchNorm and a W-rank step is the 1-rank step. The returned
    losses are means over the ranks."""

    def __init__(self, args, logger=None, device="cuda", seed: int = 0):
        from ..device import resolve_device
        from .main import init_weights

        self.args = args
        self.device = resolve_device(device)
        self.scale = int(getattr(args, "scale_factor", 4))
        self.logger = logger or logging.getLogger("msi")
        self.g = init_weights(DRRDBNet(
            scale=self.scale, nf=int(getattr(args, "g_nf", 64)),
            nc=int(getattr(args, "g_nc", 32)),
            n_blocks=int(getattr(args, "g_blocks", 23))), seed).to(
                self.device)
        self.d = init_weights(Discriminator(), seed).to(self.device)
        lr = float(getattr(args, "lr", 2e-4))
        self.opt_g = torch.optim.Adam(self.g.parameters(), lr=lr,
                                      betas=(0.9, 0.999), eps=1e-8)
        self.opt_d = torch.optim.Adam(self.d.parameters(), lr=lr,
                                      betas=(0.9, 0.999), eps=1e-8)
        self.w_gan = float(getattr(args, "weight_gan", 1e-3))
        self.step_count = 0
        self.g_train = data_parallel(self.g)
        self.d_train = data_parallel(self.d)

    def step(self, lr_b: torch.Tensor, hr_b: torch.Tensor) -> dict:
        """One D update then one G update; the four losses as tensors."""
        self.g.train()
        self.d.train()
        fake = self.g_train(lr_b)
        d_loss = ((self.d_train(hr_b) - 1.0) ** 2).mean() + \
            (self.d_train(fake.detach()) ** 2).mean()
        self.opt_d.zero_grad(set_to_none=True)
        d_loss.backward()
        self.opt_d.step()

        self.d.requires_grad_(False)
        pixel = (fake - hr_b).abs().mean()
        adv = ((self.d(fake) - 1.0) ** 2).mean()
        g_loss = pixel + self.w_gan * adv
        self.opt_g.zero_grad(set_to_none=True)
        g_loss.backward()
        self.opt_g.step()
        self.d.requires_grad_(True)
        self.step_count += 1
        return {k: all_reduce_mean(v.detach()) for k, v in
                (("g", g_loss), ("d", d_loss), ("pixel", pixel),
                 ("adv", adv))}

    def train(self, train_dirs, num_epochs=1, batch_size=2,
              max_steps=None) -> dict:
        """Train on HR folders; returns the last step's losses as floats
        and ``steps_per_s``, the steady rate after the first step."""
        from .data import MSIDataLoader, RGBSRDataset
        ds = RGBSRDataset(train_dirs, int(getattr(self.args, "crop_size", 64)),
                          self.scale, split="train")
        loader = MSIDataLoader(ds, batch_size=local_batch(batch_size),
                               shuffle=True, shard_by_process=True)
        step, m, t1 = 0, {}, None
        for epoch in range(num_epochs):
            for batch in loader:
                m = self.step(torch.from_numpy(batch["LR"]).to(self.device),
                              torch.from_numpy(batch["HR"]).to(self.device))
                step += 1
                if step == 1:
                    m = {k: float(v) for k, v in m.items()}
                    t1 = time.time()
                if max_steps and step >= max_steps:
                    break
            self.logger.info(f"epoch {epoch + 1}: " + " ".join(
                f"{k} {float(v):.4f}" for k, v in m.items()))
            if max_steps and step >= max_steps:
                break
        out = {k: float(v) for k, v in m.items()}
        out["steps_per_s"] = ((step - 1) / (time.time() - t1)
                              if step > 1 else None)
        return out
