"""FlowNet-style demo trainer, the generator's downstream consumer (port of
``flowgen/train/flownet.py``).

A compact FlowNetS encoder/decoder as a ``torch.nn.Module``, the FlowNet
multiscale endpoint-error objective, Adam, and a step that generates a
batch on the card and takes one update on the same card and stream, so
nothing passes through the host.

The layers follow the JAX package's flax model and carry its weights
(``interop.flownet_params_from_flax``):

* flax's ``padding="SAME"`` pads ``total = max((ceil(n/s) - 1) * s + k - n,
  0)`` as ``total // 2`` before and the rest after, asymmetric for strided
  convolutions (k=7, s=2 on an even size: 2 and 3), so every convolution
  pads explicitly;
* flax's ``ConvTranspose`` (``transpose_kernel=False``, "SAME", k=4, s=2) is
  ``lax.conv_transpose``: the input dilated by 2, padded by 2 on each side,
  correlated with the kernel as stored. That equals
  ``nn.ConvTranspose2d(k=4, s=2, padding=1)`` with the kernel flipped in
  both spatial axes (``w_torch[ci, co, a, b] = k_flax[3 - a, 3 - b, ci,
  co]``);
* ``jax.image.resize(..., "bilinear")`` antialiases when it shrinks:
  ``F.interpolate(..., antialias=True, align_corners=False)``.

Tensors are NCHW inside the model; :func:`preprocess` and the loss take a
batch in either of the generator's layouts.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

EPE_WEIGHTS = (0.005, 0.01, 0.02, 0.08, 0.32)


def _same_pad(n: int, k: int, s: int):
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _lecun_normal_(w: torch.Tensor, fan_in: int):
    """flax's default kernel init: a normal of variance 1/fan_in truncated
    at two standard deviations (``variance_scaling(1, "fan_in",
    "truncated_normal")``)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std)


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's "SAME" padding, bias zero at init."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride, padding=0)
        _lecun_normal_(self.weight, cin * k * k)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        py = _same_pad(x.shape[-2], k, s)
        px = _same_pad(x.shape[-1], k, s)
        return super().forward(F.pad(x, (px[0], px[1], py[0], py[1])))


class SameConvTranspose2d(nn.ConvTranspose2d):
    """flax's ``ConvTranspose(k=4, s=2, "SAME")``: ``(n, c) -> (2n, c')``
    (see the module docstring for the kernel flip)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 4, 2, padding=1)
        _lecun_normal_(self.weight, cin * 16)
        nn.init.zeros_(self.bias)


class FlowNetS(nn.Module):
    """Compact FlowNetS: strided conv encoder, deconv decoder with five
    flow predictions, finest at 1/4 resolution: ``forward(x)`` with ``x``
    (B, 6, H, W) returns (flow2, flow3, flow4, flow5, flow6), (B, 2, H/4,
    W/4) to (B, 2, H/64, W/64)."""

    def __init__(self, width: int = 32):
        super().__init__()
        w = width
        self.width = width
        self.enc = nn.ModuleList([
            SameConv2d(6, w, 7, 2),             # 1/2
            SameConv2d(w, 2 * w, 5, 2),         # 1/4
            SameConv2d(2 * w, 4 * w, 5, 2),     # 1/8
            SameConv2d(4 * w, 4 * w, 3),
            SameConv2d(4 * w, 8 * w, 3, 2),     # 1/16
            SameConv2d(8 * w, 8 * w, 3),
            SameConv2d(8 * w, 8 * w, 3, 2),     # 1/32
            SameConv2d(8 * w, 8 * w, 3),
            SameConv2d(8 * w, 16 * w, 3, 2),    # 1/64
            SameConv2d(16 * w, 16 * w, 3),
        ])
        # Decoder inputs, coarse to fine: c6b, then [up, skip, upflow].
        cin = [16 * w]
        for skip in (8 * w, 8 * w, 4 * w, 2 * w):
            cin.append(cin[-1] // 2 + skip + 2)
        self.up = nn.ModuleList(
            [SameConvTranspose2d(c, c // 2) for c in cin[:-1]])
        self.predict = nn.ModuleList([SameConv2d(c, 2, 3) for c in cin])

    def forward(self, x):
        feats = []
        for conv in self.enc:
            x = F.leaky_relu(conv(x), 0.1)
            feats.append(x)
        c2, c3b, c4b, c5b = feats[1], feats[3], feats[5], feats[7]
        f = feats[9]
        flows = [self.predict[0](f)]
        for up, predict, skip in zip(self.up, self.predict[1:],
                                     (c5b, c4b, c3b, c2)):
            u = F.leaky_relu(up(f), 0.1)
            f = torch.cat([u, skip, _upflow(flows[-1])], dim=1)
            flows.append(predict(f))
        return tuple(reversed(flows))


def _upflow(f):
    return 2.0 * F.interpolate(f, scale_factor=2, mode="bilinear",
                               align_corners=False)


def _downsample_flow(flow, factor: int):
    h, w = flow.shape[-2] // factor, flow.shape[-1] // factor
    return F.interpolate(flow, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=True)


def _nchw(t, layout: str):
    return t.movedim(-1, 1) if layout == "nhwc" else t


def multiscale_epe(preds: Sequence[torch.Tensor], flow_gt: torch.Tensor):
    """FlowNet multiscale endpoint-error objective on NCHW flows (coarse
    scales weighted lower)."""
    total = 0.0
    for pred, wgt in zip(preds, reversed(EPE_WEIGHTS)):
        gt = _downsample_flow(flow_gt, flow_gt.shape[-2] // pred.shape[-2])
        epe = torch.sqrt(torch.sum((pred - gt) ** 2, dim=1) + 1e-8)
        total = total + wgt * torch.mean(epe)
    return total


def preprocess(batch, layout: str = "nhwc"):
    """The image pair concatenated on channels, NCHW, scaled to about
    [-1, 1]."""
    x = torch.cat([_nchw(batch["image0"], layout),
                   _nchw(batch["image1"], layout)], dim=1)
    return x / 127.5 - 1.0


def create_model(width: int = 32) -> FlowNetS:
    return FlowNetS(width=width)


def make_optimizer(model: nn.Module, lr: float = 1e-4):
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def loss_fn(model: nn.Module, batch, layout: str = "nhwc"):
    preds = model(preprocess(batch, layout))
    return multiscale_epe(preds, _nchw(batch["flow0"], layout))


def make_train_step(model: nn.Module, opt, layout: str = "nhwc"):
    """``step(batch) -> loss``: one Adam update of ``model`` in place; the
    loss stays a device tensor (reading it synchronizes)."""

    def step(batch):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch, layout)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def make_generate_and_train_step(cfg, model: nn.Module, opt, device=None):
    """The full pipeline step: ``fused(root, step, atlas) -> loss``
    generates step ``step`` (``pipeline/generator.py:make_generate_fn``) and
    takes one update on it, on the same device and stream."""
    from ..pipeline.generator import make_generate_fn

    gen = make_generate_fn(cfg, device)
    train_step = make_train_step(model, opt, cfg.layout)

    def fused(root, step, atlas):
        return train_step(gen(root, step, atlas))

    return fused
