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

Over a ``DeviceMesh`` (``data``, ``model``), :func:`shard_model` splits every
layer's output channels over ``model`` (Megatron-style column parallelism,
the JAX package's :func:`param_shardings` rule) and the train step averages
the gradients over ``data``: what GSPMD computes from the JAX package's
shardings, with its collectives written out.
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

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


class _ReduceInputGrad(torch.autograd.Function):
    """Identity forward; backward sums the input's gradient over the model
    group. A layer whose output channels are split sees only its own
    channels' share of d(loss)/d(input): Megatron's copy into the
    model-parallel region."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherChannels(torch.autograd.Function):
    """Forward gathers the ranks' output channels (dim 1) over the model
    group; backward hands the rank back its own channels' slice of the
    gradient, with no reduction: every model rank computes the same loss
    from the gathered output, so a sum over ranks would count it n times
    (Megatron's gather from the model-parallel region)."""

    @staticmethod
    def forward(ctx, y, group):
        n = dist.get_world_size(group)
        ctx.rank, ctx.n = dist.get_rank(group), n
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        # A view, not a copy: the layer's bias gradient then sums the same
        # layout as without the split (a contiguous copy moved the last bits
        # of the bias gradients of an unsplit (1, 1) mesh on an H100).
        c = g.shape[1] // ctx.n
        return g.narrow(1, ctx.rank * c, c), None


class _ColumnParallel:
    """What :func:`shard_model` sets on a layer: ``model_group`` is the
    process group its output channels are split over (None: replicated).
    Parameters that are DTensors are read through ``to_local()``."""

    model_group = None

    def _parallel(self, x, conv):
        w, b = self.weight, self.bias
        if isinstance(w, DTensor):
            w, b = w.to_local(), b.to_local()
        if self.model_group is None:
            return conv(x, w, b)
        x = _ReduceInputGrad.apply(x, self.model_group)
        return _GatherChannels.apply(conv(x, w, b), self.model_group)


class SameConv2d(_ColumnParallel, nn.Conv2d):
    """``nn.Conv2d`` with flax's "SAME" padding, bias zero at init."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride, padding=0)
        _lecun_normal_(self.weight, cin * k * k)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        py = _same_pad(x.shape[-2], k, s)
        px = _same_pad(x.shape[-1], k, s)
        x = F.pad(x, (px[0], px[1], py[0], py[1]))
        return self._parallel(x, lambda x, w, b: F.conv2d(x, w, b, self.stride))


class SameConvTranspose2d(_ColumnParallel, nn.ConvTranspose2d):
    """flax's ``ConvTranspose(k=4, s=2, "SAME")``: ``(n, c) -> (2n, c')``
    (see the module docstring for the kernel flip)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 4, 2, padding=1)
        _lecun_normal_(self.weight, cin * 16)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return self._parallel(x, lambda x, w, b: F.conv_transpose2d(
            x, w, b, self.stride, self.padding))


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


def _flax_layer_names(model: FlowNetS):
    """(flax name, module) of every layer in the order flax creates them:
    the ten encoder convolutions, then the predictions (coarse to fine)
    between the transposed convolutions."""
    out = [(f"Conv_{i}", m) for i, m in enumerate(model.enc)]
    out.append(("Conv_10", model.predict[0]))
    for i, up in enumerate(model.up):
        out += [(f"ConvTranspose_{i}", up), (f"Conv_{11 + i}",
                                             model.predict[1 + i])]
    return out


def _flax_param_key(key, layer: str):
    """The key flax hands a layer's first parameter (its kernel):
    ``fold_in(key, h)``, h the first 4 bytes (big-endian) of the SHA-1 of
    the layer's name and the parameter counter 1 (``flax/core/scope.py``:
    ``Scope.make_rng`` and ``_fold_in_static``)."""
    from ..random.streams import fold_in

    digest = hashlib.sha1(layer.encode("utf-8") + bytes([1])).digest()
    return fold_in(key, int.from_bytes(digest[:4], "big"))


def _flax_lecun_normal(key, shape):
    """flax's default kernel init on a (kh, kw, cin, cout) kernel:
    ``variance_scaling(1, "fan_in", "truncated_normal")``, the JAX package's
    arithmetic in float32: a uniform between erf(-2/sqrt2) and
    erf(2/sqrt2), sqrt2 * erf_inv, the clamp to the open interval (-2, 2),
    times sqrt(1/fan_in) / 0.87962566103423978."""
    from .._fp import erf_inv
    from ..random.streams import SQRT2, uniform

    f = np.float32
    lo, hi = (f(math.erf(float(f(v) / f(SQRT2)))) for v in (-2.0, 2.0))
    z = SQRT2 * erf_inv(uniform(key, lo, hi, shape))
    z = torch.clamp(z, float(np.nextafter(f(-2.0), f(np.inf))),
                    float(np.nextafter(f(2.0), f(-np.inf))))
    fan_in = int(np.prod(shape[:-1]))
    std = f(np.sqrt(f(1.0 / fan_in))) / f(0.87962566103423978)
    return z * float(std)


def init_params(model: FlowNetS, key, height: int, width: int) -> dict:
    """The JAX package's ``init_params(model, key, height, width)`` for
    the same threefry ``key`` (a ``random/streams.py`` key, as
    ``root_key(seed)`` is ``jax.random.key(seed)``), converted by
    ``interop.flownet_params_from_flax``: a ``state_dict`` for ``model``
    (``model.load_state_dict(init_params(...))``), on the CPU. Kernels are
    flax's default init from each layer's own key, biases zero. ``height``
    and ``width`` are the dummy input's size, which flax traces and which
    sets no parameter; they must be positive. ``model`` is not changed."""
    from ..interop import flownet_params_from_flax

    if height <= 0 or width <= 0:
        raise ValueError(f"init_params: size {height}x{width}")
    key = key.cpu()
    params = {}
    for name, layer in _flax_layer_names(model):
        w = layer.weight
        if isinstance(layer, nn.ConvTranspose2d):
            cin, cout, kh, kw = w.shape
        else:
            cout, cin, kh, kw = w.shape
        kernel = _flax_lecun_normal(_flax_param_key(key, name),
                                    (kh, kw, cin, cout))
        params[name] = {"kernel": kernel.numpy(),
                        "bias": np.zeros(cout, np.float32)}
    return flownet_params_from_flax(params)


def make_optimizer(model: nn.Module, lr: float = 1e-4):
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def loss_fn(model: nn.Module, batch, layout: str = "nhwc"):
    preds = model(preprocess(batch, layout))
    return multiscale_epe(preds, _nchw(batch["flow0"], layout))


def _mean_over(group, tensors):
    """Average each tensor in place over ``group`` (a sum, then a division:
    the ``gloo`` backend has no average)."""
    n = dist.get_world_size(group)
    for t in tensors:
        dist.all_reduce(t, group=group)
        t.div_(n)


def make_train_step(model: nn.Module, opt, layout: str = "nhwc", mesh=None):
    """``step(batch) -> loss``: one Adam update of ``model`` in place; the
    loss stays a device tensor (reading it synchronizes). With a ``mesh``
    that has a ``data`` dimension, ``batch`` is this rank's sub-batch: the
    gradients and the returned loss are averaged over ``data`` before the
    update, which makes them the global batch's (the loss is a mean of
    per-sample means over equal sub-batches)."""
    group = (mesh.get_group("data")
             if mesh is not None and "data" in mesh.mesh_dim_names else None)

    def step(batch):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch, layout)
        loss.backward()
        loss = loss.detach()
        if group is not None:
            with torch.no_grad():
                _mean_over(group, [loss] + [
                    p.grad.to_local() if isinstance(p.grad, DTensor)
                    else p.grad for p in model.parameters()])
        opt.step()
        return loss

    return step


def param_shardings(model: nn.Module, mesh, model_axis: str = "model"):
    """Megatron-style column parallelism, the JAX package's rule in
    PyTorch's layouts: ``{parameter name: placements}``, one placement a
    mesh dimension. A convolution's output channels are split over
    ``model_axis`` where their count divides by its size: ``Shard(0)`` for
    a ``Conv2d`` weight (cout, cin, kh, kw), ``Shard(1)`` for a
    ``ConvTranspose2d`` weight (cin, cout, kh, kw) (flax stores both as
    (kh, kw, cin, cout) and splits cout), ``Shard(0)`` for a bias;
    everything else is ``Replicate()``."""
    n = mesh[model_axis].size()
    names = mesh.mesh_dim_names

    def place(dim):
        return tuple(Shard(dim) if a == model_axis and dim is not None
                     else Replicate() for a in names)

    out = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            cout_dim = 1 if isinstance(mod, nn.ConvTranspose2d) else 0
            if p.ndim == 4 and p.shape[cout_dim] % n == 0:
                spec = place(cout_dim)
            elif p.ndim == 1 and p.shape[0] % n == 0:
                spec = place(0)
            else:
                spec = place(None)
            out[f"{mname}.{pname}" if mname else pname] = spec
    return out


def shard_model(model: nn.Module, mesh, model_axis: str = "model"):
    """Place ``model``'s parameters on ``mesh`` by :func:`param_shardings`
    and make the split layers compute: the counterpart of the JAX package's
    ``jax.device_put(params, param_shardings(params, mesh))`` together with
    the collectives GSPMD inserts. Every parameter becomes a DTensor (its
    rank's slice where split, which gives the optimizer and ``state_dict``
    their layout; rank 0's values are distributed); a layer whose weight is
    split convolves its replicated input with its local slice and gathers
    the output channels over ``model_axis``, its backward handing each rank
    its own slice of the gradient and summing the input's gradient over the
    model ranks. Build the optimizer after this call. Returns ``model``."""
    specs = param_shardings(model, mesh, model_axis)
    group = mesh.get_group(model_axis)
    for mname, mod in model.named_modules():
        for pname, p in list(mod.named_parameters(recurse=False)):
            spec = specs[f"{mname}.{pname}" if mname else pname]
            mod.register_parameter(pname, nn.Parameter(
                distribute_tensor(p.detach(), mesh, list(spec))))
            if pname == "weight" and any(isinstance(s, Shard) for s in spec):
                mod.model_group = group
    return model


def make_generate_and_train_step(cfg, model: nn.Module, opt, device=None,
                                 mesh=None):
    """The full pipeline step: ``fused(root, step, atlas) -> loss``
    generates step ``step`` (``pipeline/generator.py:make_generate_fn``) and
    takes one update on it, on the same device and stream. With a
    ``mesh``, each rank generates its shard of the global batch
    (``pipeline/sharding.py``) and trains on it (``to_local()``), the
    gradients averaged over ``data`` (:func:`make_train_step`); pass a model
    placed by :func:`shard_model`."""
    from ..pipeline.generator import make_generate_fn

    gen = make_generate_fn(cfg, device, mesh)
    train_step = make_train_step(model, opt, cfg.layout, mesh)

    def fused(root, step, atlas):
        batch = gen(root, step, atlas)
        if mesh is not None:
            batch = {k: v.to_local() for k, v in batch.items()}
        return train_step(batch)

    return fused
