"""2x3 affine transform helpers (port of ``flowgen/ops/affine.py``).

A transform is a ``(..., 2, 3)`` tensor ``[L | t]`` acting on column points:
``p -> L @ p + t``. ``compose(a, b)`` applies ``a`` first, then ``b`` (AGG's
``a *= b``). Everything is elementwise float32 in the JAX package's order of
operations: eager PyTorch rounds every product and sum on its own and never
contracts ``a*b + c`` into an FMA, which is what the JAX package's
``apply_xy_det`` pins on XLA.
"""

from __future__ import annotations

import torch

from .._fp import const, cos, div, sin


def _t(x, like=None):
    """``x`` as a float32 tensor; a Python number becomes a shared constant
    on ``like``'s device (the CPU without ``like``)."""
    if torch.is_tensor(x):
        return x.to(torch.float32)
    x = float(x)
    return const(("f32", x.hex()), like.device if like is not None else "cpu",
                 lambda: torch.tensor(x, dtype=torch.float32))


def identity(device="cpu"):
    return torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device=device)


def rotation(alpha):
    """agg::trans_affine_rotation."""
    alpha = _t(alpha)
    c, s = cos(alpha), sin(alpha)
    z = torch.zeros_like(c)
    return torch.stack(
        [torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1)], -2
    )


def scaling(s):
    """agg::trans_affine_scaling (isotropic)."""
    s = _t(s)
    z = torch.zeros_like(s)
    return torch.stack(
        [torch.stack([s, z, z], -1), torch.stack([z, s, z], -1)], -2
    )


def translation(tx, ty, like=None):
    """agg::trans_affine_translation. ``like`` gives the device when both
    offsets are Python numbers."""
    if like is None:
        like = tx if torch.is_tensor(tx) else (ty if torch.is_tensor(ty) else None)
    tx = _t(tx, like)
    ty = _t(ty, like)
    tx, ty = torch.broadcast_tensors(tx, ty)
    o = torch.ones_like(tx)
    z = torch.zeros_like(tx)
    return torch.stack(
        [torch.stack([o, z, tx], -1), torch.stack([z, o, ty], -1)], -2
    )


def _mat_apply(l, vx, vy):
    return (
        l[..., 0, 0] * vx + l[..., 0, 1] * vy,
        l[..., 1, 0] * vx + l[..., 1, 1] * vy,
    )


def compose(a, b):
    """Apply ``a`` first, then ``b``: ``[L_b L_a | L_b t_a + t_b]``."""
    a, b = torch.broadcast_tensors(a, b)
    la, ta = a[..., :2], a[..., 2]
    lb, tb = b[..., :2], b[..., 2]
    c00, c10 = _mat_apply(lb, la[..., 0, 0], la[..., 1, 0])
    c01, c11 = _mat_apply(lb, la[..., 0, 1], la[..., 1, 1])
    tx, ty = _mat_apply(lb, ta[..., 0], ta[..., 1])
    row0 = torch.stack([c00, c01, tx + tb[..., 0]], -1)
    row1 = torch.stack([c10, c11, ty + tb[..., 1]], -1)
    return torch.stack([row0, row1], -2)


def chain(*ts):
    """compose(t0, t1, t2, ...) applied left to right."""
    out = ts[0]
    for t in ts[1:]:
        out = compose(out, t)
    return out


def invert(a):
    """agg::trans_affine::invert."""
    l, t = a[..., :2], a[..., 2]
    det = l[..., 0, 0] * l[..., 1, 1] - l[..., 0, 1] * l[..., 1, 0]
    inv_det = div(1.0, det)
    li = torch.stack(
        [
            torch.stack([l[..., 1, 1], -l[..., 0, 1]], -1),
            torch.stack([-l[..., 1, 0], l[..., 0, 0]], -1),
        ],
        -2,
    ) * inv_det[..., None, None]
    tix, tiy = _mat_apply(li, t[..., 0], t[..., 1])
    ti = -torch.stack([tix, tiy], -1)
    return torch.cat([li, ti[..., None]], dim=-1)


def apply(a, pts):
    """Transform points. ``pts``: (..., N, 2); broadcasts over batch."""
    l, t = a[..., :2], a[..., 2]
    px, py = _mat_apply(l[..., None, :, :], pts[..., 0], pts[..., 1])
    return torch.stack([px, py], -1) + t[..., None, :]


def apply_xy(a, x, y):
    """Transform coordinate grids elementwise; a: (2,3), x/y: any shape."""
    nx = a[0, 0] * x + a[0, 1] * y + a[0, 2]
    ny = a[1, 0] * x + a[1, 1] * y + a[1, 2]
    return nx, ny


def apply_xy_det(a, x, y):
    """``apply_xy`` with each product rounded on its own before the sums
    (the JAX package pins this with ``detmath.fma_barrier``; eager PyTorch
    never contracts). ``a`` is a (2,3) tensor or a flat 6-tuple."""
    if isinstance(a, (tuple, list)):
        a00, a01, a02, a10, a11, a12 = a
    else:
        a00, a01, a02 = a[0, 0], a[0, 1], a[0, 2]
        a10, a11, a12 = a[1, 0], a[1, 1], a[1, 2]
    nx = a00 * x + a01 * y + a02
    ny = a10 * x + a11 * y + a12
    return nx, ny


def motion_transform(rot, scale, tx, ty):
    """Object motion R·S·T (setMotion, DataGenerator.cpp:312-322)."""
    return chain(rotation(rot), scaling(scale), translation(tx, ty))


def intrinsic_transform(rot, tx, ty):
    """Intrinsic pose R·T (setIntrinsicTransform, DataGenerator.cpp:302-310)."""
    return chain(rotation(rot), translation(tx, ty))


def conjugate_about(m, cx, cy):
    """T(-c) · m · T(c): apply ``m`` about centre ``c`` (addBackgroundMotion,
    DataGenerator.cpp:324-335)."""
    return chain(
        translation(-cx, -cy, like=m), m, translation(cx, cy, like=m)
    )
