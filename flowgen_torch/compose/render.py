"""Per-object screen geometry shared with the fused path (port of the parts
of ``flowgen/compose/render.py`` that ``compose/fused.py`` uses, and the
mode-9 ``WarpBank`` and ``WarpAux``). The
windowed renderer itself is not ported yet (ROADMAP.md, port queue item
"windowed fallback")."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._fp import sqrt
from ..ops import affine

AA_MARGIN = 2.0          # AA feather reaches 0.5 px outside the outline
WARP_MARGIN = 48.0       # max |iflow| of composed warp fields (~40 px)


class WarpBank(NamedTuple):
    """Bank of nonrigid deformation crops for mode 9: flow and iflow
    (N, H, W, 2), the JAX package's layout."""

    flow: torch.Tensor
    iflow: torch.Tensor


class WarpAux(NamedTuple):
    """The scene kernel's warp planes of a bank epoch: ``obj`` and ``bg`` are
    the JAX package's ``(obj_aux, bg_aux)``; ``bg_band`` (N, n_bg_tiles,
    tile_w / 128) int32 holds the first source tile of each block's pass-1
    band in the background warp, which depends only on ``bg`` and so is
    derived once per epoch (``ops/scene.py:bg_band_starts``)."""

    obj: torch.Tensor
    bg: torch.Tensor
    bg_band: torch.Tensor


def _all_bboxes(prims, motions):
    """Union screen bboxes of every object's valid primitives for both
    frames, over all [..., K, C] slots. Exact for polygons (min/max of the
    transformed outline) and ellipses (affine ellipse extents).

    Returns ((lo0, hi0), (lo1, hi1)) with [..., K, 2] leaves (x, y)."""
    intr = prims.intrinsic                                  # [...,K,C,2,3]
    tr1 = affine.compose(intr, motions[..., None, :, :])

    def bbox(tr):
        pts = affine.apply(tr, prims.edge_pts)              # [...,K,C,E,2]
        pmin = pts.amin(dim=-2)
        pmax = pts.amax(dim=-2)
        center = tr[..., 2]
        lin = tr[..., :2]
        ex = lin[..., 0] * prims.ell_rx[..., None]
        ey = lin[..., 1] * prims.ell_ry[..., None]
        ext = sqrt(ex * ex + ey * ey)
        is_poly = prims.is_poly[..., None]
        lo = torch.where(is_poly, pmin, center - ext)
        hi = torch.where(is_poly, pmax, center + ext)
        valid = prims.valid[..., None]
        lo = torch.where(valid, lo, torch.full_like(lo, 1e9))
        hi = torch.where(valid, hi, torch.full_like(hi, -1e9))
        return lo.amin(dim=-2), hi.amax(dim=-2)

    return bbox(intr.expand(tr1.shape)), bbox(tr1)


def _offscreen(lo, hi, margin, H, W):
    """Bbox (+margin) misses the frame entirely. ``margin`` may be a Python
    number or a tensor broadcastable to [..., K]."""
    return (
        (hi[..., 0] < -margin)
        | (lo[..., 0] > W + margin)
        | (hi[..., 1] < -margin)
        | (lo[..., 1] > H + margin)
    )
