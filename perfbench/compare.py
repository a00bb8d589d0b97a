"""The comparison that decides ``correct``: rows of the batches the window
produced, drawn from the seed, against the reference's rendering of the
same global sample indices.

Every output the reference returns is compared, by its kind, and each
number against its limit (``limits/<cell>.json``):

- ``flow_max_px``: the largest absolute difference of any flow value
  (``flow0``, ``flow1``), in pixels (a NaN on either side counts as
  infinite);
- ``image_share_ge1``: the share of image values (both frames, every
  channel) that lie one level or more apart;
- ``int_mismatch_share``: the share of values of the integer or boolean
  outputs (ids, masks) that differ at all; emitted only where the
  reference returns such an output.

An output of another kind has no rule, and ``numbers`` raises for it.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

import torch

FLOWS = ("flow0", "flow1")
IMAGES = ("image0", "image1")


class RowKeeper:
    """A sample, drawn from ``rng``, of the rows of every batch the window
    produced: ``slots`` rows kept by reservoir sampling over the batches
    (slot ``j`` takes its row from the first half of the batch for even
    ``j``, the second half for odd ``j``), plus one row of the window's last
    batch (:meth:`last`). Rows are copied when kept."""

    def __init__(self, slots: int, batch_size: int, rng: random.Random):
        self.slots = slots
        self.batch = batch_size
        self.rng = rng
        self.kept: List[Tuple[int, dict]] = []
        self.seen = 0

    def _row(self, j: int) -> int:
        half = self.batch // 2
        if half == 0:
            return 0
        return self.rng.randrange(half) + (j % 2) * half

    @staticmethod
    def _copy(out, r: int):
        """Row ``r`` of each output, copied (None keeps the index alone)."""
        return None if out is None else {k: v[r].clone()
                                         for k, v in out.items()}

    def offer(self, step: int, out: dict):
        """Consider the batch of global step ``step``."""
        if self.seen < self.slots:
            j = self.seen
        else:
            j = self.rng.randrange(self.seen + 1)
        self.seen += 1
        if j < self.slots:
            r = self._row(j)
            entry = (step * self.batch + r, self._copy(out, r))
            if j < len(self.kept):
                self.kept[j] = entry
            else:
                self.kept.append(entry)

    def last(self, step: int, out: dict):
        """Keep a row of the window's last batch, of global step ``step``."""
        r = self.rng.randrange(self.batch)
        self.kept.append((step * self.batch + r, self._copy(out, r)))

    def rows(self) -> Tuple[List[int], Dict[str, torch.Tensor]]:
        """The kept rows' global sample indices and their outputs stacked
        by name."""
        idx = [i for i, _ in self.kept]
        keys = self.kept[0][1].keys() if self.kept else ()
        return idx, {k: torch.stack([r[k] for _, r in self.kept])
                     for k in keys}


def numbers(prog: Dict[str, torch.Tensor],
            ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The compared numbers of the program's rows ``prog`` against the
    reference's ``ref``, which names the outputs due. An output missing
    from ``prog`` or of another shape reads as infinitely far. Raises
    ``ValueError`` for a reference output that is neither a flow, an image
    nor of an integer or boolean type."""
    inf = float("inf")
    ints = [k for k, r in ref.items()
            if not r.is_floating_point() and not r.is_complex()]
    other = sorted(set(ref) - set(FLOWS) - set(IMAGES) - set(ints))
    if other:
        raise ValueError(f"no comparison for the outputs {other}")
    keys = ["flow_max_px", "image_share_ge1"]
    keys += ["int_mismatch_share"] if ints else []
    flow, n_img, n_far, n_int, n_diff = 0.0, 0, 0, 0, 0
    for k, r in ref.items():
        p = prog.get(k)
        if p is None or tuple(p.shape) != tuple(r.shape):
            return dict.fromkeys(keys, inf)
        p = p.to(r.device)
        if k in ints:
            n_int += r.numel()
            n_diff += int((p != r).sum())
            continue
        d = (p.double() - r.double()).abs()
        if k in FLOWS:
            flow = max(flow, inf if bool(torch.isnan(d).any())
                       else float(d.max()))
        else:
            n_img += d.numel()
            n_far += int((torch.isnan(d) | (d >= 1.0)).sum())
    values = [flow, n_far / n_img if n_img else inf,
              n_diff / n_int if n_int else inf]
    return dict(zip(keys, values))


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number within its limit (a number over it, or one with
    no limit, fails)."""
    return bool(values) and all(k in limits and values[k] <= limits[k]
                                for k in values)
