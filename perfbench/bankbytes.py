"""Least bytes of mode 9's warp-field bank and of its scene kernel, from a
cell's settings alone, so that the counts read the same work whatever
implements it (H100 SXM: 3.35 TB/s, NVIDIA's data sheet, 700 W).

A bank epoch (every ``warp_bank_reuse_steps`` steps) composes
``warp_fields_per_batch`` fields, each with its inverse (M = 2F
directions), on big fields of ``S = 3 max(W, H)``: 16 doublings on the half
lattice (S/2), a x2 upsample, 1 doubling at S. A doubling is one
column-inverse solve on its M fields and two ``hwarp_rows`` launches on
their (M, 2, s, s) planes (rows, then the transposed planes); the scene's
planes add one solve on the F inverse fields at S. The rules:

- ``hwarp_rows``: every plane element read once and written once (8 bytes)
  and its field's displacement read once for the two channels (4 bytes a
  row element, 2 a plane element): 10 bytes an element;
- the solve (``coarse_gdisp_batch``, ``coarse_solve_kernel`` then
  ``upsample4_kernel``): D's every 4th row and column of both channels
  read once and the full-size plane written once.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
COMPOSE_ITERS = 17
HALF_ITERS = 16
STRIDE = 4


def _shape(s: dict):
    return 3 * max(int(s["width"]), int(s["height"])), int(
        s["warp_fields_per_batch"])


def hwarp_launch_bytes(m: int, size: int) -> float:
    """One ``hwarp_rows`` launch on (m, 2, size, size) planes."""
    return 4.0 * (2 * m * 2 * size * size + m * size * size)


def solve_bytes(n: int, size: int) -> float:
    """One ``coarse_gdisp_batch`` call on n (size, size, 2) fields."""
    c = size // STRIDE
    return 4.0 * (2 * n * c * c + n * size * size)


def doublings(s: dict):
    """(size, launches' direction count) of an epoch's doublings."""
    big, fields = _shape(s)
    m = 2 * fields
    return ([(big // 2, m)] * HALF_ITERS
            + [(big, m)] * (COMPOSE_ITERS - HALF_ITERS))


def hwarp_epoch_bytes(s: dict) -> float:
    return sum(2 * hwarp_launch_bytes(m, size) for size, m in doublings(s))


def solve_epoch_bytes(s: dict) -> float:
    big, fields = _shape(s)
    return (sum(solve_bytes(m, size) for size, m in doublings(s))
            + solve_bytes(fields, big))


def scene_warp_step_bytes(s: dict, warp_p: float) -> float:
    """A mode-9 step's scene kernel, expected least bytes: per pixel of
    each frame two frames of packed RGB and ``flow0`` (16 bytes), plus,
    over the frame of each sample whose background deforms (a share
    ``warp_p`` of them), the slot's two displacement planes that its frame
    1 reads and the forward field's two planes that its ``flow0`` reads
    (16 bytes). Deforming objects' planes and texels are left out."""
    pixels = int(s["batch_size"]) * int(s["height"]) * int(s["width"])
    return pixels * (16.0 + 16.0 * float(warp_p))


# Launches of an epoch: two ``hwarp_rows`` and one solve a doubling, and
# the scene planes' solve.
HWARP_LAUNCHES = 2 * COMPOSE_ITERS
SOLVE_CALLS = COMPOSE_ITERS + 1


def launches(summary, token: str):
    """(count, device seconds) of the profile's kernels whose name holds
    ``token``; (0, 0.0) without a profile."""
    hit = [s for name, s in (summary or {}).get("kernels", ())
           if token in name]
    return len(hit), float(sum(hit))


def share(nbytes: float, seconds: float):
    """% of the peak: ``nbytes`` over ``seconds`` of device time; None
    without a time."""
    if not seconds > 0:
        return None
    return 100.0 * nbytes / PEAK_BYTES_S / seconds
