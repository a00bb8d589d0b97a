"""The scene kernel's share of its roofline, %: the least bytes a step's
kernel must move at the H100 SXM's published 3.35 TB/s (NVIDIA's data
sheet, 700 W), over its measured device time a step.

The bytes are counted from the cell's shapes alone, so the count reads the
same work whatever implements the kernel: per pixel of each frame, 4 bytes
of packed RGB for each of the two frames and 8 for ``flow0``, plus 8 for
``flow1`` and 4 for each of the two id planes when the settings ask for
them, each written once. Texel reads depend on the scene and are left out,
so this is a lower bound of the bytes and the share reads low."""

from perfbench.trace import kernel_ms

PEAK_BYTES_S = 3.35e12


def step_bytes(s: dict) -> float:
    """Least bytes of one step's scene kernel under settings ``s``."""
    per_pixel = 4 * 2 + 8
    if s.get("compute_inverse_flow"):
        per_pixel += 8
    if s.get("emit_masks"):
        per_pixel += 4 * 2
    return float(s["batch_size"] * s["height"] * s["width"] * per_pixel)


def read(rec):
    ms = kernel_ms(rec["trace"], "scene_kernel")
    if ms is None:
        return None
    return 100.0 * step_bytes(rec["settings"]) / PEAK_BYTES_S / (ms / 1e3)
