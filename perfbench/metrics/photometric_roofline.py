"""The photometric jitter's share of its bytes roofline, %: every float32
value of both frames read once and written once (8 bytes a value) at the
H100 SXM's published 3.35 TB/s (NVIDIA's data sheet, 700 W), over its
measured device time a step. NVIDIA publishes no int32 rate, so the
operations' bound is not taken."""

from perfbench.trace import kernel_ms

PEAK_BYTES_S = 3.35e12


def step_bytes(s: dict) -> float:
    """Least bytes of one step's photometric pass under settings ``s``."""
    return 8.0 * s["batch_size"] * s["height"] * s["width"] * 3 * 2


def read(rec):
    ms = kernel_ms(rec["trace"], "photometric")
    if ms is None:
        return None
    return 100.0 * step_bytes(rec["settings"]) / PEAK_BYTES_S / (ms / 1e3)
