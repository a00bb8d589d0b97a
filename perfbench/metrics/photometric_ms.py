"""Device time of the photometric jitter (``ops/photometric.py:
augment_batch`` → ``csrc/photometric.cu``: ``photometric_table_kernel``
and ``photometric_kernel``) a step, ms."""

from perfbench.trace import kernel_ms


def read(rec):
    return kernel_ms(rec["trace"], "photometric")
