"""Synchronizing CUDA runtime calls a step (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, blocking
``cudaMemcpy``) made in the ``flowgen.step`` span
(``pipeline/generator.py:Generator._dispatch``) and every span in it, over
the profiled steps. Each one stalls the host until the device catches up,
and keeps the step out of a CUDA graph."""

from perfbench.spans import span_reading


def read(rec):
    return span_reading(rec, "flowgen.step", "syncs", inclusive=True)
