"""Host ms a step in the precompute: the ``flowgen.precompute`` span's own
wall time (``compose/fused.py:scene_tables``, less any span nested in it)
over the profiled steps. The profiler slows the host 1.5-2 times, so this
compares between trees, not with the unprofiled ``host_step_ms``."""

from perfbench.spans import span_reading


def read(rec):
    v = span_reading(rec, "flowgen.precompute", "self_s")
    return None if v is None else 1e3 * v
