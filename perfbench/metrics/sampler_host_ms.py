"""Host ms a step in the sampler: the ``flowgen.sampler`` span's own wall
time (``params/sampler.py:sample_scene_batch``, less any span nested in
it) over the profiled steps. The profiler slows the host 1.5-2 times, so
this compares between trees, not with the unprofiled ``host_step_ms``."""

from perfbench.spans import span_reading


def read(rec):
    v = span_reading(rec, "flowgen.sampler", "self_s")
    return None if v is None else 1e3 * v
