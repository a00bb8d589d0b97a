"""CUDA kernels the scene kernel's precompute launches a step: those whose
launch lies in the ``flowgen.precompute`` span
(``compose/fused.py:scene_tables``, with ``ops/scene.py:build_worklists``)
and in no span nested in it, over the profiled steps. Exact from run to
run; a launch-cutting change to the tables moves it."""

from perfbench.spans import span_reading


def read(rec):
    return span_reading(rec, "flowgen.precompute", "kernels")
