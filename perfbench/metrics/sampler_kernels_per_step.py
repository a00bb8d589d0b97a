"""CUDA kernels the sampler launches a step: those whose launch lies in the
``flowgen.sampler`` span (``params/sampler.py:sample_scene_batch``) and in
no span nested in it, over the profiled steps. Exact from run to run; a
launch-cutting change to the sampler moves it."""

from perfbench.spans import span_reading


def read(rec):
    return span_reading(rec, "flowgen.sampler", "kernels")
