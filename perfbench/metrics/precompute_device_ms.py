"""Device ms a step of the work the precompute launches: the summed device
time of the kernels, copies and fills launched in the
``flowgen.precompute`` span (and in no span nested in it), joined to their
launches by correlation id, over the profiled steps."""

from perfbench.spans import span_reading


def read(rec):
    v = span_reading(rec, "flowgen.precompute", "device_s")
    return None if v is None else 1e3 * v
