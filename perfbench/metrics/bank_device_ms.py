"""Device ms a step of the work the warp-field bank's builds launch (the
``flowgen.bank_epoch`` span and the spans nested in it), over the profiled
steps."""

from perfbench.spans import span_reading


def read(rec):
    v = span_reading(rec, "flowgen.bank_epoch", "device_s", inclusive=True)
    return None if v is None else 1e3 * v
