"""CUDA kernels the warp-field bank's builds launch a step: those whose
launch lies in a ``flowgen.bank_epoch`` span or any span nested in it,
over the profiled steps. Exact from run to run."""

from perfbench.spans import span_reading


def read(rec):
    return span_reading(rec, "flowgen.bank_epoch", "kernels", inclusive=True)
