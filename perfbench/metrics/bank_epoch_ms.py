"""Host ms a step in the warp-field bank's builds: the ``flowgen.bank_epoch``
span's wall time (``pipeline/generator.py:BankEpochCache``, one build every
``warp_bank_reuse_steps`` steps, phases nested in it) over the profiled
steps. The profiler slows the host 1.5-2 times: compare between trees."""

from perfbench.spans import span_reading


def read(rec):
    v = span_reading(rec, "flowgen.bank_epoch", "host_s")
    return None if v is None else 1e3 * v
