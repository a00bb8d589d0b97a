"""Host-to-device copies a step: device copies named ``HtoD`` whose launch
lies in the ``flowgen.step`` span (``pipeline/generator.py:
Generator._dispatch``) or any span in it, over the profiled steps: tensors
born on the host each step."""

from perfbench.spans import span_reading


def read(rec):
    return span_reading(rec, "flowgen.step", "h2d", inclusive=True)
