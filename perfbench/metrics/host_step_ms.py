"""Host time of one ``retrieve_batch`` call, ms: the mean over the traced
run's requests outside the profiled stretch, from the request to the
call's return. It is the host's enqueue of a step (``Generator._dispatch``
→ ``generate_batch``: sampler, precompute or windowed plan, kernels'
launches), including any device-to-host read the step makes."""


def read(rec):
    v = rec["host"]["step_ms"]
    return sum(v) / len(v) if v else None
