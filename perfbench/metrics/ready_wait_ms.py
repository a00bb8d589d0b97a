"""How long the device keeps the consumer waiting once ``retrieve_batch``
has returned, ms: the mean over the traced run's requests outside the
profiled stretch, from the call's return to its batch being ready."""


def read(rec):
    v = rec["host"]["ready_wait_ms"]
    return sum(v) / len(v) if v else None
