"""Share of the profiled stretch in which nothing ran on the device: one
minus the union of its activity intervals over the stretch's wall time."""


def read(rec):
    t = rec["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
