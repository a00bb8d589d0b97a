"""Samples a second of the traced run before its profile starts, in the
window's first half: the samples of those requests over the seconds from
each request to its batch being ready. The profile's stop and the reading
of its events stall the window's second half, and the host runs slower
after them, so only the first half stands for an untraced run's rate, which
the host's speed swings too widely to bound end to end (PERF.md §2)."""


def read(rec):
    n = rec["host"].get("before_profile")
    step = rec["host"]["step_ms"][:n]
    wait = rec["host"]["ready_wait_ms"][:n]
    if not step:
        return None
    return rec["settings"]["batch_size"] * len(step) / (
        1e-3 * (sum(step) + sum(wait)))
