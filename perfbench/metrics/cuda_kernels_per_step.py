"""CUDA kernels launched a step: the kernels the profile saw launched,
over the profiled steps. The host's launch cost follows this count."""


def read(rec):
    t = rec["trace"]
    if not t or not t["kernels"]:
        return None
    return len(t["kernels"]) / t["steps"]
