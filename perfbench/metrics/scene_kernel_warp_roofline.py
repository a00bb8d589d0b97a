"""The scene kernel's share of its roofline in a deforming mode, %: its
expected least bytes a launch, one a step (``bankbytes.
scene_warp_step_bytes``: 16 bytes a pixel of output, 16 more a pixel of
each deforming background's warp planes at the mode's deformation share),
times its launches in the profile, at 3.35 TB/s, over their device time
(``scene_kernel*``)."""

from perfbench.bankbytes import launches, scene_warp_step_bytes, share
from perfbench.reference.scenes import MODES


def read(rec):
    s = rec["settings"]
    n, seconds = launches(rec["trace"], "scene_kernel")
    if not n:
        return None
    return share(n * scene_warp_step_bytes(s, MODES[int(s["mode"])].warp_p),
                 seconds)
