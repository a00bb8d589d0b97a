"""The bank's column-inverse solve's share of its roofline, %: the least
bytes of the bank epochs' ``coarse_gdisp_batch`` calls in the profile
(``bankbytes.solve_epoch_bytes`` from the settings, the epochs counted as
``coarse_solve_kernel`` launches, or its wide form's, over 18) at 3.35
TB/s, over the device time of those launches and the ``upsample4_kernel``
launches after them."""

from perfbench.bankbytes import SOLVE_CALLS, launches, share, solve_epoch_bytes


def read(rec):
    n, solve_s = launches(rec["trace"], "coarse_solve")
    if not n:
        return None
    _, up_s = launches(rec["trace"], "upsample4_kernel")
    return share(n / SOLVE_CALLS * solve_epoch_bytes(rec["settings"]),
                 solve_s + up_s)
