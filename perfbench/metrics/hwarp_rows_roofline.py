"""``hwarp_rows``'s share of its roofline, %: the least bytes of the bank
epochs' ``hwarp_rows_kernel`` launches in the profile (``bankbytes.
hwarp_epoch_bytes`` from the settings, the epochs counted as launches over
34) at 3.35 TB/s, over their device time. A build lies whole inside the
profiled step that dispatches it, so this is a step's bytes over a step's
time for any number of profiled steps."""

from perfbench.bankbytes import (HWARP_LAUNCHES, hwarp_epoch_bytes, launches,
                                 share)


def read(rec):
    n, seconds = launches(rec["trace"], "hwarp_rows_kernel")
    if not n:
        return None
    return share(n / HWARP_LAUNCHES * hwarp_epoch_bytes(rec["settings"]),
                 seconds)
