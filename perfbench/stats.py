"""The statistics the benchmark reports, from the window's per-batch clock
readings. Each batch is a record ``(t_req, t_ret, t_ready, samples)``: when
the consumer asked for it, when ``retrieve_batch`` returned, when the batch
was ready on the device, and how many samples it holds."""

from __future__ import annotations

import math
import statistics
from typing import NamedTuple, Sequence


class Batch(NamedTuple):
    t_req: float
    t_ret: float
    t_ready: float
    samples: int


def samples_per_s(batches: Sequence[Batch], t_open: float,
                  t_close: float) -> float:
    """Samples of every batch that became ready inside the window
    [``t_open``, ``t_close``], over the window's seconds: all the work over
    all the time, whatever the spread of single batches."""
    done = sum(b.samples for b in batches if t_open <= b.t_ready <= t_close)
    return done / (t_close - t_open)


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q <= 100): the smallest value
    that at least ``q`` percent of the values do not exceed."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def batch_wait_p95_ms(batches: Sequence[Batch]) -> float:
    """The 95th percentile over all batches of the window of the consumer's
    wait, from its request to the batch being ready, in ms."""
    return 1e3 * percentile([b.t_ready - b.t_req for b in batches], 95.0)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
