"""The end-to-end statistics on scripted clocks."""

import pytest

from perfbench import run, stats


class ScriptedGenerator:
    """A generator on a scripted clock: each request takes ``host`` seconds
    to return and ``device`` more to be ready; requests in ``stalled`` are
    ready ``stall`` seconds later still."""

    def __init__(self, host, device, stalled=(), stall=0.0):
        self.t = 0.0
        self.host, self.device = host, device
        self.stalled, self.stall = set(stalled), stall
        self.n = 0

    def clock(self):
        return self.t

    def next_ready(self):
        self.t += self.host
        extra = self.stall if self.n in self.stalled else 0.0
        self.n += 1

        def wait():
            self.t += self.device + extra

        return {"i": self.n}, wait


def window(gen, seconds=10.0, batch=64):
    t_open, t_close, recs, last = run.closed_loop(gen.next_ready, seconds,
                                                  batch, clock=gen.clock)
    return (stats.samples_per_s(recs, t_open, t_close),
            stats.batch_wait_p95_ms(recs), recs, last)


def test_steady_window():
    rate, p95, recs, last = window(ScriptedGenerator(0.0625, 0.0625))
    assert len(recs) == 80
    assert last == {"i": 80}
    assert rate == pytest.approx(80 * 64 / 10.0)
    assert p95 == pytest.approx(125.0)


def test_a_stall_inside_the_window_moves_both():
    base_rate, base_p95, _, _ = window(ScriptedGenerator(0.0625, 0.0625))
    # eight requests in the middle of the window wait 250 ms more each
    rate, p95, recs, _ = window(ScriptedGenerator(0.0625, 0.0625,
                                                  range(30, 38), 0.25))
    assert len(recs) == 64
    assert rate == pytest.approx(64 * 64 / 10.0)
    assert rate < base_rate
    assert p95 == pytest.approx(375.0)
    assert p95 > base_p95


def test_no_request_after_the_close():
    gen = ScriptedGenerator(0.25, 0.125)      # requests at 0, 0.375, 0.75
    t_open, t_close, recs, _ = run.closed_loop(gen.next_ready, 1.0, 1,
                                               clock=gen.clock)
    assert [r.t_req for r in recs] == [0.0, 0.375, 0.75]
    # the one ready at 1.125 is past the close: two samples in one second
    assert stats.samples_per_s(recs, t_open, t_close) == pytest.approx(2.0)


def test_rate_counts_only_batches_ready_inside_the_window():
    recs = [stats.Batch(0.0, 0.1, 0.5, 8), stats.Batch(0.5, 0.6, 1.0, 8),
            stats.Batch(1.0, 1.1, 1.4, 8)]
    assert stats.samples_per_s(recs, 0.0, 1.2) == pytest.approx(16 / 1.2)


def test_percentile_is_nearest_rank():
    assert stats.percentile(list(range(1, 101)), 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile(list(range(1, 21)), 95) == 19


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == pytest.approx(
        (5.25 - 1.75) / 3.5)
