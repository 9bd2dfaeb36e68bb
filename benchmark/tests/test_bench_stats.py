"""Rates, percentiles over all micro-steps, the union of device intervals."""

import statistics

import numpy as np
import pytest

from harness import stats


def test_percentile_matches_numpy_over_all_values():
    rng = np.random.default_rng(0)
    v = rng.exponential(100.0, 101).tolist()
    for q in (50, 90, 95):
        assert stats.percentile(v, q) == pytest.approx(float(np.percentile(v, q)), rel=1e-12)


def test_p90_of_a_hundred_steps_has_ten_above():
    v = list(range(1, 101))
    p90 = stats.percentile(v, 90)
    assert sum(x > p90 for x in v) == 10


def test_rate_is_work_over_the_whole_window():
    assert stats.rate(300.0, 1.5) == 200.0
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_union_gaps_and_covered_by_hand():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 7.0)]
    assert stats.union(iv) == [(0.0, 2.0), (3.0, 4.0), (6.0, 7.0)]
    assert stats.covered(iv, 1.0, 6.5) == pytest.approx(1.0 + 1.0 + 0.5)
    assert stats.gaps(iv, 1.0, 8.0) == [(2.0, 3.0), (4.0, 6.0), (7.0, 8.0)]
    assert stats.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_idle_share_from_the_union():
    from harness.trace import Event, Trace

    tr = Trace(10.0, 20.0, device=[Event("a", "kernel", 9.0, 11.0, 1, 0), Event("b", "kernel", 10.5, 12.0, 2, 0),
                                   Event("c", "gpu_memcpy", 15.0, 16.0, 3, 0)])
    assert tr.busy_s() == pytest.approx(3.0)
    assert tr.window_s == 10.0
    bd = tr.breakdown()
    assert bd["idle_gaps"][0][1] == pytest.approx(4.0)  # 16 .. 20
    assert [n for n, _ in bd["device_ops"]] == ["b", "a", "c"] or len(bd["device_ops"]) == 3


def test_spread_is_python_quartiles_over_the_median():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)
