"""The rate and tail arithmetic, over every call."""
import pytest

from bench_h100 import stats


def test_rate_is_the_window_over_the_calls():
    assert stats.rate_ms(30.0, 240) == pytest.approx(125.0)
    with pytest.raises(ValueError):
        stats.rate_ms(1.0, 0)


def test_p95_over_every_call():
    walls = [100.0] * 190 + [200.0] * 10
    # The 95th percentile of 200 values lies between ranks 189 and 190.
    assert stats.percentile(walls, 95.0) == pytest.approx(100.0 + 0.05 * 100)
    assert stats.beyond(walls, 95.0) == 10
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95.0) == pytest.approx(95.05)
    assert stats.percentile(xs, 0.0) == 1 and stats.percentile(xs, 100.0) == 100

