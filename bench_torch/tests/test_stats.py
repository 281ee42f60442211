import pytest

from bench_torch import stats


def test_rate_is_all_bytes_over_all_time():
    # a mean of per-call rates would read (10 + 1) / 2 = 5.5 GB/s
    assert stats.rate_gbps([10e9, 10e9], [1.0, 10.0]) == pytest.approx(20 / 11)
    with pytest.raises(ValueError):
        stats.rate_gbps([1], [])


@pytest.mark.parametrize("values,q,want", [
    (list(range(1, 101)), 95, 95),
    (list(range(1, 21)), 95, 19),
    ([5.0], 95, 5.0),
    ([3, 1, 2], 50, 2),
    (list(range(1, 1001)), 95, 950),
])
def test_percentile_nearest_rank(values, q, want):
    assert stats.percentile(values, q) == want


def test_percentile_rejects_empty_and_bad_q():
    with pytest.raises(ValueError):
        stats.percentile([], 95)
    with pytest.raises(ValueError):
        stats.percentile([1], 0)


def test_union_merges_overlaps_and_drops_empty():
    assert stats.union([(5, 6), (0, 2), (1, 3), (7, 7), (3, 4)]) == [(0, 4), (5, 6)]


def test_covered_counts_each_point_once_inside_the_window():
    ivs = [(0, 4), (2, 6), (10, 12)]
    assert stats.covered(ivs, (1, 11)) == 5 + 1
    assert stats.covered([], (0, 1)) == 0


def test_gaps_are_the_uncovered_parts():
    assert stats.gaps([(2, 3), (5, 8)], (0, 10)) == [(0, 2), (3, 5), (8, 10)]
    assert stats.gaps([(-1, 20)], (0, 10)) == []
    assert stats.gaps([], (0, 1)) == [(0, 1)]
