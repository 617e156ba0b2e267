"""The window's arithmetic and the result line."""

import json

import pytest

from benchlib import common


def test_rate_and_percentile():
    assert common.rate(123000 * 10, 5.0) == 246000.0
    ms = list(range(1, 101))
    assert common.percentile(ms, 90) == pytest.approx(90.1)
    assert common.percentile([5.0], 90) == 5.0


def test_quartile_spread_is_statistics_quantiles():
    v = [100, 101, 99, 102, 98, 100]
    q1, q2, q3 = 98.75, 100.0, 101.25
    assert common.quartile_spread(v) == pytest.approx((q3 - q1) / q2)


def test_leaf_gaps_floor_and_rule():
    want = {"a": 1.0, "b": 2.0, "c": 1e-9}
    got = {"a": 1.0001, "b": 2.0, "c": 1e-3}
    gap, leaf = common.leaf_gaps(got, want)
    # c's gap is measured against the median norm, 1.0
    assert leaf == "c" and gap == pytest.approx(1e-3 - 1e-9)
    rule = common.moving_leaves({"a": 1.0, "b": 2.0, "c": 1e-9})
    assert not rule("c") and rule("a")
    gap, leaf = common.leaf_gaps(got, want, rule)
    assert leaf == "a" and gap == pytest.approx(1e-4 / 1.5)


def test_last_line_shape(capsys):
    check = common.checks({"loss_gap": 1e-4, "x": 2.0},
                          {"loss_gap": 1e-3, "x": 1.0})
    assert not common.all_within(check)
    result = {"correct": False, "attempted": 5, "failed": 0,
              "metrics": {"setup_s": {"value": 30.5, "unit": "s"}},
              "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                         "count": 1, "memory_peak_bytes": 1},
              "checks": check}
    common.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        line)
    assert err.strip().splitlines()[-1] == "check x 2.0 limit 1.0"
