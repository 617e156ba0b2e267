"""The frozen arithmetic against hand counts at tiny sizes."""

import types

import pytest
import torch

from benchlib import arith


def test_least_ops_hand_count():
    # 10 pairs, 4 queries, 4 keys, 1 head, d = 2, 2 table rows: every
    # table term is cheaper per pair (6d*10 = 120 <= 6*2*2*4 + 30 = 126)
    assert arith.least_ops(10, 4, 4, 1, 2, 2, split=True) == (
        4 * 2 * 10 + 6 * 2 * 10 * 2 + 3 * 2 * 10, 5 * 10 + 24 * 10)
    # at 1000 pairs the projection form wins for every table
    prod, other = arith.least_ops(1000, 4, 4, 1, 2, 2, split=True)
    assert prod == 4 * 2 * 1000 + 3 * (6 * 2 * 2 * 4)
    assert other == 5 * 1000 + 3 * 3 * 1000 + 24 * 1000
    assert arith.least_ops(1000, 4, 4, 1, 2, 2) == prod + other


def test_backward_and_recomputation():
    total = arith.least_ops_bwd(10, 4, 4, 1, 2, 2)
    assert total == (10 * 2 * 10 + 5 * 10 + 2 * 2 * 4 + 8 * 6 * 2 * 10
                     + 24 * 10)
    # the recomputed logits: q.k (2d), the Tq and Tk terms, the bins
    assert arith.recomputed_ops(10, 4, 4, 1, 2, 2) == (
        2 * 2 * 10 + 2 * 6 * 2 * 10 + 24 * 10)


def test_least_seconds_takes_the_larger_bound():
    assert arith.ops_seconds((989e12, 0)) == pytest.approx(1.0)
    assert arith.ops_seconds((0, 67e12)) == pytest.approx(1.0)
    assert arith.least_seconds((989e12, 0), 3.35e12 * 2) == \
        pytest.approx(2.0)


def test_band_pairs_on_a_hand_plan():
    # 8 sorted points in windows [0,3) [3,8), point 7 invalid; tile 4,
    # band 0: tile 0 sees keys 0-3, tile 1 keys 4-7
    plan = types.SimpleNamespace(
        seg_start=torch.tensor([0, 0, 0, 3, 3, 3, 3, 3]),
        seg_end=torch.tensor([3, 3, 3, 8, 8, 8, 8, 8]),
        valid_sorted=torch.tensor([True] * 7 + [False]))
    # rows 0-2: 3 keys each; row 3: key 3 only; rows 4-6: keys 4-6
    assert arith.band_pairs(plan, 0, 4) == 9 + 1 + 9
    # a band of 4 lets row 3 reach keys 4-6 and rows 4-6 key 3
    assert arith.band_pairs(plan, 4, 4) == 9 + 4 + 12


def test_dense_flops_hand_count():
    cfg = types.SimpleNamespace(
        channels=(2, 4), depths=(1, 1), num_layers=2, layer_start=0,
        mlp_ratio=4.0, num_classes=3, in_channels=6, stem_transformer=True)
    n = [10, 3]
    blocks = 10 * 2 * 4 * 12 + 3 * 2 * 16 * 12
    down_up = 2 * 2 * 4 * 10 + 2 * 4 * 2 * 3 + 2 * 2 * 2 * 10
    head = 2 * 4 * 10 + 2 * 2 * 3 * 10
    stem = 2 * 15 * 6 * 50 + 2 * 15 * 6 * 2 * 10
    assert arith.dense_flops(cfg, n, 50) == blocks + down_up + head + stem
