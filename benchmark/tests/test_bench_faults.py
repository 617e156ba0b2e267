"""A whole run without the harness's look for a card, on the CPU at a tiny
size, with the timed path broken underneath: each fault a cell can have
must turn ``correct`` false, and the sound path must not. The limits are
the cells' own (``workloads/<cell>.json``)."""

import time

import numpy as np
import pytest
import torch

from benchlib import runner
from tiny import tiny_cell

torch.set_num_threads(4)

SEED = 2 ** 31 + 101


def run(name, seconds=1.0):
    return runner.run(tiny_cell(name), SEED, seconds, False, "cpu",
                      time.time(), log=lambda m: None)


@pytest.mark.parametrize("name", ["s3dis-train", "scannet-train",
                                  "s3dis-eval", "scannet-eval"])
def test_sound_path_is_correct(name):
    assert run(name)["correct"]


def test_train_state_unchanged(monkeypatch):
    from stratified_transformer_torch.train import step
    monkeypatch.setattr(step, "optimizer_step", lambda opt: None)
    r = run("s3dis-train")
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["s3dis-train", "scannet-train"])
def test_train_half_batch(monkeypatch, name):
    from stratified_transformer_torch.train import losses
    plain = losses.cross_entropy

    def half(logits, labels, ignore_label, valid=None, smoothing=0.0):
        keep = valid & (torch.cumsum(valid.long(), 0) <= valid.sum() // 2)
        return plain(logits, labels, ignore_label, keep, smoothing)

    monkeypatch.setattr(losses, "cross_entropy", half)
    assert not run(name)["correct"]


def _wrap_predict(monkeypatch, alter):
    from stratified_transformer_torch.eval import driver
    make = driver.make_predict_probs

    def broken(model):
        predict = make(model)
        return lambda feats, xyz, offsets: alter(predict, feats, xyz,
                                                 offsets)

    monkeypatch.setattr(driver, "make_predict_probs", broken)


@pytest.mark.parametrize("name", ["s3dis-eval", "scannet-eval"])
def test_eval_answer_altered(monkeypatch, name):
    def alter(predict, feats, xyz, offsets):
        probs = predict(feats, xyz, offsets).copy()
        probs[0] = np.roll(probs[0], 1)
        return probs

    _wrap_predict(monkeypatch, alter)
    assert not run(name)["correct"]


@pytest.mark.parametrize("name", ["s3dis-eval", "scannet-eval"])
def test_eval_half_batch(monkeypatch, name):
    def alter(predict, feats, xyz, offsets):
        half = np.minimum(offsets, offsets[-1] // 2).astype(offsets.dtype)
        return predict(feats, xyz, half)

    _wrap_predict(monkeypatch, alter)
    assert not run(name)["correct"]
