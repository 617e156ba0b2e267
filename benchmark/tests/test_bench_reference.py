"""The reference (a frozen copy of the port's plain path) against the
port's own plain path (``attn_impl: reference``) on the CPU at a tiny
size: the same weights, batch and drop-path seeds give the same logits,
loss and gradients to fp32 rounding."""

import dataclasses

import numpy as np
import pytest
import torch

from benchlib import traffic, weights
from reference import run as ref
from tiny import tiny_cell

torch.set_num_threads(4)


def _setup(name):
    from stratified_transformer_torch.config import from_cfg
    from stratified_transformer_torch.data.collate import PaddedBatch
    from stratified_transformer_torch.data.loader import (
        finish_batch, to_device)
    from stratified_transformer_torch.models.stratified import Stratified
    from stratified_transformer_torch.utils.config import CfgNode
    cell = tiny_cell(name)
    y = CfgNode(cell.yaml)
    cfg = dataclasses.replace(from_cfg(y), attn_impl="reference",
                              rpe_precision="highest",
                              qk_precision="highest")
    batch = traffic.train_batches(cell.traffic, cfg, y, 3)[0]
    hb = to_device(finish_batch(PaddedBatch(
        xyz=batch["xyz"], feats=batch["feats"], labels=batch["labels"],
        offsets=batch["offsets"]), cfg), "cpu")
    model = Stratified(cfg)
    weights.load(model, 7)
    ref_cfg = ref.model_config(y)
    w = weights.generate(weights.spec(ref.Stratified(ref_cfg)), 7, "cpu")
    return y, cfg, batch, hb, model, ref_cfg, w


@pytest.mark.parametrize("name", ["s3dis-train", "scannet-train"])
def test_train_step_matches_the_port(name):
    from stratified_transformer_torch.train import losses
    from stratified_transformer_torch.ops import sampling
    y, cfg, batch, hb, model, ref_cfg, w = _setup(name)
    model.train()
    gen = torch.Generator().manual_seed(11)
    logits, _ = model(hb["feats"], hb["xyz"], hb["offsets"],
                      stem_nidx=hb["stem_nidx"], stem_nmask=hb["stem_nmask"],
                      pyramid=hb["pyramid"], generator=gen)
    valid = sampling.offsets_to_valid(hb["offsets"], hb["xyz"].shape[0])
    loss = losses.cross_entropy(logits, hb["labels"],
                                int(y.get("ignore_label", 255)), valid)
    loss.backward()
    want = {n: float(p.grad.double().norm())
            for n, p in model.named_parameters() if p.grad is not None}
    y2 = dict(y, max_grad_norm=None)
    out = ref.train_steps(y2, ref_cfg, w, [batch], [11], "cpu", 1000)
    assert out["loss"][0] == pytest.approx(float(loss.detach()), rel=1e-5)
    assert set(out["grad1"]) == set(want)
    for n in want:
        assert out["grad1"][n] == pytest.approx(want[n], rel=2e-3,
                                                abs=1e-7), n


def test_eval_forward_matches_the_port():
    from stratified_transformer_torch.eval.driver import eval_config
    from stratified_transformer_torch.models.stratified import Stratified
    from stratified_transformer_torch.utils.config import CfgNode
    cell = tiny_cell("s3dis-eval")
    y = CfgNode(cell.yaml)
    cfg = dataclasses.replace(eval_config(y), attn_impl="reference",
                              rpe_precision="highest",
                              qk_precision="highest")
    b = traffic.eval_batches(cell.traffic, cfg, y)[0]
    model = Stratified(cfg).eval()
    weights.load(model, 5)
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(b["feats"]),
                          torch.from_numpy(b["xyz"]),
                          torch.from_numpy(b["offsets"]).long())
    want = torch.softmax(logits, -1).numpy()
    ref_cfg = ref.model_config(y, cfg.n_pad, cfg.num_scenes)
    w = weights.generate(weights.spec(ref.Stratified(ref_cfg)), 5, "cpu")
    got = ref.eval_probs(ref_cfg, w, b, "cpu")
    np.testing.assert_allclose(got[:b["points"]], want[:b["points"]],
                               rtol=1e-5, atol=1e-7)
