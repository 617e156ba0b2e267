"""PyTorch port, carrying the JAX package's train state across: AdamW
moments through ``convert.from_flax_state`` (with and without the clip
stage of the optax chain), and the slice as a whole: an epoch that the port
resumes from a JAX orbax checkpoint, converted by
``tools/orbax_to_torch.py``, against the epoch JAX resumes from it."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import train as jax_train  # noqa: E402
from stratified_transformer_tpu.train import schedulers as jax_sched  # noqa
from stratified_transformer_tpu.train.state import (  # noqa: E402
    make_optimizer as jax_make_optimizer)
from stratified_transformer_torch.config import StratifiedConfig  # noqa
from stratified_transformer_torch.convert import (  # noqa: E402
    from_flax, from_flax_state)
from stratified_transformer_torch.models.stratified import (  # noqa: E402
    Stratified)
from stratified_transformer_torch.train import driver  # noqa: E402
from stratified_transformer_torch.train import schedulers  # noqa: E402
from stratified_transformer_torch.train.state import (  # noqa: E402
    make_optimizer, optimizer_step)
from stratified_transformer_torch.utils.config import (  # noqa: E402
    load_cfg, merge_cfg_from_list)
from tools import orbax_to_torch  # noqa: E402

torch.set_num_threads(1)

CONFIG = os.path.join(REPO, "configs", "s3dis_stratified.yaml")
NARROW = dict(channels=(16, 32, 64, 128), num_heads=(1, 2, 4, 8),
              depths=(1, 1, 2, 1), n_pad=2048, num_scenes=2)
SCHEDULE_CFG = {"scheduler": "MultiStep", "scheduler_update": "epoch",
                "base_lr": 0.006, "epochs": 100}
# parameters after one AdamW step from the converted moments: the same
# update in fp32 by two libraries (tests/test_torch_train.py)
PARAM_REL_L2 = 1e-4


def to_flax(model, rng):
    """A flax-style parameter tree of random values for the port model's
    parameters (the inverse of `from_flax`'s naming)."""
    tree = {}
    for name, p in model.named_parameters():
        *mods, leaf = name.split(".")
        value = rng.normal(0, 0.1, tuple(p.shape)).astype(np.float32)
        if leaf == "weight" and p.dim() == 2:
            leaf, value = "kernel", np.ascontiguousarray(value.T)
        elif leaf == "weight":
            leaf = "scale"
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = value
    return tree


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adam_moments_carry_across(clip):
    """One optax update of the JAX chain, its state converted, then one
    more update on each side: the moments equal, the parameters within
    PARAM_REL_L2. A moment on the wrong parameter, or an untransposed
    kernel's, moves the second update far beyond it."""
    model = Stratified(StratifiedConfig(**NARROW))
    rng = np.random.default_rng(0)
    params = to_flax(model, rng)
    grads = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
        np.float32), params) for _ in range(2)]
    schedule = jax_sched.from_config(SCHEDULE_CFG, 2)[0]
    tx = jax_make_optimizer(params, schedule, 0.01, 0.1, grad_clip=clip)
    update = jax.jit(tx.update)
    updates, state = update(grads[0], tx.init(params), params)
    params = jax.tree.map(np.asarray, jax.tree.map(
        lambda p, u: p + u, params, updates))

    optimizer = make_optimizer(
        model, schedulers.from_config(SCHEDULE_CFG, 2)[0],
        max_grad_norm=clip)
    payload = from_flax_state(
        orbax_to_torch.plain_tree(params), {},
        orbax_to_torch.plain_tree(state), 1, 0, model=model,
        optimizer=optimizer)
    model.load_state_dict(payload["model"], strict=False)
    optimizer.load_state_dict(payload["optimizer"])
    assert [g["t"] for g in optimizer.param_groups] == [1, 1]
    mu = from_flax(orbax_to_torch.plain_tree(state)[
        0 if clip is None else 1][0]["mu"])
    for name, p in model.named_parameters():
        assert torch.equal(optimizer.state[p]["exp_avg"], mu[name]), name
        assert float(optimizer.state[p]["step"]) == 1.0

    updates, _ = update(grads[1], state, params)
    want = from_flax(jax.tree.map(lambda p, u: p + u, params, updates))
    g2 = from_flax(grads[1])
    for name, p in model.named_parameters():
        p.grad = g2[name].clone()
    optimizer_step(optimizer)
    for name, p in model.named_parameters():
        assert _rel_l2(p.detach().numpy(), want[name].numpy()) < \
            PARAM_REL_L2, name


def test_from_flax_state_needs_one_adam_state():
    model = Stratified(StratifiedConfig(**NARROW))
    opt = make_optimizer(model, lambda s: 0.0)
    with pytest.raises(ValueError, match="one ScaleByAdamState"):
        from_flax_state({}, {}, ({"trace": {}}, {}), 0, 0, model=model,
                        optimizer=opt)
    with pytest.raises(ValueError, match="AdamW"):
        from_flax_state({}, {}, (), 0, 0, model=model,
                        optimizer=make_optimizer(model, lambda s: 0.0,
                                                 optimizer="SGD"))


# the slice: JAX trains two epochs (jnp attention, drop-path off, augmented
# synthetic rooms, validation); the port resumes epoch 2 from JAX's epoch-1
# checkpoint. The milestones are given so that the schedule does not depend
# on ``epochs``.
SLICE = ["data_name", "synthetic", "synthetic_scenes", "4",
         "synthetic_points", "1500", "voxel_max", "900", "max_batch_points",
         "2048", "batch_size", "2", "channels", "[16,32,64,128]", "num_heads",
         "[1,2,4,8]", "depths", "[1,1,2,1]", "attn_impl", "reference",
         "drop_path_rate", "0.0", "evaluate", "True", "aug", "True",
         "n_devices", "1", "print_freq", "1", "rpe_precision", "highest",
         "qk_precision", "highest", "use_tensorboard", "False",
         "truncation_audit", "False", "compress_payload", "False", "epochs",
         "2", "milestones", "[1]"]
# epoch 2's records, port against JAX: two AdamW steps from the same state
# on the same batches, then validation; fp32 sums in another order through
# the model and its backward, and XLA's FMA contraction of the bin formula
# on the CPU, which moves a few boundary bins. Measured: the train loss
# equal, the validation loss 9e-6 apart (relative) and its mIoU 1e-5;
# `tests/test_torch_train.py` holds a 5-step loss to 1e-4. An IoU moves when a point's
# predicted class flips, by ~1e-4 for one point of a small class.
LOSS_RTOL, IOU_ATOL = 1e-4, 1e-3


def test_resumed_epoch_matches_jax(tmp_path, monkeypatch):
    """JAX's epoch 2 continues from the state it saved after epoch 1; the
    port's epoch 2 resumes from that checkpoint, converted by
    ``tools/orbax_to_torch.py``: the two ``metrics.jsonl`` records of epoch
    2 agree. (The synthetic rooms draw per item and drop-path is off, so
    JAX's epoch 2 is the one it would resume.)"""
    jax_save, port_save = str(tmp_path / "jax"), str(tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["train.py", "--config", CONFIG] + SLICE
                        + ["save_path", jax_save])
    jax_train.main()
    assert orbax_to_torch.main([
        "--config", CONFIG, "--ckpt", os.path.join(jax_save, "ckpt"),
        "--epoch", "1", "--out", os.path.join(port_save, "ckpt", "1.pt")]
        + SLICE) == 0
    _, summary = driver.run(merge_cfg_from_list(load_cfg(CONFIG), SLICE + [
        "save_path", port_save, "resume", os.path.join(port_save, "ckpt")]),
        "cpu", log=lambda _: None)

    with open(os.path.join(jax_save, "metrics.jsonl")) as f:
        want = [json.loads(line) for line in f][1]
    [got] = summary["records"]
    assert got["epoch"] == want["epoch"] == 2 and summary["step"] == 4
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                   err_msg=key)
    for key in ("miou", "macc", "all_acc", "val_miou"):
        np.testing.assert_allclose(got[key], want[key], atol=IOU_ATOL,
                                   err_msg=key)
