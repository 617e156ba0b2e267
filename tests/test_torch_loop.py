"""PyTorch port, the training loop: datasets, the ordered prefetch loader,
Mix3D, the truncation audit and checkpoints against the JAX package's
(``train.py::build_dataset`` / ``BatchLoader``, ``train/audit.py``), and the
port's own resume, at a narrow width on the CPU."""

import json
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import train as jax_train
from stratified_transformer_tpu.data import collate as jax_collate
from stratified_transformer_tpu.data import datasets as jax_datasets
from stratified_transformer_tpu.data import transforms as jax_tf
from stratified_transformer_tpu.train import audit as jax_audit
from stratified_transformer_torch.config import from_cfg
from stratified_transformer_torch.data import collate, datasets, loader
from stratified_transformer_torch.data.transforms import train_transform
from stratified_transformer_torch.models.stratified import build_model
from stratified_transformer_torch.train import audit, checkpoint, driver
from stratified_transformer_torch.utils.config import (
    load_cfg, merge_cfg_from_list)

torch.set_num_threads(1)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "s3dis_stratified.yaml")
NARROW = {"channels": [16, 32, 64, 128], "num_heads": [1, 2, 4, 8],
          "depths": [1, 1, 2, 1], "max_batch_points": 2048, "batch_size": 2,
          "voxel_max": 900, "compress_payload": False}


def yaml_cfg(**kw):
    return merge_cfg_from_list(load_cfg(CONFIG), []) | NARROW | kw


def write_rooms(root, n=1200, seed=0):
    """S3DIS-format rooms of ``n`` random points: three train rooms (areas
    1-2) and one of the test area 5."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for name in ("Area_1_office_1", "Area_1_office_2", "Area_2_office_1",
                 "Area_5_office_1"):
        room = np.concatenate([
            rng.uniform(0, 2, (n, 3)), rng.uniform(0, 255, (n, 3)),
            rng.integers(0, 13, (n, 1))], 1).astype(np.float32)
        np.save(os.path.join(root, name + ".npy"), room)


def jax_transform(cfg):
    return jax_tf.Compose([
        jax_tf.RandomRotate(along_z=cfg.get("rotate_along_z", True)),
        jax_tf.RandomScale(cfg.get("scale_low", 0.8),
                           cfg.get("scale_high", 1.2)),
        jax_tf.RandomJitter(cfg.get("jitter_sigma", 0.005),
                            cfg.get("jitter_clip", 0.02)),
        jax_tf.RandomDropColor(color_augment=cfg.get("color_augment", 0.0))])


def assert_batches_equal(got, want):
    """Every field and pyramid leaf equal, dtype and bits."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            gl, wl = jax.tree.leaves(g[key]), jax.tree.leaves(w[key])
            assert len(gl) == len(wl), key
            for a, b in zip(gl, wl):
                assert a.dtype == b.dtype, key
                np.testing.assert_array_equal(a, b, err_msg=key)


def port_batches(cfg, seed=123):
    return list(loader.BatchLoader(loader.build_dataset(cfg, "train"),
                                   from_cfg(cfg), cfg, shuffle=True,
                                   seed=seed))


def jax_batches(cfg, seed=123):
    mcfg = jax_train.build_model_config(cfg, 1)
    return [b[0] for b in jax_train.BatchLoader(
        jax_train.build_dataset(cfg, "train", mcfg), mcfg, cfg, 1,
        shuffle=True, seed=seed)]


def test_augmented_synthetic_rooms_equal_jax():
    """An augmented item draws its transform from its own generator, as the
    JAX package's does (the port drew it from a separate generator)."""
    cfg = yaml_cfg()
    kw = dict(num_scenes=4, points=1500, voxel_size=0.04, voxel_max=900,
              seed=0)
    ours = datasets.SyntheticRooms(transform=train_transform(cfg), **kw)
    theirs = jax_datasets.SyntheticRooms(transform=jax_transform(cfg), **kw)
    plain = datasets.SyntheticRooms(**kw)
    for i in range(4):
        a, b = ours[i], theirs[i]
        for key in ("xyz", "feats", "labels"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert not np.array_equal(a["xyz"], plain[i]["xyz"])


LOADER_CASES = {
    "s3dis_aug_loop2_workers2": dict(data_name="s3dis", aug=True, loop=2,
                                     prefetch_workers=2),
    "synthetic_aug": dict(data_name="synthetic", aug=True,
                          synthetic_scenes=6, synthetic_points=1500),
    "mix3d": dict(data_name="synthetic", aug=True, mix3d=1.0,
                  synthetic_scenes=8, synthetic_points=800, voxel_max=500,
                  batch_size=4, max_batch_points=4096),
    "sync": dict(data_name="s3dis", aug=True, loop=8, prefetch=False),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_batches_equal_jax(case, tmp_path):
    write_rooms(tmp_path)
    cfg = yaml_cfg(data_root=str(tmp_path), **LOADER_CASES[case])
    got = port_batches(cfg)
    assert_batches_equal(got, jax_batches(cfg))
    offsets = [b["offsets"] for b in got]
    if case == "mix3d":
        # four scenes mixed into two: offsets [a, b, b, b]
        assert all(len(np.unique(o)) == 2 for o in offsets)
    if case == "sync":
        # the ordered prefetch gives the same batches with more workers
        # than cores and a thread switch every 10 us: the workers share
        # the reader's per-item visit counters
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            many = port_batches(dict(cfg, prefetch=True,
                                     prefetch_workers=12))
        finally:
            sys.setswitchinterval(interval)
        assert_batches_equal(many, got)


def test_mix3d_pairs_equal_jax():
    rng = np.random.default_rng(0)
    scenes = [{"xyz": rng.normal(size=(n, 3)), "feats": rng.normal(
        size=(n, 6)), "labels": rng.integers(0, 13, n)} for n in (5, 7, 3)]
    got, want = collate.mix3d_pairs(scenes), jax_collate.mix3d_pairs(scenes)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])


class Failing:
    """Synthetic rooms whose item ``bad`` raises."""

    def __init__(self, bad):
        self.rooms = datasets.SyntheticRooms(num_scenes=8, points=600,
                                             voxel_max=400)
        self.bad = bad

    def __len__(self):
        return len(self.rooms)

    def __getitem__(self, idx):
        if idx == self.bad:
            raise RuntimeError(f"unreadable item {idx}")
        return self.rooms[idx]


def loader_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("BatchLoader-")]


def test_worker_exception_reaches_the_consumer():
    cfg = yaml_cfg(prefetch_workers=2)
    bl = loader.BatchLoader(Failing(bad=5), from_cfg(cfg), cfg,
                            shuffle=False)
    with pytest.raises(RuntimeError, match="unreadable item 5"):
        list(bl)
    assert not loader_threads()


def test_stopping_early_stops_the_workers():
    cfg = yaml_cfg(prefetch_workers=2)
    bl = loader.BatchLoader(Failing(bad=-1), from_cfg(cfg), cfg,
                            shuffle=True)
    it = iter(bl)
    first = next(it)
    assert first["offsets"][-1] > 0 and loader_threads()
    it.close()
    assert not loader_threads()


@pytest.mark.parametrize("name,item", [("dcf", "3")])
def test_build_dataset_names_the_roadmap_item(name, item):
    with pytest.raises(ValueError, match=f"queue 1 item {item}"):
        loader.build_dataset(yaml_cfg(data_name=name), "train")


def test_audit_counters_equal_jax():
    """Caps small enough that every counter of every stage is non-zero
    (32-point tiles, so that stage 3's 128 slots span several)."""
    cfg = yaml_cfg(band=0, band_per_stage=None, s_band=4, sparse_cap=2,
                   tile=32, max_batch_points=4096)
    pcfg = from_cfg(cfg)
    mcfg = jax_train.build_model_config(cfg, 1)
    hb = loader.host_batch(pcfg, seed=3)
    want = np.asarray(jax_audit.audit_truncation_packed(
        mcfg, {k: hb[k] for k in ("xyz", "offsets", "pyramid")}))
    got = audit.audit_truncation_packed(pcfg, loader.to_device(hb, "cpu"))
    assert got.dtype == torch.int64 and got.shape == (4, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).all(), want
    stats = audit.unpack_truncation(pcfg, got.numpy())
    assert stats == jax_audit.unpack_truncation(mcfg, want)
    assert audit.format_truncation(stats) == jax_audit.format_truncation(
        stats)


def test_checkpoints_keep_the_newest_five(tmp_path):
    cfg = from_cfg(yaml_cfg())
    model = build_model(cfg, "cpu", seed=0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    d = str(tmp_path / "ckpt")
    for epoch in range(1, 8):
        path = checkpoint.save(d, model, opt, step=10 * epoch, epoch=epoch)
        assert path == os.path.join(d, f"{epoch}.pt")
    assert checkpoint.epochs(d) == [3, 4, 5, 6, 7]
    assert checkpoint.restore(d, model) == (70, 7, 0.0)
    assert checkpoint.restore(os.path.join(d, "4.pt"), model) == (40, 4, 0.0)
    (tmp_path / "empty").mkdir()
    assert checkpoint.restore(str(tmp_path / "empty"), model) == (0, 0, 0.0)
    with pytest.raises(FileNotFoundError, match="missing"):
        checkpoint.restore(str(tmp_path / "missing"), model)


# milestones given, so that a 1-epoch run has the 2-epoch run's schedule
LOOP = ["data_name", "synthetic", "synthetic_scenes", "4",
        "synthetic_points", "1500", "epochs", "2", "milestones", "[1]",
        "print_freq", "1", "use_tensorboard", "False", "drop_path_rate",
        "0.3"]


def loop_cfg(save, *extra):
    opts = []
    for key, value in NARROW.items():
        opts += [key, str(value).replace(" ", "")]
    return merge_cfg_from_list(load_cfg(CONFIG), opts + LOOP + [
        "save_path", str(save)] + list(extra))


def test_resumed_epoch_is_bit_identical(tmp_path):
    """Two straight epochs equal one epoch and a resumed one: parameters,
    optimizer moments and metrics.jsonl, drop-path 0.3 on."""
    _, straight = driver.run(loop_cfg(tmp_path / "a"), "cpu",
                          log=lambda _: None)
    driver.run(loop_cfg(tmp_path / "b", "epochs", "1"), "cpu",
               log=lambda _: None)
    _, resumed = driver.run(loop_cfg(tmp_path / "b", "resume",
                                  str(tmp_path / "b" / "ckpt")), "cpu",
                         log=lambda _: None)
    assert [r["epoch"] for r in resumed["records"]] == [2]
    assert straight["steps"] == 4 and resumed["steps"] == 2
    assert straight["step"] == resumed["step"] == 4
    lines = [open(tmp_path / d / "metrics.jsonl").read().splitlines()
             for d in ("a", "b")]
    assert lines[0] == lines[1] and len(lines[0]) == 2
    assert set(json.loads(lines[0][1])) == {
        "epoch", "loss", "miou", "macc", "all_acc", "val_loss", "val_miou"}
    a = torch.load(tmp_path / "a" / "ckpt" / "2.pt", weights_only=True)
    b = torch.load(tmp_path / "b" / "ckpt" / "2.pt", weights_only=True)
    for name, t in a["model"].items():
        assert torch.equal(t, b["model"][name]), name
    for i, s in a["optimizer"]["state"].items():
        for key, t in s.items():
            assert torch.equal(t, b["optimizer"]["state"][i][key]), (i, key)
    # the audit ran on the first logged iteration of each epoch
    assert [("audit" in r) for r in straight["iters"]] == [True, False] * 2


def test_loop_refuses_more_than_one_device(tmp_path):
    with pytest.raises(ValueError, match="queue 1 item 6"):
        driver.run(loop_cfg(tmp_path, "n_devices", "2"), "cpu")


def test_loop_takes_all_visible_devices_as_one(monkeypatch):
    """``n_devices`` 0 (the YAML's "all visible") trains on one device
    however many cards are visible; only an explicit count above 1
    raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    shipped = load_cfg(CONFIG)
    assert shipped["n_devices"] == 0
    assert driver.single_device(shipped) == 1
    assert driver.single_device(dict(shipped, n_devices=1)) == 1
    with pytest.raises(ValueError, match="queue 1 item 6"):
        driver.single_device(dict(shipped, n_devices=4))


def test_resume_from_a_missing_path_raises(tmp_path):
    """A mistyped ``resume`` fails before training rather than starting
    from scratch."""
    with pytest.raises(FileNotFoundError, match="nowhere"):
        driver.run(loop_cfg(tmp_path, "resume", str(tmp_path / "nowhere")),
                   "cpu", log=lambda _: None)
    assert not os.path.exists(tmp_path / "metrics.jsonl")
