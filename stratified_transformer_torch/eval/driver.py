"""Whole-scene evaluation driver (the JAX package's ``test.py``, its
non-sharded path; reference ``test_backup.py`` protocol).

    python -m stratified_transformer_torch.eval.driver \
        --config configs/s3dis_stratified.yaml [--device cpu] \
        [model_path <checkpoint.pt>] [key value ...]

Reads the YAML (``key value`` pairs override it, as for ``test.py``), builds
the model at the flat capacity ``eval_max_batch_points`` (default
``batch_size_test * voxel_max``) in ``batch_size_test`` scenes, restores a
checkpoint of the port (``train/checkpoint.py``; random weights without
one), and runs every scene through `voting.evaluate_scene`: the TTA
ensemble x vote chunks x sphere crops, each batch of crops one eval-mode
forward without a host pyramid, so sampling and neighbour search run on the
device. Logs each scene's accuracy, the per-class IoU table and
``mIoU/mAcc/allAcc``. Scenes: ``data_name: synthetic`` (seed 999),
``s3dis`` (the ``.npy`` rooms of ``test_area`` under ``data_root``) or
``scannetv2`` (the ``.pth`` scenes of ``data_root``'s ``val`` directory,
colours in [-1, 1]: five TTA passes, features not divided by 255). Runs on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from stratified_transformer_torch.config import from_cfg
from stratified_transformer_torch.data.datasets import (
    SyntheticRooms, s3dis_scenes, scannet_scenes)
from stratified_transformer_torch.device import resolve_device
from stratified_transformer_torch.eval import voting
from stratified_transformer_torch.models.stratified import build_model
from stratified_transformer_torch.train import checkpoint
from stratified_transformer_torch.train.metrics import iou_from_counts
from stratified_transformer_torch.utils.config import (
    load_cfg, merge_cfg_from_list)


def eval_config(yaml_cfg):
    """The model configuration of whole-scene evaluation (``test.py:
    54-59``): ``batch_size_test`` scenes in a flat capacity of
    ``eval_max_batch_points`` (default ``batch_size_test * voxel_max``)
    rounded up to the tile."""
    bst = int(yaml_cfg.get("batch_size_test", 5))
    voxel_max = yaml_cfg.get("voxel_max", 80000)
    cfg = from_cfg(yaml_cfg)
    points = int(yaml_cfg.get("eval_max_batch_points",
                              bst * (voxel_max or 80000)))
    n_pad = (points + cfg.tile - 1) // cfg.tile * cfg.tile
    return dataclasses.replace(cfg, n_pad=n_pad, num_scenes=bst)


def make_predict_probs(model):
    """``predict_probs(feats, xyz, offsets) -> probs`` over numpy arrays:
    the softmax of one eval-mode forward on the model's device, with no
    host pyramid."""
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def predict_probs(feats, xyz, offsets):
        logits, _ = model(torch.from_numpy(feats).to(dev),
                          torch.from_numpy(xyz).to(dev),
                          torch.from_numpy(offsets).to(dev, torch.int64))
        return torch.softmax(logits, -1).cpu().numpy()

    return predict_probs


def scenes_of(yaml_cfg, num_classes):
    """``(name, xyz, colours, labels)`` of every scene to evaluate
    (``test.py:159-185``): rgb 0-255 for s3dis and synthetic scenes, [-1,
    1] for scannetv2."""
    data_name = yaml_cfg.get("data_name", "synthetic")
    if data_name in ("s3dis", "scannetv2") and not yaml_cfg.get("data_root"):
        raise ValueError(f"data_name {data_name} needs data_root, the "
                         "directory " + ("of the .npy rooms"
                                         if data_name == "s3dis" else
                                         "holding val/ .pth scenes"))
    if data_name == "s3dis":
        return s3dis_scenes(yaml_cfg["data_root"],
                            yaml_cfg.get("test_area", 5))
    if data_name == "scannetv2":
        return scannet_scenes(yaml_cfg["data_root"])
    if data_name != "synthetic":
        raise ValueError(f"data_name {data_name!r}: the port reads 's3dis', "
                         "'scannetv2' and 'synthetic' scenes (DCF is ROADMAP "
                         "queue 1 item 3)")
    ds = SyntheticRooms(
        num_scenes=int(yaml_cfg.get("synthetic_eval_scenes", 2)),
        points=int(yaml_cfg.get("synthetic_points", 20000)),
        num_classes=num_classes, seed=999)
    return [(f"synthetic_{i}", c, f, l.astype(np.int64))
            for i, (c, f, l) in enumerate(map(ds.raw_scene, range(len(ds))))]


def run(yaml_cfg, device="cuda", log=print):
    """Evaluate every scene; returns `iou_from_counts`' metrics with the
    per-scene ``scenes`` records (name, acc, seconds)."""
    if yaml_cfg.get("sharded", False):
        raise ValueError("sharded whole-scene inference (spatial blocks with "
                         "halo exchange) is ROADMAP queue 1 item 6; the port "
                         "runs the sphere-crop protocol (sharded: False)")
    dev = resolve_device(device)
    cfg = eval_config(yaml_cfg)
    ncls = cfg.num_classes
    model = build_model(cfg, dev, seed=0)
    model_path = yaml_cfg.get("model_path")
    if model_path:
        _, epoch, _ = checkpoint.restore(model_path, model)
        log(f"loaded checkpoint from {model_path} (epoch {epoch})")
    else:
        log("WARNING: no model_path given — evaluating random weights")
    predict_probs = make_predict_probs(model)
    voxel_max = yaml_cfg.get("voxel_max", 80000)
    ignore = int(yaml_cfg.get("ignore_label", 255))
    # colours of s3dis and synthetic scenes are rgb 0-255: the protocol
    # divides them by 255 and adds the two shifted passes (test.py:187)
    data_name = yaml_cfg.get("data_name", "synthetic")
    vote_name = "s3dis" if data_name in ("s3dis", "synthetic") else data_name
    inter_sum, union_sum, target_sum = (np.zeros(ncls) for _ in range(3))
    records = []
    scenes = scenes_of(yaml_cfg, ncls)
    for si, (name, coord, feat, label) in enumerate(scenes):
        t0 = time.time()
        pred, _ = voting.evaluate_scene(
            predict_probs, coord, feat, ncls, data_name=vote_name,
            voxel_size=yaml_cfg.get("voxel_size", 0.04), voxel_max=voxel_max,
            batch_size_test=cfg.num_scenes, n_pad=cfg.n_pad,
            num_scenes=cfg.num_scenes, concat_xyz=cfg.concat_xyz)
        mask = label != ignore
        p, t = pred[mask], label[mask]
        inter = np.bincount(p[p == t], minlength=ncls)[:ncls]
        a_p = np.bincount(p, minlength=ncls)[:ncls]
        a_t = np.bincount(t, minlength=ncls)[:ncls]
        inter_sum += inter
        union_sum += a_p + a_t - inter
        target_sum += a_t
        acc = inter.sum() / max(a_t.sum(), 1)
        secs = time.time() - t0
        records.append({"name": name, "acc": float(acc), "seconds": secs})
        log(f"Scene [{si + 1}/{len(scenes)}] {name}: acc {acc:.4f} "
            f"({secs:.1f}s)")
    m = iou_from_counts(inter_sum, union_sum, target_sum)
    for c in range(ncls):
        log(f"Class_{c:02d} iou/acc {m['iou_class'][c]:.4f}/"
            f"{m['acc_class'][c]:.4f}")
    log(f"Val result: mIoU/mAcc/allAcc {m['miou']:.4f}/{m['macc']:.4f}/"
        f"{m['all_acc']:.4f}")
    m["scenes"] = records
    return m


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="YAML overrides as key value pairs")
    args = ap.parse_args(argv)
    run(merge_cfg_from_list(load_cfg(args.config), args.opts), args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
