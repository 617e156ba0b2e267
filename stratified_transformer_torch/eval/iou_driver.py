"""DCF box-mAP evaluation driver (the JAX package's ``test_iou.py``).

    python -m stratified_transformer_torch.eval.iou_driver \
        --config configs/dcf_stratified.yaml [--device cpu] \
        [model_path <checkpoint.pt>] [key value ...]

Builds the model with the offset head at the flat capacity
``batch_size_test * voxel_max`` (default 4 x 80000) rounded up to the tile,
in ``batch_size_test`` slots, restores a checkpoint of the port (random
weights without one), and per scene: covers it with sphere crops
(`predict_scene`; each batch of crops one eval-mode forward without a host
pyramid, on the card unless ``--device cpu``), takes each point's mean
logits and offset, decomposes the offset-shifted points into cuboid
instances (`instantiation.instantiate`, then `merge_instances` unless
``merge_instances`` is false), and scores their boxes against the scene's
(`box_map.DetectionMAP` at ``overlap_threshold``). Scenes: ``data_name:
dcf`` reads the cube files of each ``data_root``'s ``test`` directory; any
other name scores ``test_iou.py``'s two random smoke scenes. Logs each
scene's objects before and after the merge and its TP/FP/FN, then the
detection summary.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from stratified_transformer_torch.config import from_cfg
from stratified_transformer_torch.data.datasets import DCF
from stratified_transformer_torch.device import resolve_device
from stratified_transformer_torch.eval import box_map, instantiation
from stratified_transformer_torch.eval.voting import sphere_cover_crops
from stratified_transformer_torch.models.stratified import build_model
from stratified_transformer_torch.train import checkpoint
from stratified_transformer_torch.utils.config import (
    load_cfg, merge_cfg_from_list)


def offset_config(yaml_cfg):
    """The model configuration of ``test_iou.py`` / ``test_layoutrm.py``:
    the offset head on, ``batch_size_test`` (default 4) slots in a flat
    capacity of ``batch_size_test * voxel_max`` (default 80000) rounded up
    to the tile."""
    bst = int(yaml_cfg.get("batch_size_test", 4))
    voxel_max = yaml_cfg.get("voxel_max", 80000)
    cfg = from_cfg(yaml_cfg)
    n_pad = (bst * voxel_max + cfg.tile - 1) // cfg.tile * cfg.tile
    return dataclasses.replace(cfg, n_pad=n_pad, num_scenes=bst,
                               with_regressor=True)


def load_model(yaml_cfg, device, log=print):
    """`offset_config`'s model on ``device`` in eval mode, with the weights
    of ``model_path`` when given."""
    dev = resolve_device(device)
    cfg = offset_config(yaml_cfg)
    model = build_model(cfg, dev, seed=0)
    model_path = yaml_cfg.get("model_path")
    if model_path:
        _, epoch, _ = checkpoint.restore(model_path, model)
        log(f"loaded checkpoint from {model_path} (epoch {epoch})")
    else:
        log("WARNING: no model_path given — evaluating random weights")
    return model


def make_predict(model):
    """``predict(feats, xyz, offsets) -> (logits, shift)`` over numpy
    arrays: one eval-mode forward on the model's device with no host
    pyramid."""
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def predict(feats, xyz, offsets):
        logits, shift = model(torch.from_numpy(feats).to(dev),
                              torch.from_numpy(xyz).to(dev),
                              torch.from_numpy(offsets).to(dev, torch.int64))
        return logits.cpu().numpy(), shift.cpu().numpy()

    return predict


def predict_scene(predict_fn, coord, feat, n_pad, voxel_max, concat_xyz,
                  num_scenes):
    """Each point's label and offset over a whole scene (``test_iou.py:
    25-67``): `sphere_cover_crops` of the scene, ``num_scenes`` crops per
    forward, each crop shifted to its minimum corner; logits and offsets
    summed per point in float64 and divided by the point's crop count.
    Returns ``(labels [n], shift [n, 3])``."""
    n = len(coord)
    logits_acc = None
    shift_acc = np.zeros((n, 3), np.float64)
    count = np.zeros(n, np.float64)
    crops = sphere_cover_crops(coord, voxel_max)
    cdim = feat.shape[1] + (3 if concat_xyz else 0)
    for s in range(0, len(crops), num_scenes):
        batch = crops[s:s + num_scenes]
        xyz_b = np.zeros((n_pad, 3), np.float32)
        feat_b = np.zeros((n_pad, cdim), np.float32)
        offsets = np.zeros((num_scenes,), np.int32)
        pos = 0
        for j, idx in enumerate(batch):
            cc = coord[idx] - coord[idx].min(0)
            ff = feat[idx]
            m = len(idx)
            xyz_b[pos:pos + m] = cc
            feat_b[pos:pos + m] = (
                np.concatenate([ff, cc], 1) if concat_xyz else ff)
            pos += m
            offsets[j] = pos
        offsets[len(batch):] = pos
        logits, shift = predict_fn(feat_b, xyz_b, offsets)
        if logits_acc is None:
            logits_acc = np.zeros((n, logits.shape[-1]), np.float64)
        pos = 0
        for idx in batch:
            m = len(idx)
            logits_acc[idx] += logits[pos:pos + m]
            shift_acc[idx] += shift[pos:pos + m]
            count[idx] += 1
            pos += m
    count = np.maximum(count, 1)
    return (np.argmax(logits_acc / count[:, None], -1),
            shift_acc / count[:, None])


def iou_scenes(yaml_cfg):
    """``(name, coord, feat, gt_boxes)`` of each scene to score
    (``test_iou.py:116-150``): the DCF test cubes of ``data_root`` (a str
    or a list), their boxes as corners ``[x1, y1, z1, x2, y2, z2]``; under
    any other ``data_name``, two smoke scenes of 20000 random points in a
    4 m cube with three random boxes, drawn from one generator seeded 0."""
    if yaml_cfg.get("data_name", "synthetic") == "dcf":
        roots = yaml_cfg.get("data_root")
        if not roots:
            raise ValueError("data_name dcf needs data_root, the directories "
                             "(a str or a list) holding test/ cube files")
        ds = DCF(split="test",
                 data_root=[roots] if isinstance(roots, str) else roots,
                 voxel_size=yaml_cfg.get("voxel_size", 0.04))
        for path in ds.files:
            coord, _, _, feat, params = ds.load_item(path)
            c, size = params[:, :3], params[:, 3:]
            yield path, coord, feat, np.concatenate([c - size / 2,
                                                     c + size / 2], 1)
        return
    rng = np.random.default_rng(0)
    for i in range(2):
        n = 20000
        coord = rng.uniform(0, 4, (n, 3))
        rng.integers(0, 18, n)                      # labels, unused
        rng.normal(0, 0.05, (n, 3))                 # offsets, unused
        boxes = np.sort(rng.uniform(0, 4, (3, 2, 3)), axis=1).reshape(3, 6)
        yield f"synthetic_{i}", coord, np.ones((n, 3)), boxes


def score_scene(predict_fn, coord, feat, gt_boxes, det, cfg, voxel_max,
                merge=True):
    """One scene's protocol: `predict_scene`, `instantiation.instantiate`,
    `merge_instances` (with ``merge``), boxes, ``det.evaluate``. Returns
    the scene's ``boxes``, ``tp/fp/fn``, objects before (``raw_objects``)
    and after the merge (``objects``) and ``seconds``."""
    t0 = time.time()
    pred_labels, pred_shift = predict_scene(
        predict_fn, np.asarray(coord, np.float32),
        np.asarray(feat, np.float32), cfg.n_pad, voxel_max, cfg.concat_xyz,
        cfg.num_scenes)
    objs = instantiation.instantiate(np.asarray(coord), pred_shift,
                                     pred_labels)
    n_raw = len(objs)
    if merge:
        objs = instantiation.merge_instances(objs)
    boxes = np.asarray([instantiation.support_to_box(o)
                        for o in objs]).reshape(-1, 6)
    tp, fp, fn = det.evaluate(boxes, gt_boxes)
    return {"boxes": boxes, "tp": tp, "fp": fp, "fn": fn,
            "raw_objects": n_raw, "objects": len(objs),
            "seconds": time.time() - t0}


def run(yaml_cfg, device="cuda", log=print):
    """Score every scene; returns ``DetectionMAP.summary()`` with the
    per-scene records (``scenes``: name, objects, TP/FP/FN, seconds)."""
    model = load_model(yaml_cfg, device, log)
    predict = make_predict(model)
    det = box_map.DetectionMAP(yaml_cfg.get("overlap_threshold", 0.5))
    voxel_max = yaml_cfg.get("voxel_max", 80000)
    merge = bool(yaml_cfg.get("merge_instances", True))
    records = []
    for name, coord, feat, gt_boxes in iou_scenes(yaml_cfg):
        r = score_scene(predict, coord, feat, gt_boxes, det, model.cfg,
                        voxel_max, merge)
        log(f"scene {name}: {r['raw_objects']} -> {r['objects']} objects "
            f"after merge, TP/FP/FN {r['tp']}/{r['fp']}/{r['fn']} "
            f"({r['seconds']:.1f}s)")
        records.append({"name": name, **{k: v for k, v in r.items()
                                         if k != "boxes"}})
    summary = det.summary()
    log(f"Detection: {summary}")
    summary["scenes"] = records
    return summary


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
