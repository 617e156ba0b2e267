"""Layout-removal inference driver (the JAX package's ``test_layoutrm.py``;
reference fork ``test_layoutrm.py``: ``test.py`` without the instance
tail).

    python -m stratified_transformer_torch.eval.layoutrm_driver \
        --config configs/dcf_stratified.yaml [--device cpu] \
        [model_path <checkpoint.pt>] [key value ...]

The model and the prediction are `iou_driver`'s. Scenes: the ``.obj`` meshes
of ``custom_data_root``, or one smoke scene of 20000 random points in a 3 m
cube (seed 0). Each is cleaned and axis-aligned
(`scene_prep.prepare_custom_scene`, whose points this driver takes from the
tuple it returns: ``test_layoutrm.py`` assigns the whole tuple), given
features of 127.5, and predicted; ``<result_path>/<name>_sem.ply`` holds
the points coloured by label, ``<name>_shift.ply`` the points moved by
their offsets (``result_path`` default ``runs/layoutrm``).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from stratified_transformer_torch.data.ply import (
    load_obj_vertices, save_colored_by_label, write_ply_points)
from stratified_transformer_torch.eval import scene_prep
from stratified_transformer_torch.eval.iou_driver import (
    load_model, make_predict, predict_scene)
from stratified_transformer_torch.utils.config import (
    load_cfg, merge_cfg_from_list)


def custom_scenes(yaml_cfg):
    """``(name, float32 points)`` of each scene (``test_layoutrm.py:
    87-104``)."""
    root = yaml_cfg.get("custom_data_root")
    names = sorted(f for f in os.listdir(root)
                   if f.endswith(".obj")) if root else []
    if not names:
        rng = np.random.default_rng(0)
        yield "synthetic_0", rng.uniform(0, 3, (20000, 3)).astype(np.float32)
    for f in names:
        yield f[:-4], load_obj_vertices(os.path.join(root, f))


def run(yaml_cfg, device="cuda", log=print):
    """Predict every scene and write its two ``.ply`` files; returns one
    record per scene (name, points, non-face points, paths, seconds)."""
    model = load_model(yaml_cfg, device, log)
    predict = make_predict(model)
    cfg = model.cfg
    out_dir = yaml_cfg.get("result_path", "runs/layoutrm")
    os.makedirs(out_dir, exist_ok=True)
    records = []
    for name, coord in custom_scenes(yaml_cfg):
        t0 = time.time()
        coord, _, _ = scene_prep.prepare_custom_scene(coord)
        feat = np.ones((coord.shape[0], 3), np.float32) * 127.5
        pred_labels, pred_shift = predict_scene(
            predict, coord, feat, cfg.n_pad, yaml_cfg.get("voxel_max", 80000),
            cfg.concat_xyz, cfg.num_scenes)
        sem = os.path.join(out_dir, f"{name}_sem.ply")
        shift = os.path.join(out_dir, f"{name}_shift.ply")
        save_colored_by_label(sem, coord, pred_labels)
        write_ply_points(shift, coord + pred_shift)
        kept = int((pred_labels >= 6).sum())
        secs = time.time() - t0
        log(f"{name}: {coord.shape[0]} pts, {kept} non-face pts, wrote "
            f"{sem} ({secs:.1f}s)")
        records.append({"name": name, "points": int(coord.shape[0]),
                        "non_face": kept, "sem": sem, "shift": shift,
                        "seconds": secs})
    log("layout-removal inference done")
    return records


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
