"""Training driver of the port on synthetic rooms (the JAX package's
``train.py::main``, ``:355-660``, synthetic data only).

    python -m stratified_transformer_torch.train.driver \
        --config configs/s3dis_stratified.yaml --steps 3 [--device cuda] \
        [--out runs/torch_train/model_last.pt] [key value ...]

Reads the YAML (``key value`` pairs override it, as for ``train.py``),
builds the model in training mode, AdamW with the ×0.1 ``blocks`` LR and
the YAML's schedule, and takes ``--steps`` train steps on augmented
synthetic batches of ``max_batch_points`` points in ``batch_size`` scenes,
logging loss and mIoU per step; then saves a checkpoint. The datasets on
disk and the truncation audit are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from stratified_transformer_torch.config import from_cfg
from stratified_transformer_torch.data.loader import host_batch, to_device
from stratified_transformer_torch.device import resolve_device
from stratified_transformer_torch.models.stratified import build_model
from stratified_transformer_torch.train import checkpoint, schedulers
from stratified_transformer_torch.train.state import make_optimizer
from stratified_transformer_torch.train.step import make_train_step
from stratified_transformer_torch.utils.config import (
    load_cfg, merge_cfg_from_list)


def mean_iou(stats):
    inter = stats["intersection"].double()
    union = stats["union"].double()
    seen = union > 0
    return float((inter[seen] / union[seen]).mean()) if bool(seen.any()) \
        else 0.0


def run(yaml_cfg, steps, device="cuda", out=None, log=print):
    """Take ``steps`` train steps; returns the per-step stats as floats."""
    dev = resolve_device(device)
    cfg = from_cfg(yaml_cfg)
    seed = int(yaml_cfg.get("manual_seed", 123))
    ignore = int(yaml_cfg.get("ignore_label", 255))
    model = build_model(cfg, dev, seed=seed, train=True)
    iter_per_epoch = max(
        int(yaml_cfg.get("synthetic_scenes", 32)) // cfg.num_scenes, 1)
    schedule, _ = schedulers.from_config(yaml_cfg, iter_per_epoch)
    optimizer = make_optimizer(
        model, schedule,
        weight_decay=float(yaml_cfg.get("weight_decay", 0.01)),
        transformer_lr_scale=float(yaml_cfg.get("transformer_lr_scale", 0.1)),
        optimizer=str(yaml_cfg.get("optimizer", "AdamW")),
        momentum=float(yaml_cfg.get("momentum", 0.9)))
    train_step = make_train_step(ignore, cfg.num_classes)
    aug = bool(yaml_cfg.get("aug", False))
    history = []
    for step in range(steps):
        t0 = time.perf_counter()
        hb = host_batch(cfg, seed=step, ignore_label=ignore, train=aug,
                        rng=np.random.default_rng((seed, step)),
                        aug=yaml_cfg)
        batch = to_device(hb, dev)
        gen = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + step)
        stats = train_step(model, optimizer, batch, gen)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec = {"step": step, "loss": float(stats["loss"]),
               "miou": mean_iou(stats), "points": int(stats["points"]),
               "lr": optimizer.param_groups[1]["lr"],
               "seconds": time.perf_counter() - t0}
        history.append(rec)
        log(json.dumps(rec))
    if out:
        checkpoint.save(out, model, optimizer, steps,
                        steps // iter_per_epoch)
        log(f"saved {out}")
    return history


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="checkpoint path (default: <save_path>/"
                         "model_last.pt)")
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="YAML overrides as key value pairs")
    args = ap.parse_args(argv)
    yaml_cfg = merge_cfg_from_list(load_cfg(args.config), args.opts)
    out = args.out or os.path.join(
        str(yaml_cfg.get("save_path") or "runs/torch_train"),
        "model_last.pt")
    run(yaml_cfg, args.steps, args.device, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
