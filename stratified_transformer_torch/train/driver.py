"""Training driver of the port: the JAX package's ``train.py::main`` epoch
loop (``train.py:355-675``) on one device.

    python -m stratified_transformer_torch.train.driver \
        --config configs/s3dis_stratified.yaml [--device cpu] [key value ...]

Reads the YAML (``key value`` pairs override it, as for ``train.py``),
builds the model from ``config.from_cfg`` in training mode, the train and
(with ``evaluate``) validation loaders over ``data_name`` s3dis,
scannetv2 or synthetic rooms, AdamW with the x0.1 ``blocks`` LR, the
YAML's schedule and ``max_grad_norm``, and trains ``epochs`` epochs from
``start_epoch`` or from the checkpoint ``resume`` (a ``.pt`` file or a
``ckpt`` directory, whose latest epoch is read). Each iteration
dispatches the step, takes the next host batch from the loader while the device runs, reads the step's
statistics in one transfer and uploads the next batch. Logs ``train.py``'s
lines (per-iteration loss, points per second and, every ``print_freq x
audit_freq`` iterations, the truncation audit; per epoch the train mIoU,
load-wait, upload and step-block seconds, and the validation metrics every
``eval_freq`` epochs) to stdout and ``<save_path>/log.txt``, appends one
record per epoch to ``<save_path>/metrics.jsonl`` (and TensorBoard scalars
when ``torch.utils.tensorboard`` imports and ``use_tensorboard`` is set),
and writes ``<save_path>/ckpt/<epoch>.pt`` every ``save_freq`` epochs.
Runs on the card unless ``--device cpu`` is given.

Drop-path masks come from a ``torch.Generator`` seeded by ``manual_seed``
and the global step, so a resumed run draws what an uninterrupted one
draws. Accepted and ignored, as TPU-runtime workarounds of the JAX driver:
``preflight*``, ``crash_fallback``, ``compress_payload``,
``upload_overlap`` (`to_device` copies on the compute stream, so an upload
before the statistics read would wait for the step all the same) and the
``ST_FAULT_INJECT_AT`` variable. ``n_devices`` 0 (all visible) means the
one device the port trains on.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from stratified_transformer_torch.config import from_cfg
from stratified_transformer_torch.data.loader import (
    BatchLoader, build_dataset, to_device)
from stratified_transformer_torch.device import resolve_device
from stratified_transformer_torch.models.stratified import build_model
from stratified_transformer_torch.train import audit, checkpoint, schedulers
from stratified_transformer_torch.train.metrics import (
    AverageMeter, iou_from_counts)
from stratified_transformer_torch.train.state import make_optimizer
from stratified_transformer_torch.train.step import (
    make_eval_step, make_train_step, pack_stats)
from stratified_transformer_torch.utils.config import (
    load_cfg, merge_cfg_from_list)
from stratified_transformer_torch.utils.logger import get_logger


def build_optimizer(model, yaml_cfg, iter_per_epoch):
    """The optimizer of ``train.py::main``: the YAML's schedule over
    ``iter_per_epoch`` iterations per epoch, weight decay, LR scale on
    ``blocks``, ``optimizer`` and ``max_grad_norm``."""
    schedule, _ = schedulers.from_config(yaml_cfg, iter_per_epoch)
    return make_optimizer(
        model, schedule,
        weight_decay=float(yaml_cfg.get("weight_decay", 0.01)),
        transformer_lr_scale=float(yaml_cfg.get("transformer_lr_scale", 0.1)),
        optimizer=str(yaml_cfg.get("optimizer", "AdamW")),
        momentum=float(yaml_cfg.get("momentum", 0.9)),
        max_grad_norm=yaml_cfg.get("max_grad_norm"))


def drop_path_generator(device, seed, step):
    """The drop-path generator of global step ``step``."""
    return torch.Generator(device=device).manual_seed(
        int(seed) * 1_000_003 + int(step))


def scenes_in(offsets):
    """Non-empty scenes of a host batch's cumulative ``offsets``."""
    return int(np.count_nonzero(np.diff(np.concatenate(
        [[0], np.asarray(offsets, np.int64)]))))


def single_device(yaml_cfg):
    """The device count the YAML asks for, resolved for the port's
    single-device loop: ``n_devices`` 0 (all visible) and 1 are one device,
    more raises."""
    n_devices = int(yaml_cfg.get("n_devices", 0))
    if n_devices > 1:
        raise ValueError(f"n_devices {n_devices}: data-parallel training is "
                         "ROADMAP queue 1 item 6; the port trains on one "
                         "device (n_devices 0 or 1)")
    return 1


def validate(model, val_loader, eval_step, dev):
    """One pass of the eval step over ``val_loader`` (model in eval mode,
    then back in training mode); returns (loss meter, `iou_from_counts`,
    forwards)."""
    ncls = model.cfg.num_classes
    counts = np.zeros((3, ncls))
    vloss = AverageMeter()
    forwards = 0
    model.eval()
    try:
        for hb in val_loader:
            _, _, stats = eval_step(model, to_device(hb, dev))
            packed = torch.cat([stats["loss"].reshape(1)] + [
                stats[k].to(torch.float32)
                for k in ("intersection", "union", "target")]).cpu().numpy()
            vloss.update(float(packed[0]))
            counts += packed[1:].reshape(3, ncls)
            forwards += 1
    finally:
        model.train()
    return vloss, iou_from_counts(*counts), forwards


def run(yaml_cfg, device="cuda", log=None):
    """Train as ``train.py::main`` does on one device; returns the model
    and a summary: the per-epoch ``records`` (as written to
    ``metrics.jsonl``), the per-epoch ``timing`` (wall, load-wait, upload,
    step-block and validation seconds, points, forwards), the
    per-iteration ``iters`` (loss, valid points, scenes, wall seconds, the
    audit's counters where it ran), the ``steps`` and ``val_forwards``
    taken and the final ``step``."""
    dev = resolve_device(device)
    save_path = str(yaml_cfg.get("save_path") or "runs/default")
    log = log or get_logger(save_path).info
    n_devices = single_device(yaml_cfg)
    cfg = from_cfg(yaml_cfg)
    log(f"devices: {n_devices} ({dev}); model config: {cfg}")
    seed = int(yaml_cfg.get("manual_seed", 123))
    model = build_model(cfg, dev, seed=seed, train=True)
    train_ds = build_dataset(yaml_cfg, "train")
    loader = BatchLoader(train_ds, cfg, yaml_cfg, shuffle=True, seed=seed)
    val_loader = None
    if yaml_cfg.get("evaluate", False):
        try:
            val_loader = BatchLoader(build_dataset(yaml_cfg, "val"), cfg,
                                     yaml_cfg, shuffle=False, seed=0)
        except (KeyError, ValueError, FileNotFoundError) as e:
            log(f"no val dataset ({e}); skipping evaluation")
    iter_per_epoch = loader.batches_per_epoch
    log(f"dataset: {len(train_ds)} samples, {iter_per_epoch} iters/epoch")
    # The JAX driver initialises its model from this batch; building it
    # takes the same draws from the datasets' per-item visit counters and
    # the Mix3D generator, so the batches that follow stay equal to its.
    loader.make_batch(list(range(loader.scenes_per_batch)))
    optimizer = build_optimizer(model, yaml_cfg, iter_per_epoch)
    log(f"#Model parameters: {sum(p.numel() for p in model.parameters())}")

    start_epoch = int(yaml_cfg.get("start_epoch", 0))
    if yaml_cfg.get("resume"):
        _, start_epoch, _ = checkpoint.restore(yaml_cfg["resume"], model,
                                               optimizer)
        log(f"resumed from {yaml_cfg['resume']} at epoch {start_epoch}")

    ignore = int(yaml_cfg.get("ignore_label", 255))
    ncls = cfg.num_classes
    train_step = make_train_step(ignore, ncls)
    eval_step = make_eval_step(ignore, ncls)
    epochs = int(yaml_cfg.get("epochs", 100))
    log_every = int(yaml_cfg.get("print_freq", 1))
    audit_on = (bool(yaml_cfg.get("truncation_audit", True))
                and bool(yaml_cfg.get("host_pyramid", True))
                and cfg.sampler == "grid")
    audit_freq = int(yaml_cfg.get("audit_freq", 4))
    os.makedirs(save_path, exist_ok=True)
    metrics_path = os.path.join(save_path, "metrics.jsonl")
    writer = None
    if yaml_cfg.get("use_tensorboard", True):
        try:
            from torch.utils.tensorboard import SummaryWriter
            writer = SummaryWriter(os.path.join(save_path, "tb"))
        except Exception:
            log("tensorboard unavailable; metrics.jsonl only")

    summary = {"records": [], "timing": [], "iters": [], "steps": 0,
               "val_forwards": 0}
    try:
        for epoch in range(start_epoch, epochs):
            t_epoch = time.time()
            counts = np.zeros((3, ncls))
            loss_meter = AverageMeter()
            points_total = 0
            # dispatch the step on the current device batch; while the device
            # runs, take the next host batch from the loader; read the step's
            # statistics (one transfer); then upload the next batch
            t_load = t_put = t_blk = 0.0
            itr = iter(loader)
            t0 = time.time()
            cur_host = next(itr, None)
            t_load += time.time() - t0
            cur_dev = (to_device(cur_host, dev) if cur_host is not None
                       else None)
            it = -1
            while cur_host is not None:
                it += 1
                host, batch = cur_host, cur_dev
                t_iter0 = time.time()
                gen = drop_path_generator(dev, seed,
                                          optimizer.param_groups[0]["t"])
                packed = pack_stats(train_step(model, optimizer, batch, gen))
                log_now = (it + 1) % log_every == 0
                audit_stats = None
                if (audit_on and log_now
                        and (it // log_every) % audit_freq == 0):
                    audit_stats = audit.audit_truncation_packed(cfg, batch)
                t0 = time.time()
                cur_host = next(itr, None)
                t_load += time.time() - t0
                t0 = time.time()
                sarr = packed.cpu().numpy()
                t_blk += time.time() - t0
                cur_dev = None
                if cur_host is not None:
                    t0 = time.time()
                    cur_dev = to_device(cur_host, dev)
                    t_put += time.time() - t0
                loss = float(sarr[0])
                loss_meter.update(loss)
                it_points = int(sarr[3])
                counts += sarr[4:].reshape(3, ncls)
                points_total += it_points
                rec = {"epoch": epoch + 1, "iter": it + 1, "loss": loss,
                       "points": it_points,
                       "scenes": scenes_in(host["offsets"])}
                if log_now:
                    trunc = ""
                    if audit_stats is not None:
                        rec["audit"] = audit.unpack_truncation(
                            cfg, audit_stats.cpu().numpy())
                        trunc = " " + audit.format_truncation(rec["audit"])
                    dt_wall = time.time() - t_iter0
                    pps = it_points / max(dt_wall, 1e-9)
                    log(f"Epoch [{epoch + 1}/{epochs}][{it + 1}/"
                        f"{iter_per_epoch}] loss {loss:.4f} "
                        f"({loss_meter.avg:.4f}) {pps:,.0f} pts/s "
                        f"wall {dt_wall * 1e3:.0f}ms{trunc}")
                rec["wall_s"] = time.time() - t_iter0
                summary["iters"].append(rec)
                summary["steps"] += 1
            m = iou_from_counts(*counts)
            t_wall_ep = time.time() - t_epoch
            pps_wall = points_total / max(t_wall_ep, 1e-9)
            log(f"Train epoch [{epoch + 1}/{epochs}]: mIoU {m['miou']:.4f} "
                f"mAcc {m['macc']:.4f} allAcc {m['all_acc']:.4f} "
                f"({t_wall_ep:.1f}s, {pps_wall:,.0f} pts/s wall; "
                f"load-wait {t_load:.1f}s upload {t_put:.1f}s "
                f"step-block {t_blk:.1f}s)")
            record = {"epoch": epoch + 1, "loss": loss_meter.avg,
                      **{k: m[k] for k in ("miou", "macc", "all_acc")}}
            timing = {"epoch": epoch + 1, "wall_s": t_wall_ep,
                      "load_wait_s": t_load, "upload_s": t_put,
                      "step_block_s": t_blk, "points": points_total}

            if val_loader is not None and (
                    (epoch + 1) % int(yaml_cfg.get("eval_freq", 1)) == 0):
                t0 = time.time()
                vloss, vm, forwards = validate(model, val_loader,
                                               eval_step, dev)
                timing.update(val_s=time.time() - t0, val_forwards=forwards)
                summary["val_forwards"] += forwards
                log(f"Val epoch [{epoch + 1}]: loss {vloss.avg:.4f} "
                    f"mIoU {vm['miou']:.4f} mAcc {vm['macc']:.4f} "
                    f"allAcc {vm['all_acc']:.4f}")
                record.update({"val_loss": vloss.avg, "val_miou": vm["miou"]})

            with open(metrics_path, "a") as f:
                f.write(json.dumps(record) + "\n")
            if writer is not None:
                for key, value in record.items():
                    if key != "epoch":
                        writer.add_scalar(key, value, epoch + 1)
            if (epoch + 1) % int(yaml_cfg.get("save_freq", 1)) == 0:
                checkpoint.save(os.path.join(save_path, "ckpt"), model,
                                optimizer, optimizer.param_groups[0]["t"],
                                epoch + 1)
            summary["records"].append(record)
            summary["timing"].append(timing)
    finally:
        if writer is not None:
            writer.close()
    log("==>Training done!")
    summary["step"] = optimizer.param_groups[0]["t"]
    return model, summary


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
