"""Whole-scene evaluation driver (the JAX package's ``test.py``; reference
``test_backup.py`` protocol).

    python -m stratified_transformer_torch.eval.driver \
        --config configs/s3dis_stratified.yaml [--device cpu] \
        [model_path <checkpoint.pt>] [sharded true] [key value ...]

Reads the YAML (``key value`` pairs override it, as for ``test.py``), builds
the model at the flat capacity ``eval_max_batch_points`` (default
``batch_size_test * voxel_max``) in ``batch_size_test`` scenes, restores a
checkpoint of the port (``train/checkpoint.py``; random weights without
one), and runs every scene through `voting.evaluate_scene`: the TTA
ensemble x vote chunks x sphere crops, each batch of crops one eval-mode
forward without a host pyramid, so sampling and neighbour search run on the
device. Logs each scene's accuracy, the per-class IoU table and
``mIoU/mAcc/allAcc``. Scenes: ``data_name: s3dis`` (the ``.npy`` rooms of
``test_area`` under ``data_root``), ``scannetv2`` (the ``.pth`` scenes of
``data_root``'s ``val`` directory, colours in [-1, 1]: five TTA passes,
features not divided by 255) or, for any other name, synthetic rooms (seed
999), as ``test.py:177-187`` reads them: rgb 0-255 divided by 255 under
``synthetic``, five passes and no division under any other name (``dcf``).
Runs on the card unless ``--device cpu`` is given.

``sharded: true`` (``test.py:92-157,194-233``) evaluates each vote chunk
as spatial slabs with receptive halos, one per rank
(`voting.evaluate_scene_sharded`, `parallel.halo`), on ``sharded_devices``
ranks (0: every visible card; on the CPU that many gloo ranks, 0 one),
each rank a spawned process on its own card (NCCL) or on the CPU (gloo),
rank 0 logging and scoring; with the keys of `config.sharded_from_cfg`.
It ends with ``test.py``'s line of the sharded counters.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from stratified_transformer_torch.config import from_cfg, sharded_from_cfg
from stratified_transformer_torch.data.datasets import (
    SyntheticRooms, s3dis_scenes, scannet_scenes)
from stratified_transformer_torch.device import resolve_device
from stratified_transformer_torch.eval import voting
from stratified_transformer_torch.kernels import ATTENTION_SOURCES, build
from stratified_transformer_torch.models.stratified import build_model
from stratified_transformer_torch.parallel import halo, mesh
from stratified_transformer_torch.train import checkpoint
from stratified_transformer_torch.train.metrics import iou_from_counts
from stratified_transformer_torch.utils import trace
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
    calls = itertools.count()

    @torch.inference_mode()
    def predict_probs(feats, xyz, offsets):
        with trace.span("st.predict", next(calls)):
            with trace.span("st.upload"):
                inputs = (torch.from_numpy(feats).to(dev),
                          torch.from_numpy(xyz).to(dev),
                          torch.from_numpy(offsets).to(dev, torch.int64))
            with trace.span("st.forward"):
                logits, _ = model(*inputs)
            with trace.span("st.download"):
                return torch.softmax(logits, -1).cpu().numpy()

    return predict_probs


def scenes_of(yaml_cfg, num_classes):
    """``(name, xyz, colours, labels)`` of every scene to evaluate
    (``test.py:159-185``): rgb 0-255 for s3dis rooms, [-1, 1] for
    scannetv2 scenes; any other ``data_name`` (synthetic, dcf) reads
    synthetic rooms, rgb 0-255."""
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
    ds = SyntheticRooms(
        num_scenes=int(yaml_cfg.get("synthetic_eval_scenes", 2)),
        points=int(yaml_cfg.get("synthetic_points", 20000)),
        num_classes=num_classes, seed=999)
    return [(f"synthetic_{i}", c, f, l.astype(np.int64))
            for i, (c, f, l, _) in enumerate(map(ds.raw_scene,
                                                  range(len(ds))))]


def sharded_config(yaml_cfg):
    """``(block model configuration, ShardedConfig, halo width)`` of
    ``sharded: true`` (``test.py:108-157``): the YAML's model at
    ``sharded_block_points`` in one scene with the ``sharded_down_quota``
    sampler, and ``sharded_halo`` or else the model's receptive halo."""
    cfg = from_cfg(yaml_cfg)
    scfg = sharded_from_cfg(yaml_cfg, cfg.tile)
    cfg = dataclasses.replace(cfg, n_pad=scfg.block_pad, num_scenes=1,
                              down_quota=scfg.down_quota)
    return cfg, scfg, scfg.halo or halo.receptive_halo(cfg)


def run(yaml_cfg, device="cuda", log=print, *,
        timeout_s=mesh.DEFAULT_TIMEOUT_S, join_timeout_s=None):
    """Evaluate every scene; returns `iou_from_counts`' metrics with the
    per-scene ``scenes`` records (name, acc, seconds) and, under
    ``sharded``, the counters ``sharded_stats``.

    ``sharded`` on more than one rank (`parallel.mesh.resolve_world` of
    ``sharded_devices``) builds the forward kernels here once and runs
    `run_rank` in one spawned process per rank (a collective waits
    ``timeout_s`` seconds at most; the ranks are killed past
    ``join_timeout_s``, None: no limit); rank 0 prints its lines and its
    metrics are returned."""
    dev = resolve_device(device)
    world = 1
    if yaml_cfg.get("sharded", False):
        world = mesh.resolve_world(yaml_cfg.get("sharded_devices", 0), dev)
    if world == 1:
        return run_rank(0, 1, yaml_cfg, dev, log=log)
    if dev.type == "cuda":
        # the two forward kernels' sources, once, not once per rank
        build.build_all(list(ATTENTION_SOURCES[:2]))
    log(f"spawning {world} ranks on {dev.type}")
    # CPU ranks share this process's threads
    threads = max(torch.get_num_threads() // world, 1)
    with tempfile.TemporaryDirectory() as out:
        mesh.spawn(_spawned_rank, world, args=(
            world, dict(yaml_cfg), dev.type, mesh.free_port(), out,
            timeout_s, threads), timeout_s=join_timeout_s)
        return torch.load(os.path.join(out, "rank0.pt"), weights_only=False)


def _print(msg):
    print(msg, flush=True)


def _spawned_rank(rank, world, yaml_cfg, device_type, port, out, timeout_s,
                  threads):
    """A spawned rank of `run`: `run_rank` on `mesh.rank_device` with
    ``threads`` CPU threads; rank 0 prints and writes its metrics to
    ``<out>/rank0.pt``."""
    torch.set_num_threads(threads)
    m = run_rank(rank, world, yaml_cfg, mesh.rank_device(device_type, rank),
                 port=port, log=_print, timeout_s=timeout_s)
    if rank == 0:
        torch.save(m, os.path.join(out, "rank0.pt"))


def run_rank(rank, world, yaml_cfg, device, port=None, log=print, *,
             backend=None, timeout_s=mesh.DEFAULT_TIMEOUT_S):
    """Rank ``rank`` of an evaluation on ``world`` ranks, on ``device``:
    joins the process group at ``port`` (`parallel.mesh.init_group`; NCCL
    between cards, gloo on the CPU, or ``backend``) when ``world`` > 1,
    evaluates every scene (each rank the same scenes, its own slabs) and
    leaves the group. Rank 0 logs to ``log``. Returns `run`'s metrics."""
    dev = resolve_device(device)
    if world > 1:
        mesh.init_group(rank, world, dev, port, backend=backend,
                        timeout_s=timeout_s)
    try:
        return _evaluate(yaml_cfg, dev, log if rank == 0 else _quiet)
    finally:
        if world > 1:
            dist.destroy_process_group()


def _quiet(msg):
    pass


def _evaluate(yaml_cfg, dev, log):
    sharded = bool(yaml_cfg.get("sharded", False))
    if sharded:
        cfg, scfg, halo_width = sharded_config(yaml_cfg)
        log(f"sharded eval: {mesh.world_size()} devices, block_pad "
            f"{scfg.block_pad}, halo {halo_width:.2f} m, down_quota "
            f"{cfg.down_quota}" + (
                f", halo exchange core_pad {scfg.core_pad} halo_cap "
                f"{scfg.halo_cap}" if scfg.collective else ""))
    else:
        cfg = eval_config(yaml_cfg)
    ncls = cfg.num_classes
    model = build_model(cfg, dev, seed=0)
    model_path = yaml_cfg.get("model_path")
    if model_path:
        _, epoch, _ = checkpoint.restore(model_path, model)
        log(f"loaded checkpoint from {model_path} (epoch {epoch})")
    else:
        log("WARNING: no model_path given — evaluating random weights")
    voxel_max = yaml_cfg.get("voxel_max", 80000)
    ignore = int(yaml_cfg.get("ignore_label", 255))
    # test.py:187 divides the colours by 255 and adds the two shifted
    # passes for s3dis and synthetic scenes only: under any other name
    # (dcf) its synthetic rooms keep rgb 0-255 in five passes
    data_name = yaml_cfg.get("data_name", "synthetic")
    vote_name = "s3dis" if data_name in ("s3dis", "synthetic") else data_name
    voxel_size = yaml_cfg.get("voxel_size", 0.04)
    if sharded:
        stats = {}
        predict = halo.block_predict(model)

        def evaluate(coord, feat):
            return voting.evaluate_scene_sharded(
                predict, coord, feat, ncls, halo_width=halo_width,
                block_pad=scfg.block_pad, device=dev, data_name=vote_name,
                voxel_size=voxel_size, concat_xyz=cfg.concat_xyz,
                stats=stats, core_pad=scfg.core_pad, halo_cap=scfg.halo_cap,
                log=log)
    else:
        predict_probs = make_predict_probs(model)

        def evaluate(coord, feat):
            return voting.evaluate_scene(
                predict_probs, coord, feat, ncls, data_name=vote_name,
                voxel_size=voxel_size, voxel_max=voxel_max,
                batch_size_test=cfg.num_scenes, n_pad=cfg.n_pad,
                num_scenes=cfg.num_scenes, concat_xyz=cfg.concat_xyz)
    inter_sum, union_sum, target_sum = (np.zeros(ncls) for _ in range(3))
    records = []
    scenes = scenes_of(yaml_cfg, ncls)
    for si, (name, coord, feat, label) in enumerate(scenes):
        t0 = time.time()
        pred, _ = evaluate(coord, feat)
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
    if sharded and stats:
        log(f"sharded eval stats: {stats.get('blocks_evaluated', 0)} "
            f"blocks, {stats.get('truncated_halo_points', 0)} halo "
            "points truncated (non-zero => raise sharded_block_points); "
            f"collective chunks {stats.get('collective_chunks', 0)} "
            f"(host-replication fallbacks "
            f"{stats.get('collective_fallback_chunks', 0)}, cap-"
            f"dropped {stats.get('halo_cap_dropped', 0)}, re-run "
            f"{stats.get('collective_rerun_chunks', 0)})")
    m = iou_from_counts(inter_sum, union_sum, target_sum)
    for c in range(ncls):
        log(f"Class_{c:02d} iou/acc {m['iou_class'][c]:.4f}/"
            f"{m['acc_class'][c]:.4f}")
    log(f"Val result: mIoU/mAcc/allAcc {m['miou']:.4f}/{m['macc']:.4f}/"
        f"{m['all_acc']:.4f}")
    m["scenes"] = records
    if sharded:
        m["sharded_stats"] = stats
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
