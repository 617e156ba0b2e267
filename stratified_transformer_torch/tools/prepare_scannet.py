"""ScanNetv2 offline preparation (PLY -> .pth) and GT instance txt files.

The port's copy of the repository's ``tools/prepare_scannet.py`` (reference
``dataset/scannetv2/prepare_data_inst.py``, ``prepare_data_inst_gttxt.py``
and the label remap of ``scannet_util.py``), on the port's own PLY reader:

  * coords centred at the scene mean; colours scaled to [-1, 1]
    (``/127.5 - 1``);
  * the 20 benchmark classes remapped to 0..19, everything else -100;
  * instance labels from segs.json + aggregation.json;
  * GT txt files encode ``semantic*1000 + instance`` per point.

A host tool: numpy and ``torch.save``, no device work. The ``.pth`` files it
writes are what `data.datasets.Scannetv2` and `data.datasets.scannet_scenes`
read.

Usage::

    python -m stratified_transformer_torch.tools.prepare_scannet \\
        --data_split val --dir <scans_dir> [--workers N] [--gt_txt_out <dir>]

reads ``<scans_dir>/<split>/*_vh_clean_2.ply`` (with the scan's
``.labels.ply``, ``.0.010000.segs.json`` and ``.aggregation.json`` beside
it, except for the ``test`` split) and writes ``*_inst_nostuff.pth`` next to
each scan.
"""

from __future__ import annotations

import argparse
import glob
import json
import multiprocessing as mp
import os
import time

import numpy as np
import torch

from stratified_transformer_torch.data.ply import read_ply

# benchmark nyu40 ids -> 0..19 (prepare_data_inst.py:10-12)
BENCHMARK_IDS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33,
                 34, 36, 39]
REMAPPER = np.full(150, -100.0)
for i, x in enumerate(BENCHMARK_IDS):
    REMAPPER[x] = i


def _vertex_array(ply):
    v = ply["vertex"]
    coords = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float64)
    colors = np.stack([v["red"], v["green"], v["blue"]], 1).astype(np.float64)
    return coords, colors


def process_scene(fn, with_labels=True):
    """Write the ``_inst_nostuff.pth`` of the scan ``fn`` (its
    ``_vh_clean_2.ply``): ``(coords, colors, semantic, instance)``, or
    ``(coords, colors)`` without labels. Returns the seconds it took."""
    t0 = time.perf_counter()
    ply = read_ply(fn)
    coords, colors = _vertex_array(ply)
    coords = np.ascontiguousarray(coords - coords.mean(0))
    colors = np.ascontiguousarray(colors) / 127.5 - 1

    if not with_labels:
        torch.save((coords, colors), fn[:-15] + "_inst_nostuff.pth")
        return time.perf_counter() - t0

    fn2 = fn[:-3] + "labels.ply"
    fn3 = fn[:-15] + "_vh_clean_2.0.010000.segs.json"
    fn4 = fn[:-15] + ".aggregation.json"
    sem_raw = np.asarray(read_ply(fn2)["vertex"]["label"]).astype(np.int64)
    sem_labels = REMAPPER[np.clip(sem_raw, 0, 149)]

    with open(fn3) as f:
        seg = json.load(f)["segIndices"]
    segid_to_pointid = {}
    for i, s in enumerate(seg):
        segid_to_pointid.setdefault(s, []).append(i)

    instance_labels = np.full(len(coords), -100.0)
    with open(fn4) as f:
        aggregation = json.load(f)["segGroups"]
    for inst_id, group in enumerate(aggregation):
        for s in group["segments"]:
            for pid in segid_to_pointid.get(s, ()):
                instance_labels[pid] = inst_id

    torch.save((coords, colors, sem_labels, instance_labels),
               fn[:-15] + "_inst_nostuff.pth")
    return time.perf_counter() - t0


def write_gt_txt(pth_file, out_dir):
    """GT txt: semantic*1000 + instance per point
    (prepare_data_inst_gttxt.py:14-38 semantics; 'stuff' classes wall/floor
    keep instance 0)."""
    data = torch.load(pth_file, weights_only=False)
    coords, colors, sem, inst = data
    sem = np.asarray(sem).astype(np.int64)
    inst = np.asarray(inst).astype(np.int64)
    # back to nyu40 ids for the benchmark format
    sem_nyu = np.zeros_like(sem)
    for i, x in enumerate(BENCHMARK_IDS):
        sem_nyu[sem == i] = x
    out = np.where(
        (sem >= 2) & (inst >= 0), sem_nyu * 1000 + inst + 1,
        np.where(sem >= 0, sem_nyu * 1000, 0))
    os.makedirs(out_dir, exist_ok=True)
    name = os.path.basename(pth_file).replace("_inst_nostuff.pth", ".txt")
    np.savetxt(os.path.join(out_dir, name), out, fmt="%d")


def main(argv=None):
    """Prepare every scan of ``--dir/--data_split``; returns each scan's
    ``(file, seconds)``. ``--workers 1`` runs the scans in this process;
    more run them in a pool of spawned processes (a fork after torch has
    started its threads can hang)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_split", default="train")
    ap.add_argument("--dir", default=".")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--gt_txt_out", default=None,
                    help="also write GT txt files to this directory")
    args = ap.parse_args(argv)

    files = sorted(glob.glob(
        os.path.join(args.dir, args.data_split, "*_vh_clean_2.ply")))
    print(f"{len(files)} scenes in {args.data_split}")
    with_labels = args.data_split != "test"
    jobs = [(f, with_labels) for f in files]
    if args.workers <= 1:
        seconds = [process_scene(*job) for job in jobs]
    else:
        with mp.get_context("spawn").Pool(args.workers) as pool:
            seconds = pool.starmap(process_scene, jobs)
    for f, s in zip(files, seconds):
        print(f"{os.path.basename(f)[:-15]}: {s:.2f} s")
    if args.gt_txt_out and with_labels:
        for f in sorted(glob.glob(os.path.join(
                args.dir, args.data_split, "*_inst_nostuff.pth"))):
            write_gt_txt(f, args.gt_txt_out)
    return list(zip(files, seconds))


if __name__ == "__main__":
    main()
