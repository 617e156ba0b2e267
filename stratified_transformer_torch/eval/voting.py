"""Whole-scene evaluation: voxel-vote chunks, sliding-sphere crops and the
TTA ensemble (the JAX package's ``eval/voting.py``; reference
``test_backup.py``), and its sharded form over spatial slabs with halos
(`evaluate_scene_sharded`).

  * TTA ensemble: [none, none, rot90, rot180, rot270, (shift +-0.2 for
    s3dis)] (:110-143);
  * per scene: ``voxelize(mode=1)`` -> ``count.max()`` vote chunks; chunk
    ``i`` takes the ``i % count``-th point of every voxel (:177-188);
  * chunks larger than ``voxel_max`` are covered by potential-guided
    sliding-sphere crops until every point is visited (:238-251);
  * crops go through the model ``batch_size_test`` at a time; their
    probabilities are added into the full-resolution accumulator,
    normalised per TTA pass and averaged over the ensemble (:255-288).

The host-side numpy calls (random draws, sorts, the order in which one
generator serves the transforms and the crops) are the JAX package's, so
chunks and crops are bit-identical to its.
"""

from __future__ import annotations

import numpy as np

from stratified_transformer_torch.data import transforms as T
from stratified_transformer_torch.data.voxelize import voxelize
from stratified_transformer_torch.parallel import halo as halo_mod


def tta_transforms(data_name):
    """The reference ensemble (``test_backup.py:110-143``)."""
    out = [None, None]
    for angle in (np.pi / 2, np.pi, 3 * np.pi / 2):
        out.append(T.RandomRotate(rotate_angle=angle, along_z=True))
    if data_name == "s3dis":
        out.append(T.FixedShift(0.2))
        out.append(T.FixedShift(-0.2))
    return out


def vote_chunks(coord, voxel_size):
    """Voxel-vote chunk index lists (``test_backup.py:177-188``)."""
    coord = coord - coord.min(0)
    idx_sort, count = voxelize(coord, voxel_size, mode=1)
    starts = np.cumsum(np.insert(count, 0, 0)[0:-1])
    return [idx_sort[starts + i % count] for i in range(count.max())]


def sphere_cover_crops(coord_part, voxel_max, rng=None):
    """Potential-guided sliding-sphere cover (``test_backup.py:238-251``):
    index arrays into ``coord_part`` whose union covers every point, each
    the ``voxel_max`` nearest points around the current least-potential
    seed."""
    n = coord_part.shape[0]
    if voxel_max is None or n <= voxel_max:
        return [np.arange(n)]
    rng = rng or np.random.default_rng(0)
    potential = rng.random(n) * 1e-3
    visited = np.zeros(n, bool)
    crops = []
    while not visited.all():
        init = int(np.argmin(potential))
        dist = np.sum((coord_part - coord_part[init]) ** 2, 1)
        idx_crop = np.argsort(dist)[:voxel_max]
        d = dist[idx_crop]
        potential[idx_crop] += np.square(1 - d / np.max(d))
        visited[idx_crop] = True
        crops.append(idx_crop)
    return crops


def evaluate_scene(predict_probs, coord, feat, num_classes, *,
                   data_name="s3dis", voxel_size=0.04, voxel_max=80000,
                   batch_size_test=5, n_pad=0, num_scenes=5, concat_xyz=True,
                   transforms=None, rng=None):
    """Full-protocol prediction for one scene.

    ``predict_probs(feats [n_pad, C], xyz [n_pad, 3], offsets [B]) -> probs
    [n_pad, num_classes]`` takes and returns numpy arrays; ``coord`` /
    ``feat`` are the raw full-resolution scene (0-255 rgb for s3dis).
    Returns ``(pred [N] labels, accumulated probabilities [N, classes])``.
    """
    rng = rng or np.random.default_rng(0)
    if transforms is None:
        transforms = tta_transforms(data_name)
    n = coord.shape[0]
    pred_all = np.zeros((n, num_classes), np.float64)

    for tfm in transforms:
        c, f = np.asarray(coord, np.float32).copy(), np.asarray(
            feat, np.float32).copy()
        if tfm is not None:
            c, f = tfm(c, f, rng)
        c -= c.min(0)

        idx_list, coord_list, feat_list = [], [], []
        for idx_part in vote_chunks(c, voxel_size):
            cp, fp = c[idx_part], f[idx_part]
            for idx_crop in sphere_cover_crops(cp, voxel_max, rng):
                cs, fs = cp[idx_crop].copy(), fp[idx_crop].copy()
                cs -= cs.min(0)
                if data_name == "s3dis":
                    fs = fs / 255.0
                idx_list.append(idx_part[idx_crop])
                coord_list.append(cs)
                feat_list.append(fs)

        pred = np.zeros((n, num_classes), np.float64)
        for s in range(0, len(idx_list), batch_size_test):
            e = min(s + batch_size_test, len(idx_list))
            sizes = [len(x) for x in idx_list[s:e]]
            if sum(sizes) > n_pad:
                raise ValueError(f"{sum(sizes)} points in {len(sizes)} crops "
                                 f"exceed n_pad {n_pad}")
            xyz_b = np.zeros((n_pad, 3), np.float32)
            feat_dim = feat_list[0].shape[1] + (3 if concat_xyz else 0)
            feat_b = np.zeros((n_pad, feat_dim), np.float32)
            pos = 0
            offsets = np.zeros((num_scenes,), np.int32)
            for j, (cc, ff) in enumerate(
                    zip(coord_list[s:e], feat_list[s:e])):
                m = len(cc)
                xyz_b[pos:pos + m] = cc
                feat_b[pos:pos + m] = (np.concatenate([ff, cc], 1)
                                       if concat_xyz else ff)
                pos += m
                offsets[j] = pos
            offsets[len(sizes):] = pos
            probs = np.asarray(predict_probs(feat_b, xyz_b, offsets))
            idx_cat = np.concatenate(idx_list[s:e])
            pred[idx_cat] += probs[:len(idx_cat)]

        pred = pred / (pred.sum(-1, keepdims=True) + 1e-8)
        pred_all += pred

    pred_all /= len(transforms)
    return pred_all.argmax(-1), pred_all


def _add(stats, key, value):
    stats[key] = stats.get(key, 0) + value


def evaluate_scene_sharded(predict, coord, feat, num_classes, *, halo_width,
                           block_pad, device, data_name="s3dis",
                           voxel_size=0.04, concat_xyz=True, transforms=None,
                           rng=None, stats=None, core_pad=0, halo_cap=0,
                           log=None):
    """`evaluate_scene` with each vote chunk split into one spatial slab per
    rank, each with a halo of ``halo_width`` (``eval/voting.py:156-274`` of
    the JAX package), in place of the sphere crops; the TTA passes and the
    vote chunks are `evaluate_scene`'s, drawn alike. Every rank of the
    process group runs it on the same scene and returns the same result.

    ``predict`` is a rank's block forward (`parallel.halo.block_predict`).
    With ``core_pad`` (and ``halo_cap``) > 0 each chunk goes through the
    halo exchange (`parallel.halo.sharded_scene_probs_collective`); a chunk
    whose core slab exceeds ``core_pad`` falls back to host replication at
    ``block_pad`` (`parallel.halo.sharded_scene_probs`), which also takes
    every chunk without the exchange; a chunk whose halo exceeds
    ``halo_cap`` is re-run through host replication, with one line to
    ``log``. ``stats`` accumulates the JAX package's counters
    (``truncated_halo_points``, ``blocks_evaluated``,
    ``collective_chunks``, ``collective_fallback_chunks``,
    ``halo_cap_dropped``, ``collective_<mode>_scenes``) and
    ``collective_rerun_chunks``. Returns ``(pred [N] labels, accumulated
    probabilities [N, classes])``."""
    rng = rng or np.random.default_rng(0)
    stats = {} if stats is None else stats
    if transforms is None:
        transforms = tta_transforms(data_name)
    n = coord.shape[0]
    pred_all = np.zeros((n, num_classes), np.float64)
    kw = dict(concat_xyz=concat_xyz, halo=halo_width, device=device)

    for p, tfm in enumerate(transforms):
        c, f = np.asarray(coord, np.float32).copy(), np.asarray(
            feat, np.float32).copy()
        if tfm is not None:
            c, f = tfm(c, f, rng)
        c -= c.min(0)

        pred = np.zeros((n, num_classes), np.float64)
        for k, idx_part in enumerate(vote_chunks(c, voxel_size)):
            cp, fp = c[idx_part].copy(), f[idx_part].copy()
            cp -= cp.min(0)
            if data_name == "s3dis":
                fp = fp / 255.0
            bstats = {}
            probs = None
            if core_pad:
                try:
                    probs = halo_mod.sharded_scene_probs_collective(
                        predict, cp, fp, num_classes, core_pad=core_pad,
                        halo_cap=halo_cap, stats=bstats, **kw)
                    _add(stats, "collective_chunks", 1)
                except halo_mod.CoreSlabOverflow:
                    _add(stats, "collective_fallback_chunks", 1)
                except halo_mod.HaloCapOverflow as e:
                    _add(stats, "collective_rerun_chunks", 1)
                    if log is not None:
                        log(f"pass {p} chunk {k} ({len(idx_part)} points): "
                            f"{e}; re-run through host replication")
                for key, v in bstats.items():
                    if key.startswith("collective_") or (
                            key == "halo_cap_dropped"):
                        _add(stats, key, v)
            if probs is None:
                bstats = {}
                probs = halo_mod.sharded_scene_probs(
                    predict, cp, fp, num_classes, n_pad=block_pad,
                    stats=bstats, **kw)
            _add(stats, "truncated_halo_points",
                 bstats.get("truncated_halo_points", 0))
            _add(stats, "blocks_evaluated", len(bstats["block_points"]))
            pred[idx_part] += probs

        pred = pred / (pred.sum(-1, keepdims=True) + 1e-8)
        pred_all += pred

    pred_all /= len(transforms)
    return pred_all.argmax(-1), pred_all
