"""Batch collation into static padded arrays (numpy, host-side).

The JAX package's ``data/collate.py``: ragged scenes are concatenated into a
flat ``[n_pad]`` layout with cumulative ``offsets`` (reference
``util/data_util.py:103-122``); scenes that do not fit are dropped as the
reference's ``collate_fn_limit`` drops them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

from stratified_transformer_torch.data import host_neighbors


class PaddedBatch(NamedTuple):
    """xyz ``[n_pad, 3]`` float32; feats ``[n_pad, C]`` float32; labels
    ``[n_pad]`` int32 (ignore_label on padding); offsets ``[num_scenes]``
    int32 cumulative scene sizes (padding scenes repeat the last offset);
    target_shift ``[n_pad, 3]`` float32, zero on padding, when the scenes
    carry the DCF family's offset targets; stem_nidx / stem_nmask ``[n_pad,
    K]`` host radius neighbours."""

    xyz: np.ndarray
    feats: np.ndarray
    labels: np.ndarray
    offsets: np.ndarray
    target_shift: Optional[np.ndarray] = None
    stem_nidx: Optional[np.ndarray] = None
    stem_nmask: Optional[np.ndarray] = None


def mix3d_pairs(scenes):
    """Mix3D scene mixing (``data/collate.py:36-60``; reference
    ``collate_fn_mix3d``, ``util/data_util.py:17-58``): consecutive pairs of
    scenes merge into one, points, features and labels (and offset targets,
    where both scenes carry them) concatenated and coordinates kept; an odd
    last scene passes through."""
    out = []
    for i in range(0, len(scenes) - 1, 2):
        a, b = scenes[i], scenes[i + 1]
        keys = ["xyz", "feats", "labels"]
        if "target_shift" in a and "target_shift" in b:
            keys.append("target_shift")
        out.append({key: np.concatenate([a[key], b[key]]) for key in keys})
    if len(scenes) % 2:
        out.append(scenes[-1])
    return out


def collate_scenes(
    scenes: Sequence[dict],
    n_pad: int,
    num_scenes: int,
    ignore_label: int = 255,
    max_batch_points: Optional[int] = None,
):
    """Collate per-scene dicts ``{xyz, feats, labels[, target_shift]}`` in
    order while the running point total fits ``max_batch_points`` and
    ``n_pad``; the first kept scene decides whether the batch carries
    ``target_shift``."""
    limit = n_pad if max_batch_points is None else min(n_pad, max_batch_points)
    kept = []
    total = 0
    for s in scenes[:num_scenes]:
        n = len(s["xyz"])
        if kept and total + n > limit:
            break
        if n > limit:
            continue
        kept.append(s)
        total += n

    c = kept[0]["feats"].shape[1]
    xyz = np.zeros((n_pad, 3), np.float32)
    feats = np.zeros((n_pad, c), np.float32)
    labels = np.full((n_pad,), ignore_label, np.int32)
    shift = (np.zeros((n_pad, 3), np.float32) if "target_shift" in kept[0]
             else None)
    offsets = np.zeros((num_scenes,), np.int32)
    pos = 0
    for i in range(num_scenes):
        if i < len(kept):
            s = kept[i]
            n = len(s["xyz"])
            xyz[pos:pos + n] = s["xyz"]
            feats[pos:pos + n] = s["feats"]
            labels[pos:pos + n] = s["labels"]
            if shift is not None:
                shift[pos:pos + n] = s["target_shift"]
            pos += n
        offsets[i] = pos
    return PaddedBatch(xyz=xyz, feats=feats, labels=labels, offsets=offsets,
                       target_shift=shift)


def with_stem_neighbors(batch: PaddedBatch, radius: float, k: int):
    """Attach host-computed KPConv-stem radius neighbours (reference CPU
    ball_query, ``train.py:324-329``). Empty slots hold the point's own
    index with mask False, so every index is gather-safe."""
    n_pad = len(batch.xyz)
    total = int(batch.offsets[-1])
    idx = np.zeros((n_pad, k), np.int32)
    mask = np.zeros((n_pad, k), bool)
    if total > 0:
        raw = host_neighbors.radius_neighbors(
            batch.xyz[:total], np.asarray(batch.offsets, np.int64),
            float(radius), int(k))
        ok = raw >= 0
        own = np.arange(total, dtype=np.int32)[:, None]
        idx[:total] = np.where(ok, raw, own)
        mask[:total] = ok
    return batch._replace(stem_nidx=idx, stem_nmask=mask)
