"""Cuboid instances from predicted offsets (the JAX package's
``eval/instantiation.py``; reference ``util/train_utils.py:547-739``,
``instantiation_eval``), on the host:

1. shift each point by its predicted offset;
2. per semantic class, cluster the shifted points (`dbscan.dbscan_labels`;
   faces, class < 6: eps 0.1, min_samples 5, clusters of more than 50
   points kept; edges: eps 0.15, min_samples 3, more than 20 points) and
   keep each cluster's original coordinates;
3. pair each edge instance with the instances of its two adjacent face
   classes (``LOOKUP_FACE``) in which more than half of its points have a
   point closer than 8 cm;
4. merge the pair sets that share an instance; each merged group's face
   points are one object's support;
5. thin each support (0.04 m voxels) and drop points with fewer than two
   other points within 0.1 m.

The JAX package compares full ``cdist`` matrices with the distance
thresholds (one 20000-point support is 3.2 GB of float64); here a k-d tree
finds the candidates and the distances are recomputed in ``cdist``'s own
order of operations (``sqrt`` of the in-order sum of squares), so every
comparison comes out as the JAX package's does.
"""

from __future__ import annotations

from typing import List

import numpy as np
from scipy.spatial import cKDTree

from stratified_transformer_torch.eval.dbscan import (
    candidate_pairs, dbscan_labels)

# Adjacent face class ids for each of the 12 cube edges
# (reference ``lookup_face``, train_utils.py:601).
LOOKUP_FACE = [
    [0, 1], [0, 2], [1, 2], [0, 3], [1, 3], [0, 4],
    [2, 4], [3, 4], [1, 5], [2, 5], [3, 5], [4, 5],
]


def _cdist_rows(a, b):
    """``scipy.spatial.distance.cdist(a, b)``'s values, in its order of
    operations."""
    d2 = np.zeros((len(a), len(b)))
    for c in range(a.shape[1]):
        d = a[:, c, None] - b[None, :, c]
        d2 = d2 + d * d
    return np.sqrt(d2)


def nearest_below(query, ref, radius, tree=None):
    """Per row of ``query``, whether ``min(cdist(query, ref), axis=1) <
    radius``, without the matrix: the k-d tree's nearest distance decides
    every row but those within a relative 1e-9 of ``radius``, whose row of
    ``cdist`` is computed."""
    query = np.asarray(query, np.float64)
    ref = np.asarray(ref, np.float64)
    tree = cKDTree(ref) if tree is None else tree
    dist, _ = tree.query(query, k=1)
    below = dist < radius
    band = np.flatnonzero(np.abs(dist - radius) <= 1e-9 * radius)
    for r in band:
        below[r] = _cdist_rows(query[r:r + 1], ref).min() < radius
    return below


def cluster_instances(samples, pred_offset, pred_labels, num_face_classes=6):
    """Steps 1-2: per class, the instances (each an ``[m, 3]`` array of
    original coordinates) and their global instance ids."""
    shifted = samples + pred_offset
    cls_list: List[List[np.ndarray]] = []
    indice_list: List[List[int]] = []
    inst_idx = 0
    n_classes = int(pred_labels.max()) + 1 if len(pred_labels) else 0
    for c in range(n_classes):
        sel = pred_labels == c
        pts_trans = shifted[sel]
        pts_ori = samples[sel]
        if c < num_face_classes:
            eps, min_samples, thre = 0.1, 5, 50
        else:
            eps, min_samples, thre = 0.15, 3, 20
        instances: List[np.ndarray] = []
        if len(pts_trans) >= min_samples:
            labels = dbscan_labels(pts_trans, eps, min_samples)
            for j in range(labels.max() + 1):
                inst = pts_ori[labels == j]
                if len(inst) > thre:
                    instances.append(inst)
        cls_list.append(instances)
        indice_list.append(list(range(inst_idx, inst_idx + len(instances))))
        inst_idx += len(instances)
    return cls_list, indice_list


def pair_edges_to_faces(cls_list, indice_list, num_face_classes=6,
                        contact_dist=0.08, contact_ratio=0.5):
    """Step 3: each edge instance with the first instance of each adjacent
    face class in contact (train_utils.py:598-648)."""
    f_cls = cls_list[:num_face_classes]
    e_cls = cls_list[num_face_classes:]
    trees = {}
    pair_list: List[List[int]] = []
    for cls_idx, e_list in enumerate(e_cls[:12]):
        f_idx1, f_idx2 = LOOKUP_FACE[cls_idx]
        if not f_cls[f_idx1] or not f_cls[f_idx2]:
            continue
        for e_supp in e_list:
            paired = []
            for f_idx in (f_idx1, f_idx2):
                for k, fs in enumerate(f_cls[f_idx]):
                    if (f_idx, k) not in trees:
                        trees[f_idx, k] = cKDTree(np.asarray(fs, np.float64))
                    near = nearest_below(e_supp, fs, contact_dist,
                                         trees[f_idx, k])
                    if np.sum(near) / len(near) > contact_ratio:
                        paired.append(indice_list[f_idx][k])
                        break
            if paired:
                pair_list.append(paired)
    return pair_list


def merge_pairs(pair_list):
    """Step 4: merging of id sets that share members, until none do
    (train_utils.py:666-689)."""
    groups = [set(p) for p in pair_list]
    merged = True
    while merged:
        merged = False
        out: List[set] = []
        for g in groups:
            hit = next((o for o in out if o & g), None)
            if hit is not None:
                hit |= g
                merged = True
            else:
                out.append(set(g))
        groups = out
    return [sorted(g) for g in groups]


def _voxel_downsample(pts, voxel=0.04):
    keys = np.floor(pts / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return pts[np.sort(idx)]


def _radius_outlier_filter(pts, nb_points=3, radius=0.1):
    """The points with at least ``nb_points - 1`` other points at a
    ``cdist`` distance of at most ``radius``."""
    if len(pts) == 0:
        return pts
    i, j, d2 = candidate_pairs(pts, radius)
    close = np.sqrt(d2) <= radius
    neighbors = (np.bincount(i[close], minlength=len(pts))
                 + np.bincount(j[close], minlength=len(pts)))
    return pts[neighbors >= nb_points - 1]


def instantiate(samples, pred_offset, pred_labels, num_face_classes=6):
    """The whole pipeline: one support point array per object (reference
    ``instantiation_eval``'s return value)."""
    cls_list, indice_list = cluster_instances(
        samples, pred_offset, pred_labels, num_face_classes)
    pair_list = pair_edges_to_faces(cls_list, indice_list, num_face_classes)
    groups = merge_pairs(pair_list)
    flat_faces = [i for sub in cls_list[:num_face_classes] for i in sub]
    out = []
    for g in groups:
        supp = np.concatenate([flat_faces[i] for i in g
                               if i < len(flat_faces)])
        supp = _voxel_downsample(supp, 0.04)
        supp = _radius_outlier_filter(supp, 3, 0.1)
        if len(supp):
            out.append(supp)
    return out


def instance_eval_pseudo(samples, pred_offset, pred_labels, confidence):
    """Pseudo-label segments (reference ``util/train_utils.py:399-436``;
    ``instantiation.py:149-196``): per predicted class, the clusters of the
    offset-shifted points (eps 0.15, min_samples 3), the noise group
    included, each a segment with the offsets to its centre and a mask
    that is 0 for segments under 10 points. ``confidence`` is unused, as
    in the reference. Returns ``(segments [N, 3], labels [N], offsets [N,
    3], mask [N])``, class-major in cluster order (noise first)."""
    samples = np.asarray(samples)
    shifted = samples + np.asarray(pred_offset)
    pred_labels = np.asarray(pred_labels)
    segs, labels, offsets, masks = [], [], [], []
    eps, min_samples, thre = 0.15, 3, 10
    for i in range(int(pred_labels.max()) + 1):
        sel = pred_labels == i
        if not sel.any():
            continue
        pts_ori = samples[sel]
        lab = dbscan_labels(shifted[sel], eps, min_samples)
        for j in range(lab.max() + 2):
            seg = pts_ori[lab == j - 1]
            center = np.mean(seg, axis=0) if len(seg) else np.zeros(3)
            segs.append(seg)
            labels.append(np.ones(len(seg)) * i)
            offsets.append(center - seg)
            masks.append(np.ones(len(seg)) if len(seg) >= thre
                         else np.zeros(len(seg)))
    return (np.concatenate(segs), np.concatenate(labels),
            np.concatenate(offsets), np.concatenate(masks))


def support_to_box(supp):
    """Axis-aligned box ``[x1, y1, z1, x2, y2, z2]`` of a support set."""
    return np.concatenate([supp.min(0), supp.max(0)])


def compute_partial_iou(box_a, box_b):
    """For two boxes given as (centre, lengths): whether their intersection
    is more than 0.3 of box a's volume, and of box b's (reference
    ``compute_partial_iou``, ``util/train_utils.py:840-862``)."""
    box_a = np.asarray(box_a, float)
    box_b = np.asarray(box_b, float)
    hi = np.minimum(box_a[0:3] + box_a[3:6] / 2, box_b[0:3] + box_b[3:6] / 2)
    lo = np.maximum(box_a[0:3] - box_a[3:6] / 2, box_b[0:3] - box_b[3:6] / 2)
    if not (hi > lo).all():
        return False, False
    inter = (hi - lo).prod()
    thre = 0.3
    return (inter / box_a[3:6].prod()) > thre, \
        (inter / box_b[3:6].prod()) > thre


def _aabb_center_lengths(pts):
    lo, hi = pts.min(0), pts.max(0)
    return np.concatenate([(lo + hi) / 2, hi - lo])


def merge_instances(instances, pc_thre=0.2, min_neighbors=10):
    """Greedy box merging of instance supports (reference ``test.py:
    296-327``): each pass takes the first instance and absorbs every other
    whose box overlaps it by more than 0.3 of either box's volume
    (`compute_partial_iou`) and of whose points more than
    ``min_neighbors`` lie within ``pc_thre`` of it; the group goes to the
    end of the list. One pass per original instance."""
    inst_list = [np.asarray(x) for x in instances]
    if len(inst_list) < 2:
        return inst_list
    for _ in range(len(inst_list)):
        cur = inst_list.pop(0)
        cur_box = _aabb_center_lengths(cur)
        tree = None
        merged = [cur]
        remain = []
        for targ in inst_list:
            ov1, ov2 = compute_partial_iou(
                cur_box, _aabb_center_lengths(targ))
            seamless = False
            if ov1 or ov2:
                if tree is None:
                    tree = cKDTree(np.asarray(cur, np.float64))
                seamless = np.sum(nearest_below(
                    targ, cur, pc_thre, tree)) > min_neighbors
            if (ov1 or ov2) and seamless:
                merged.append(targ)
            else:
                remain.append(targ)
        remain.append(np.concatenate(merged) if len(merged) > 1 else cur)
        inst_list = remain
    return inst_list
