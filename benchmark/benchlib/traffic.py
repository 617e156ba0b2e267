"""Traffic: the arrays each cell feeds the program, generated from the run's
seed by one generator that reads a traffic file's parameters.

Frozen copies, so that a change to the program cannot move the inputs: the
synthetic room generator (the port's ``data/datasets.py::SyntheticRooms.
raw_scene``), the training augmentation (``data/transforms.py``'s rotate,
scale, jitter and colour drop), the voxel choice and sphere crop
(``data/voxelize.py``, ``data/prepare.py``), the collation
(``data/collate.py::collate_scenes``) and whole-scene evaluation's crops
and packing (``eval/voting.py``: ``tta_transforms``, ``vote_chunks``,
``sphere_cover_crops`` and the batch packing of ``evaluate_scene``).

Training traffic (``"kind": "train"``): a pool of distinct batches, each
rooms of ``room_points`` raw points in ``room_extent`` metres from the
seed, augmented as the configuration's ``aug`` keys say, voxelized at its
``voxel_size`` and cropped to exactly ``points_per_room`` points, collated
into the configuration's ``n_pad`` and scene slots. Every seed gets the
same sizes; the rooms and augmentations differ.

Evaluation traffic (``"kind": "eval"``): the crops of the TTA passes of one
room (``room_seed``, ``crop_seed``: the same batches for every seed),
packed ``batch_size_test`` at a time into the evaluation capacity; the
run's seed orders them.
"""

from __future__ import annotations

import numpy as np


# ---- the room generator (SyntheticRooms.raw_scene) ----------------------

def raw_room(rng, points, extent, num_classes):
    """``(coord float32 [n,3], rgb 0-255 float32 [n,3], int32 labels)`` of
    one room: a floor, two walls and six boxes."""
    n = points
    ex = extent
    parts = []
    n_fl = n // 3
    floor = np.stack([
        rng.uniform(0, ex, n_fl), rng.uniform(0, ex, n_fl),
        rng.normal(0, 0.02, n_fl)], 1)
    n_w = n // 4
    wall1 = np.stack([
        rng.uniform(0, ex, n_w), rng.normal(0, 0.02, n_w),
        rng.uniform(0, ex / 2, n_w)], 1)
    wall2 = np.stack([
        rng.normal(0, 0.02, n_w), rng.uniform(0, ex, n_w),
        rng.uniform(0, ex / 2, n_w)], 1)
    parts += [floor, wall1, wall2]
    part_labels = [0, 1, 1]
    rest = n - n_fl - 2 * n_w
    nb = max(rest // 6, 1)
    for bi in range(6):
        c = rng.uniform(0.5, ex - 0.5, 3) * np.array([1, 1, 0.3])
        s = rng.uniform(0.2, 0.9, 3)
        face = rng.integers(0, 3, nb)
        pts = rng.uniform(-0.5, 0.5, (nb, 3)) * s
        pts[np.arange(nb), face] = np.sign(
            rng.uniform(-1, 1, nb)) * s[face] / 2
        parts.append(c + pts)
        part_labels.append(2 + bi % max(num_classes - 2, 1))
    coord = np.concatenate(parts)[:n].astype(np.float32)
    label = np.concatenate([
        np.full(len(p_), l_, np.int32)
        for p_, l_ in zip(parts, part_labels)])[:n]
    base_colors = np.stack([
        (np.sin(np.arange(num_classes) * 2.1 + c0) * 90 + 130)
        for c0 in (0.0, 2.0, 4.0)], 1)
    feat = base_colors[label % num_classes]
    feat = np.clip(
        feat + rng.normal(0, 25, feat.shape), 0, 255).astype(np.float32)
    label = (label % num_classes).astype(np.int32)
    return coord, feat, label


# ---- augmentation (data/transforms.py) ----------------------------------

def rotate_z(points, angle):
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    points = points.copy()
    points[:, 0:3] = points[:, 0:3] @ rot
    return points


def augment(coord, feat, rng, aug):
    """The train loader's composition with the configuration's keys:
    rotation about z by U(0, 2pi), scale U(scale_low, scale_high), jitter
    N(0, jitter_sigma) clipped to jitter_clip, colours times color_augment
    with probability 0.2."""
    coord = rotate_z(coord, rng.uniform() * 2 * np.pi)
    coord = coord * rng.uniform(aug.get("scale_low", 0.8),
                                aug.get("scale_high", 1.2))
    jitter = np.clip(aug.get("jitter_sigma", 0.005)
                     * rng.standard_normal((coord.shape[0], 3)),
                     -aug.get("jitter_clip", 0.02), aug.get("jitter_clip",
                                                            0.02))
    coord = coord + jitter
    if rng.uniform() > 0.8:
        feat = feat * aug.get("color_augment", 0.0)
    return coord.astype(np.float32), feat


# ---- voxels and crops (data/voxelize.py, data/prepare.py) ---------------

def fnv_hash_vec(arr):
    arr = arr.astype(np.uint64, copy=True)
    h = np.full(arr.shape[0], np.uint64(14695981039346656037))
    for j in range(arr.shape[1]):
        h = h * np.uint64(1099511628211)
        h = np.bitwise_xor(h, arr[:, j])
    return h


def voxelize(coord, voxel_size, rng=None, mode=0):
    """Mode 0: one random point per occupied voxel; mode 1: ``(idx_sort,
    count)``, the points in hash order and each voxel's count."""
    discrete = np.floor(coord / np.array(voxel_size)).astype(np.int64)
    key = fnv_hash_vec(discrete)
    idx_sort = np.argsort(key)
    key_sort = key[idx_sort]
    _, count = np.unique(key_sort, return_counts=True)
    if mode == 1:
        return idx_sort, count
    pick = rng.integers(0, count.max(), count.size) % count
    idx_select = np.cumsum(np.insert(count, 0, 0)[0:-1]) + pick
    return idx_sort[idx_select]


def prepare_room(coord, feat, label, rng, *, voxel_size, points, feat_scale,
                 aug=None):
    """Augment (``aug`` given), voxelize, crop the ``points`` nearest points
    around a random point, shuffle, shift to the min corner, scale the
    colours; features are ``[colours, xyz]``. Raises if the room has fewer
    voxels than ``points``, so that every batch has the same size."""
    coord = np.asarray(coord, np.float32).copy()
    feat = np.asarray(feat, np.float32).copy()
    if aug is not None:
        coord, feat = augment(coord, feat, rng, aug)
    coord -= coord.min(0)
    uniq = voxelize(coord, voxel_size, rng)
    coord, feat, label = coord[uniq], feat[uniq], label[uniq]
    if len(coord) < points:
        raise ValueError(f"a room has {len(coord)} voxels, fewer than the "
                         f"{points} points the traffic crops to")
    init = rng.integers(len(coord))
    d2 = np.sum(np.square(coord - coord[init]), 1)
    crop = np.argsort(d2)[:points]
    sh = rng.permutation(points)
    coord, feat, label = coord[crop][sh], feat[crop][sh], label[crop][sh]
    coord -= coord.min(0)
    feat = (feat / feat_scale).astype(np.float32)
    return {"xyz": coord.astype(np.float32),
            "feats": np.concatenate([feat, coord], 1).astype(np.float32),
            "labels": label.astype(np.int32)}


def collate(rooms, n_pad, num_scenes, ignore_label):
    """Rooms in order while they fit ``n_pad``, into flat padded arrays
    with cumulative ``offsets`` (``data/collate.py::collate_scenes``)."""
    kept, total = [], 0
    for r in rooms[:num_scenes]:
        n = len(r["xyz"])
        if kept and total + n > n_pad:
            break
        kept.append(r)
        total += n
    c = kept[0]["feats"].shape[1]
    xyz = np.zeros((n_pad, 3), np.float32)
    feats = np.zeros((n_pad, c), np.float32)
    labels = np.full((n_pad,), ignore_label, np.int32)
    offsets = np.zeros((num_scenes,), np.int32)
    pos = 0
    for i in range(num_scenes):
        if i < len(kept):
            n = len(kept[i]["xyz"])
            xyz[pos:pos + n] = kept[i]["xyz"]
            feats[pos:pos + n] = kept[i]["feats"]
            labels[pos:pos + n] = kept[i]["labels"]
            pos += n
        offsets[i] = pos
    return {"xyz": xyz, "feats": feats, "labels": labels, "offsets": offsets}


def train_batches(traffic, model_cfg, yaml_cfg, seed):
    """The pool of ``traffic["pool"]`` distinct training batches of seed
    ``seed``: numpy ``xyz/feats/labels/offsets`` at the configuration's
    ``n_pad`` and scene slots."""
    n_pad, slots = model_cfg.n_pad, model_cfg.num_scenes
    per_room = int(traffic["points_per_room"])
    rooms_per_batch = min(n_pad // per_room, slots)
    aug = dict(yaml_cfg) if yaml_cfg.get("aug", False) else None
    batches = []
    for b in range(int(traffic["pool"])):
        rooms = []
        for r in range(rooms_per_batch):
            rng = np.random.default_rng((seed, b, r))
            coord, feat, label = raw_room(
                rng, int(traffic["room_points"]),
                float(traffic["room_extent"]), model_cfg.num_classes)
            rooms.append(prepare_room(
                coord, feat, label, rng,
                voxel_size=float(yaml_cfg.get("voxel_size", 0.04)),
                points=per_room, feat_scale=float(traffic["feat_scale"]),
                aug=aug))
        batches.append(collate(rooms, n_pad, slots,
                               int(yaml_cfg.get("ignore_label", 255))))
    return batches


# ---- whole-scene evaluation's crops (eval/voting.py) --------------------

def tta_passes(data_name):
    """The TTA ensemble as ``(angle, shift)`` pairs: two identities, three
    rotations about z and, for S3DIS, shifts of +-0.2."""
    out = [(None, 0.0), (None, 0.0)]
    out += [(a, 0.0) for a in (np.pi / 2, np.pi, 3 * np.pi / 2)]
    if data_name == "s3dis":
        out += [(None, 0.2), (None, -0.2)]
    return out


def vote_chunks(coord, voxel_size):
    coord = coord - coord.min(0)
    idx_sort, count = voxelize(coord, voxel_size, mode=1)
    starts = np.cumsum(np.insert(count, 0, 0)[0:-1])
    return [idx_sort[starts + i % count] for i in range(count.max())]


def sphere_cover_crops(coord_part, voxel_max, rng):
    n = coord_part.shape[0]
    if voxel_max is None or n <= voxel_max:
        return [np.arange(n)]
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


def eval_batches(traffic, model_cfg, yaml_cfg):
    """The packed batches of the TTA passes ``traffic["passes"]`` (a count
    from the first) of one room: ``feats/xyz/offsets`` numpy arrays at
    the evaluation capacity and ``points``, the valid count. The same for
    every seed."""
    rng = np.random.default_rng(int(traffic["room_seed"]))
    coord, rgb, _ = raw_room(rng, int(traffic["room_points"]),
                             float(traffic["room_extent"]),
                             model_cfg.num_classes)
    data_name = str(yaml_cfg.get("data_name", "s3dis"))
    if data_name != "s3dis":
        rgb = rgb / 127.5 - 1.0              # ScanNet's colours in [-1, 1]
    voxel_size = float(yaml_cfg.get("voxel_size", 0.04))
    voxel_max = int(yaml_cfg.get("voxel_max", 80000))
    bst, n_pad = model_cfg.num_scenes, model_cfg.n_pad
    crop_rng = np.random.default_rng(int(traffic["crop_seed"]))
    batches = []
    for angle, shift in tta_passes(data_name)[:int(traffic["passes"])]:
        c = np.asarray(coord, np.float32).copy()
        f = np.asarray(rgb, np.float32).copy()
        if angle is not None:
            c = rotate_z(c, angle)
        c[:, 0:3] += shift
        c -= c.min(0)
        crops = []
        for idx_part in vote_chunks(c, voxel_size):
            cp, fp = c[idx_part], f[idx_part]
            for idx_crop in sphere_cover_crops(cp, voxel_max, crop_rng):
                cs, fs = cp[idx_crop].copy(), fp[idx_crop].copy()
                cs -= cs.min(0)
                if data_name == "s3dis":
                    fs = fs / 255.0
                crops.append((cs, fs))
        for s in range(0, len(crops), bst):
            group = crops[s:s + bst]
            xyz = np.zeros((n_pad, 3), np.float32)
            feats = np.zeros((n_pad, 6), np.float32)
            offsets = np.zeros((bst,), np.int32)
            pos = 0
            for j, (cc, ff) in enumerate(group):
                m = len(cc)
                xyz[pos:pos + m] = cc
                feats[pos:pos + m] = np.concatenate([ff, cc], 1)
                pos += m
                offsets[j] = pos
            offsets[len(group):] = pos
            batches.append({"feats": feats, "xyz": xyz, "offsets": offsets,
                            "points": pos})
    return batches


def cycle_order(count, seed):
    """The order in which a run cycles its ``count`` batches: a permutation
    drawn from the seed."""
    return np.random.default_rng((seed, 7)).permutation(count)
