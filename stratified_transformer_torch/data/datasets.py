"""Datasets (the JAX package's ``data/datasets.py``): the S3DIS, ScanNetv2
and DCF readers, the whole-scene listings of their scenes, and synthetic
room-like scenes.

S3DIS rooms are ``.npy`` arrays of xyz, rgb (0-255) and label columns, one
room per file, named ``Area_<n>_<room>.npy`` (reference ``util/s3dis.py``).
ScanNetv2 scenes are ``.pth`` tuples ``(coords, colors in [-1, 1],
labels)``, one scene per file under ``<data_root>/<split>/`` (reference
``util/scannet_v2.py``). DCF scenes are ``.npy`` object arrays of cube
dicts (face and edge samples, their labels and offset targets, each cube's
centroid and lengths), the files of ``<root>/train`` or ``<root>/test``
whose names hold ``cube`` (reference ``util/dcf.py``).
The synthetic scenes (floor, two walls and a few boxes at configurable
density, with geometry-correlated labels and color cues) let the tests and
the chip smoke run work without the license-gated datasets.
"""

from __future__ import annotations

import glob
import os
import threading

import numpy as np

from stratified_transformer_torch.data.prepare import data_prepare


class _VisitRng:
    """Deterministic per-(item, visit-count) generators
    (``datasets.py:25-48``): each ``__getitem__`` gets a fresh generator
    seeded by ``(seed, idx, earlier visits of idx)``, so any number of
    loader threads gives the same samples in any interleaving. The visit
    counter is the only shared state and is lock-guarded."""

    def __init__(self, seed):
        self.seed = int(seed)
        self._visits = {}
        self._lock = threading.Lock()

    def for_item(self, idx):
        idx = int(idx)
        with self._lock:
            v = self._visits.get(idx, 0)
            self._visits[idx] = v + 1
        return np.random.default_rng((self.seed, idx, v))


class S3DIS:
    """Training / validation samples of S3DIS rooms (reference
    ``util/s3dis.py:14-46``; ``datasets.py:51-83``): the rooms of every
    area but ``test_area`` for ``split="train"``, of ``test_area``
    otherwise, each voxelized, cropped and scaled by `data_prepare`."""

    def __init__(self, split="train", data_root="trainval", test_area=5,
                 voxel_size=0.04, voxel_max=None, transform=None,
                 shuffle_index=False, loop=1, seed=0):
        self.split = split
        self.voxel_size = voxel_size
        self.voxel_max = voxel_max
        self.transform = transform
        self.shuffle_index = shuffle_index
        self.loop = loop
        self.data_root = data_root
        tag = f"Area_{test_area}"
        items = [i[:-4] for i in sorted(os.listdir(data_root)) if "Area_" in i]
        self.data_list = [i for i in items
                          if (tag not in i) == (split == "train")]
        self._rng = _VisitRng(seed)

    def __len__(self):
        return len(self.data_list) * self.loop

    def __getitem__(self, idx):
        item = self.data_list[idx % len(self.data_list)]
        data = np.load(os.path.join(self.data_root, item + ".npy"))
        rng = self._rng.for_item(idx)
        return data_prepare(
            data[:, 0:3], data[:, 3:6], data[:, 6], self.split,
            self.voxel_size, self.voxel_max, feat_scale=255.0, rng=rng,
            transform=self.transform, transform_rng=rng,
            shuffle_index=self.shuffle_index)


def s3dis_scenes(data_root, test_area=5):
    """Whole rooms of ``test_area`` for whole-scene evaluation
    (``test.py:161-167``): ``(name, xyz, rgb 0-255, int64 labels)`` per
    room, in name order."""
    scenes = []
    for item in sorted(i[:-4] for i in os.listdir(data_root)
                       if f"Area_{test_area}" in i):
        d = np.load(os.path.join(data_root, item + ".npy"))
        scenes.append((item, d[:, :3], d[:, 3:6], d[:, 6].astype(np.int64)))
    return scenes


class Scannetv2:
    """Training / validation samples of ScanNetv2 scenes (reference
    ``util/scannet_v2.py:13-52``; ``datasets.py:86-123``): the ``.pth``
    files of ``<data_root>/<split>`` (``trainval``: train and val), in name
    order, each voxelized, cropped and prepared by `data_prepare` with its
    colours as they are (``feat_scale`` 1)."""

    def __init__(self, split="train", data_root="scannetv2", voxel_size=0.02,
                 voxel_max=None, transform=None, shuffle_index=False, loop=1,
                 seed=0):
        self.split = split
        self.voxel_size = voxel_size
        self.voxel_max = voxel_max
        self.transform = transform
        self.shuffle_index = shuffle_index
        self.loop = loop
        if split in ("train", "val", "test"):
            dirs = [os.path.join(data_root, split)]
        elif split == "trainval":
            dirs = [os.path.join(data_root, "train"),
                    os.path.join(data_root, "val")]
        else:
            raise ValueError(split)
        self.files = sorted(
            f for d in dirs for f in glob.glob(os.path.join(d, "*.pth")))
        self._rng = _VisitRng(seed)

    def __len__(self):
        return len(self.files) * self.loop

    def __getitem__(self, idx):
        import torch

        coord, feat, label = torch.load(self.files[idx % len(self.files)],
                                        weights_only=False)[:3]
        rng = self._rng.for_item(idx)
        return data_prepare(
            np.asarray(coord), np.asarray(feat), np.asarray(label),
            self.split, self.voxel_size, self.voxel_max, feat_scale=1.0,
            rng=rng, transform=self.transform, transform_rng=rng,
            shuffle_index=self.shuffle_index)


def scannet_scenes(data_root):
    """Whole validation scenes for whole-scene evaluation (``test.py:
    168-176``): ``(name, xyz, colors in [-1, 1], int64 labels)`` per
    ``.pth`` file of ``<data_root>/val``, in name order."""
    import torch

    root = os.path.join(data_root, "val")
    scenes = []
    for f in sorted(os.listdir(root)):
        if f.endswith(".pth"):
            d = torch.load(os.path.join(root, f), weights_only=False)
            scenes.append((f[:-4], np.asarray(d[0]), np.asarray(d[1]),
                           np.asarray(d[2]).astype(np.int64)))
    return scenes


class DCF:
    """Training / test samples of cuboid-decomposition scenes (reference
    ``util/dcf.py:14-90``; ``datasets.py:126-177``): the ``cube`` files of
    ``<root>/train`` (``split="train"``) or ``<root>/test`` (otherwise) of
    every root in ``data_root``, in name order. An item's points get
    Gaussian noise of ``sigma`` and one random translation (sigma 0.1),
    then `data_prepare` with its offset targets; the three draw from one
    generator per visit of the item."""

    def __init__(self, split="train", data_root=(), voxel_size=0.04,
                 sigma=0.02, voxel_max=None, shuffle_index=False, seed=0):
        self.split = split
        self.voxel_size = voxel_size
        self.voxel_max = voxel_max
        self.sigma = sigma
        self.shuffle_index = shuffle_index
        flag = "train" if split == "train" else "test"
        self.files = sorted(
            f for root in data_root
            for f in glob.glob(os.path.join(root, flag, "*")) if "cube" in f)
        self._rng = _VisitRng(seed)

    def __len__(self):
        return len(self.files)

    @staticmethod
    def load_item(path):
        """``(coord, labels, offsets, feat, params)`` of one scene file: the
        cubes' face then edge samples, in cube order, as float64; ``feat``
        ones; ``params`` one ``(centroid, lengths)`` row per cube."""
        cubes = np.load(path, allow_pickle=True)
        coord = np.concatenate([np.vstack((c["f_samples"], c["e_samples"]))
                                for c in cubes])
        labels = np.concatenate([np.concatenate((c["f_labels"],
                                                 c["e_labels"]))
                                 for c in cubes])
        offsets = np.concatenate([np.vstack((c["f_offsets"], c["e_offsets"]))
                                  for c in cubes])
        params = np.asarray([np.hstack((c["centroid"], c["lengths"]))
                             for c in cubes])
        return coord, labels, offsets, np.ones_like(coord), params

    def __getitem__(self, idx):
        coord, label, t_shift, feat, _ = self.load_item(
            self.files[idx % len(self.files)])
        rng = self._rng.for_item(idx)
        coord = coord + rng.normal(scale=self.sigma, size=coord.shape)
        coord = coord + rng.normal(scale=0.1, size=(1, 3))
        return data_prepare(
            coord, feat, label, self.split, self.voxel_size, self.voxel_max,
            feat_scale=1.0, rng=rng, shuffle_index=self.shuffle_index,
            target_shift=t_shift)


class SyntheticRooms:
    """Fabricated room-like scenes (``datasets.py:180-260``). Item ``idx``
    draws its augmentation, voxel choice and crop from one generator seeded
    ``seed + 7919 (idx + 1)``, as the JAX package's does; a given
    ``transform_rng`` draws the augmentation instead (`loader.example_batch`
    only). With ``with_shift`` each point also gets a random offset target
    (normal, sigma 0.1), drawn after the colour noise."""

    def __init__(self, num_scenes=16, points=60_000, extent=6.0,
                 num_classes=13, voxel_size=0.04, voxel_max=None,
                 seed=0, split="train", transform=None, transform_rng=None,
                 with_shift=False):
        self.num_scenes = num_scenes
        self.points = points
        self.extent = extent
        self.num_classes = num_classes
        self.voxel_size = voxel_size
        self.voxel_max = voxel_max
        self.seed = seed
        self.split = split
        self.transform = transform
        self.transform_rng = transform_rng
        self.with_shift = with_shift

    def __len__(self):
        return self.num_scenes

    def raw_scene(self, idx):
        """``(coord, feat, label, shift)`` of scene ``idx``: float32 points,
        rgb 0-255, int32 labels and, with ``with_shift``, float32 offset
        targets (else None)."""
        rng = np.random.default_rng(self.seed + idx)
        n = self.points
        ex = self.extent
        parts = []
        # floor + two walls (2D manifolds — realistic window occupancy)
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
        part_labels = [0, 1, 1]          # floor / walls
        rest = n - n_fl - 2 * n_w
        # a few box-like objects
        nb = max(rest // 6, 1)
        for bi in range(6):
            c = rng.uniform(0.5, ex - 0.5, 3) * np.array([1, 1, 0.3])
            s = rng.uniform(0.2, 0.9, 3)
            face = rng.integers(0, 3, nb)
            pts = rng.uniform(-0.5, 0.5, (nb, 3)) * s
            pts[np.arange(nb), face] = np.sign(
                rng.uniform(-1, 1, nb)) * s[face] / 2
            parts.append(c + pts)
            part_labels.append(2 + bi % max(self.num_classes - 2, 1))
        coord = np.concatenate(parts)[:n].astype(np.float32)
        label = np.concatenate([
            np.full(len(p_), l_, np.int32)
            for p_, l_ in zip(parts, part_labels)])[:n]
        base_colors = np.stack([
            (np.sin(np.arange(self.num_classes) * 2.1 + c0) * 90 + 130)
            for c0 in (0.0, 2.0, 4.0)], 1)      # [C,3]
        feat = base_colors[label % self.num_classes]
        feat = np.clip(
            feat + rng.normal(0, 25, feat.shape), 0, 255).astype(np.float32)
        label = (label % self.num_classes).astype(np.int32)
        shift = (rng.normal(0, 0.1, (len(coord), 3)).astype(np.float32)
                 if self.with_shift else None)
        return coord, feat, label, shift

    def __getitem__(self, idx):
        coord, feat, label, shift = self.raw_scene(idx)
        rng = np.random.default_rng(self.seed + 7919 * (idx + 1))
        return data_prepare(
            coord, feat, label, self.split, self.voxel_size, self.voxel_max,
            feat_scale=255.0, rng=rng, transform=self.transform,
            transform_rng=(rng if self.transform_rng is None
                           else self.transform_rng), target_shift=shift)
