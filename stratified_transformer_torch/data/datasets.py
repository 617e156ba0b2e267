"""Synthetic room-like scenes (the JAX package's ``SyntheticRooms``).

Floor, two walls and a few boxes at configurable density, with
geometry-correlated labels and color cues. Used by the tests and the chip
smoke run so that the port runs without the license-gated datasets.
"""

from __future__ import annotations

import numpy as np

from stratified_transformer_torch.data.prepare import data_prepare


class SyntheticRooms:
    def __init__(self, num_scenes=16, points=60_000, extent=6.0,
                 num_classes=13, voxel_size=0.04, voxel_max=None,
                 seed=0, split="train", transform=None, transform_rng=None):
        self.num_scenes = num_scenes
        self.points = points
        self.extent = extent
        self.num_classes = num_classes
        self.voxel_size = voxel_size
        self.voxel_max = voxel_max
        self.seed = seed
        self.split = split
        # training augmentation and the generator it draws from
        self.transform = transform
        self.transform_rng = transform_rng

    def __len__(self):
        return self.num_scenes

    def raw_scene(self, idx):
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
        return coord, feat, label

    def __getitem__(self, idx):
        coord, feat, label = self.raw_scene(idx)
        rng = np.random.default_rng(self.seed + 7919 * (idx + 1))
        return data_prepare(
            coord, feat, label, self.split, self.voxel_size, self.voxel_max,
            feat_scale=255.0, rng=rng, transform=self.transform,
            transform_rng=self.transform_rng)
