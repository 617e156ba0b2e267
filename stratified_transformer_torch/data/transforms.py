"""The S3DIS augmentations (numpy, host-side).

Copied from the JAX package's ``data/transforms.py`` (reference
``util/transform.py``): the four transforms ``train.py::build_dataset``
composes for ``aug: True`` (``train.py:113-122``), and the fixed shift of
the whole-scene TTA ensemble. Each maps ``(points, color, rng) -> (points,
color)``; randomness comes from an explicit ``np.random.Generator``.
"""

from __future__ import annotations

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, points, color, rng):
        for t in self.transforms:
            points, color = t(points, color, rng)
        return points, color


class RandomRotate:
    """Rotate around z (or y) by U(0, 2pi) (reference :44-66)."""

    def __init__(self, rotate_angle=None, along_z=True):
        self.rotate_angle = rotate_angle
        self.along_z = along_z

    def __call__(self, points, color, rng):
        angle = (rng.uniform() * 2 * np.pi
                 if self.rotate_angle is None else self.rotate_angle)
        c, s = np.cos(angle), np.sin(angle)
        if self.along_z:
            rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
        else:
            rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        points = points.copy()
        points[:, 0:3] = points[:, 0:3] @ rot
        return points, color


class RandomScale:
    def __init__(self, scale_low=0.8, scale_high=1.2):
        self.scale_low, self.scale_high = scale_low, scale_high

    def __call__(self, points, color, rng):
        points = points.copy()
        points[:, 0:3] *= rng.uniform(self.scale_low, self.scale_high)
        return points, color


class FixedShift:
    """Deterministic shift of the S3DIS TTA ensemble (reference
    ``RandomShift_test`` :6-18, ``test_backup.py:112-143``)."""

    def __init__(self, shift_range=0.1):
        self.shift_range = shift_range

    def __call__(self, points, color, rng=None):
        points = points.copy()
        points[:, 0:3] += np.ones(3) * self.shift_range
        return points, color


class RandomJitter:
    def __init__(self, sigma=0.01, clip=0.05):
        if clip <= 0:
            raise ValueError("RandomJitter needs clip > 0")
        self.sigma, self.clip = sigma, clip

    def __call__(self, points, color, rng):
        jitter = np.clip(
            self.sigma * rng.standard_normal((points.shape[0], 3)),
            -self.clip, self.clip)
        points = points.copy()
        points[:, 0:3] += jitter
        return points, color


class RandomDropColor:
    """With prob 1-p, scale colors by ``color_augment`` (0 = drop;
    reference :237-248)."""

    def __init__(self, p=0.8, color_augment=0.0):
        self.p, self.color_augment = p, color_augment

    def __call__(self, points, color, rng):
        if color is not None and rng.uniform() > self.p:
            color = color * self.color_augment
        return points, color


def train_transform(cfg=None):
    """The train loader's composition (``train.py:113-122``), reading the
    flattened YAML keys with the JAX driver's defaults."""
    cfg = cfg or {}
    return Compose([
        RandomRotate(along_z=cfg.get("rotate_along_z", True)),
        RandomScale(cfg.get("scale_low", 0.8), cfg.get("scale_high", 1.2)),
        RandomJitter(cfg.get("jitter_sigma", 0.005),
                     cfg.get("jitter_clip", 0.02)),
        RandomDropColor(color_augment=cfg.get("color_augment", 0.0)),
    ])
