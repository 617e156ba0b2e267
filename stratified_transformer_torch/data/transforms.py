"""Point-cloud augmentations (numpy, host-side).

Copied from the JAX package's ``data/transforms.py`` (reference
``util/transform.py``): each transform maps ``(points, color, rng) ->
(points, color)``, randomness from an explicit ``np.random.Generator``.
`train_transform` is the composition ``train.py::build_dataset`` uses for
``aug: True`` (``train.py:113-122``: RandomRotate / RandomScale /
RandomJitter / RandomDropColor); `FixedShift` is the whole-scene TTA
ensemble's; the Chromatic* / Elastic / Flip family is the reference's
ScanNet-style set. `Compose` draws a fresh generator when given none.
"""

from __future__ import annotations

import numpy as np
import scipy.interpolate
import scipy.ndimage


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, points, color, rng=None):
        rng = rng or np.random.default_rng()
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


class RandomShift:
    def __init__(self, shift_range=0.1):
        self.shift_range = shift_range

    def __call__(self, points, color, rng):
        points = points.copy()
        points[:, 0:3] += rng.uniform(-self.shift_range, self.shift_range, 3)
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


class RandomHorizontalFlip:
    def __init__(self, upright_axis="z"):
        self.upright_axis = {"x": 0, "y": 1, "z": 2}[upright_axis.lower()]

    def __call__(self, points, color, rng):
        points = points.copy()
        if rng.uniform() < 0.95:
            for ax in range(3):
                if ax == self.upright_axis:
                    continue
                if rng.uniform() < 0.5:
                    points[:, ax] = points[:, ax].max() - points[:, ax]
        return points, color


class ChromaticAutoContrast:
    def __init__(self, p=0.2, randomize_blend_factor=True, blend_factor=0.5):
        self.p = p
        self.randomize_blend_factor = randomize_blend_factor
        self.blend_factor = blend_factor

    def __call__(self, points, color, rng):
        if rng.uniform() < self.p:
            lo = color.min(0, keepdims=True)
            hi = color.max(0, keepdims=True)
            scale = 255 / np.maximum(hi - lo, 1e-6)
            contrast = (color - lo) * scale
            blend = (rng.uniform() if self.randomize_blend_factor
                     else self.blend_factor)
            color = (1 - blend) * color + blend * contrast
        return points, color


class ChromaticTranslation:
    def __init__(self, trans_range_ratio=0.1):
        self.ratio = trans_range_ratio

    def __call__(self, points, color, rng):
        if rng.uniform() < 0.95:
            tr = (rng.uniform(size=(1, 3)) - 0.5) * 255 * 2 * self.ratio
            color = np.clip(color + tr, 0, 255)
        return points, color


class ChromaticJitter:
    def __init__(self, std=0.01):
        self.std = std

    def __call__(self, points, color, rng):
        if rng.uniform() < 0.95:
            noise = rng.standard_normal((color.shape[0], 3)) * self.std * 255
            color = np.clip(color + noise, 0, 255)
        return points, color


class RandomRotatePerturbation:
    """Small random rotations about all three axes (reference :69-90)."""

    def __init__(self, angle_sigma=0.06, angle_clip=0.18):
        self.angle_sigma, self.angle_clip = angle_sigma, angle_clip

    def __call__(self, points, color, rng):
        a = np.clip(self.angle_sigma * rng.standard_normal(3),
                    -self.angle_clip, self.angle_clip)
        cx, sx = np.cos(a[0]), np.sin(a[0])
        cy, sy = np.cos(a[1]), np.sin(a[1])
        cz, sz = np.cos(a[2]), np.sin(a[2])
        rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        rot = rz @ ry @ rx
        points = points.copy()
        points[:, 0:3] = points[:, 0:3] @ rot
        return points, color


class HueSaturationTranslation:
    """HSV-space hue/saturation jitter (reference :371-430).

    Operates on 0-255 rgb. Matches the reference's colorsys-derived
    conversion exactly, including the final truncation to whole uint8
    levels (reference ``hsv_to_rgb`` returns ``astype('uint8')``)."""

    def __init__(self, hue_max=0.5, saturation_max=0.2):
        self.hue_max = hue_max
        self.saturation_max = saturation_max

    @staticmethod
    def _rgb_to_hsv(rgb):
        """h, s in [0, 1]; v on the 0-255 scale (colorsys convention)."""
        rgb = rgb.astype(np.float64)
        hsv = np.zeros_like(rgb)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        mx = rgb.max(-1)
        mn = rgb.min(-1)
        hsv[..., 2] = mx
        chroma_mask = mx != mn
        delta = np.where(chroma_mask, mx - mn, 1.0)
        hsv[..., 1] = np.where(chroma_mask, (mx - mn) / np.where(
            chroma_mask, mx, 1.0), 0.0)
        rc = np.where(chroma_mask, (mx - r) / delta, 0.0)
        gc = np.where(chroma_mask, (mx - g) / delta, 0.0)
        bc = np.where(chroma_mask, (mx - b) / delta, 0.0)
        h = np.select([r == mx, g == mx], [bc - gc, 2.0 + rc - bc],
                      default=4.0 + gc - rc)
        hsv[..., 0] = (h / 6.0) % 1.0
        return hsv

    @staticmethod
    def _hsv_to_rgb(hsv):
        """Inverse of `_rgb_to_hsv`; truncates to whole levels like the
        reference's ``astype('uint8')``."""
        h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
        i = np.floor(h * 6.0)
        f = h * 6.0 - i
        p = v * (1 - s)
        q = v * (1 - s * f)
        t = v * (1 - s * (1 - f))
        i = i.astype(np.int64) % 6
        conditions = [s == 0.0, i == 1, i == 2, i == 3, i == 4, i == 5]
        rgb = np.stack([
            np.select(conditions, [v, q, p, p, t, v], default=v),
            np.select(conditions, [v, v, v, q, p, p], default=t),
            np.select(conditions, [v, p, t, v, v, q], default=p),
        ], axis=-1)
        return np.floor(rgb)

    def __call__(self, points, color, rng):
        hsv = self._rgb_to_hsv(color[:, :3])
        hue_val = (rng.uniform() - 0.5) * 2 * self.hue_max
        sat_ratio = 1 + (rng.uniform() - 0.5) * 2 * self.saturation_max
        hsv[..., 0] = np.remainder(hue_val + hsv[..., 0] + 1, 1)
        hsv[..., 1] = np.clip(sat_ratio * hsv[..., 1], 0, 1)
        color = color.copy()
        color[:, :3] = np.clip(self._hsv_to_rgb(hsv), 0, 255)
        return points, color


class ElasticDistortion:
    """Smoothed grid-noise displacement field (reference :251-292)."""

    def __init__(self, distortion_params=((0.2, 0.4), (0.8, 1.6))):
        self.distortion_params = distortion_params

    @staticmethod
    def _distort(coords, granularity, magnitude, rng):
        blurs = [
            np.ones((3, 1, 1, 1), np.float32) / 3,
            np.ones((1, 3, 1, 1), np.float32) / 3,
            np.ones((1, 1, 3, 1), np.float32) / 3,
        ]
        cmin = coords.min(0)
        dims = ((coords - cmin).max(0) // granularity).astype(int) + 3
        noise = rng.standard_normal(size=(*dims, 3)).astype(np.float32)
        for _ in range(2):
            for b in blurs:
                noise = scipy.ndimage.convolve(
                    noise, b, mode="constant", cval=0)
        ax = [
            np.linspace(d_min, d_max, d)
            for d_min, d_max, d in zip(
                cmin - granularity, cmin + granularity * (dims - 2), dims)
        ]
        interp = scipy.interpolate.RegularGridInterpolator(
            ax, noise, bounds_error=False, fill_value=0)
        return coords + interp(coords) * magnitude

    def __call__(self, points, color, rng):
        if self.distortion_params is not None and rng.uniform() < 0.95:
            points = points.copy()
            for granularity, magnitude in self.distortion_params:
                points[:, 0:3] = self._distort(
                    points[:, 0:3], granularity, magnitude, rng)
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
