"""Per-sample preparation pipeline (numpy, host-side).

The JAX package's ``data/prepare.py`` (reference ``util/data_util.py:154-255``):
transform (training augmentation) -> voxelize (random point per voxel) ->
sphere-crop to ``voxel_max`` around a random (train) / central (val) seed
-> optional index shuffle -> shift coords to their min corner -> feature
scaling.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from stratified_transformer_torch.data.voxelize import voxelize


def sphere_crop(coord, voxel_max, split, rng):
    """Indices of the ``voxel_max`` nearest points around a seed point
    (reference ``data_util.py:163-166``)."""
    n = coord.shape[0]
    if voxel_max is None or n <= voxel_max:
        return np.arange(n)
    init = rng.integers(n) if "train" in split else n // 2
    d2 = np.sum(np.square(coord - coord[init]), 1)
    return np.argsort(d2)[:voxel_max]


def data_prepare(
    coord,
    feat,
    label,
    split="train",
    voxel_size=0.04,
    voxel_max=None,
    feat_scale=255.0,
    rng: Optional[np.random.Generator] = None,
    transform=None,
    transform_rng: Optional[np.random.Generator] = None,
    shuffle_index: bool = False,
    target_shift=None,
):
    """Returns a scene dict ``{xyz, feats, labels}`` for `collate_scenes`,
    with ``target_shift`` (float32) when one is given: the DCF family's
    per-point offset targets, taken through the same voxel choice, crop and
    shuffle as the points (``data/prepare.py:60-83``).

    ``transform`` (e.g. `data.transforms.train_transform`) augments the raw
    points first, as the JAX package does, drawing from ``transform_rng``;
    ``shuffle_index`` permutes the cropped points with ``rng``."""
    if rng is None:
        raise ValueError("data_prepare needs an explicit numpy Generator")
    coord = np.asarray(coord, np.float32).copy()
    feat = np.asarray(feat, np.float32).copy()
    label = np.asarray(label).copy()

    if transform is not None:
        coord, feat = transform(coord, feat, transform_rng)
    if voxel_size:
        coord -= coord.min(0)
        uniq = voxelize(coord, voxel_size, rng)
        coord, feat, label = coord[uniq], feat[uniq], label[uniq]
        if target_shift is not None:
            target_shift = target_shift[uniq]
    crop = sphere_crop(coord, voxel_max, split, rng)
    coord, feat, label = coord[crop], feat[crop], label[crop]
    if target_shift is not None:
        target_shift = target_shift[crop]
    if shuffle_index:
        sh = rng.permutation(coord.shape[0])
        coord, feat, label = coord[sh], feat[sh], label[sh]
        if target_shift is not None:
            target_shift = target_shift[sh]

    coord -= coord.min(0)
    out = {
        "xyz": coord.astype(np.float32),
        "feats": (feat / feat_scale).astype(np.float32),
        "labels": label.astype(np.int32),
    }
    if target_shift is not None:
        out["target_shift"] = np.asarray(target_shift).astype(np.float32)
    return out


def with_xyz_concat(scene):
    """Reference ``concat_xyz`` (``train.py:332-333``): model input features
    are ``[colors, xyz]``."""
    scene = dict(scene)
    scene["feats"] = np.concatenate(
        [scene["feats"], scene["xyz"]], axis=1).astype(np.float32)
    return scene
