"""Batches: synthetic scenes -> host batch -> device tensors.

`host_batch` builds what the JAX training loader ships per device
(``train.py::BatchLoader._make_batch``): the collated scenes, the KPConv
stem's radius neighbours and the host geometry pyramid; with
``train=True`` each scene is first augmented by the train loader's four
transforms (``train.py:113-122``). `to_device` moves it onto the card as
int64/float32/bool tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from stratified_transformer_torch.data.collate import (
    collate_scenes, with_stem_neighbors)
from stratified_transformer_torch.data.datasets import SyntheticRooms
from stratified_transformer_torch.data.prepare import with_xyz_concat
from stratified_transformer_torch.data.pyramid import build_geometry_pyramid
from stratified_transformer_torch.data.transforms import train_transform
from stratified_transformer_torch.device import resolve_device


def example_batch(n_pad, num_scenes, seed=0, transform=None,
                  transform_rng=None):
    """The JAX package's ``__graft_entry__._example_batch``: synthetic rooms
    over-sampled ~28% so that after voxel dedup each scene still fills its
    ``n_pad // num_scenes`` quota; ``transform`` augments each scene,
    drawing from ``transform_rng``."""
    ds = SyntheticRooms(
        num_scenes=num_scenes,
        points=max(int(n_pad // num_scenes * 1.28), 512),
        extent=4.0, voxel_size=0.04, voxel_max=n_pad // num_scenes,
        seed=seed, transform=transform, transform_rng=transform_rng)
    scenes = [with_xyz_concat(ds[i]) for i in range(num_scenes)]
    return collate_scenes(scenes, n_pad, num_scenes, ignore_label=255)


def host_batch(cfg, seed=0, ignore_label=255, *, train=False, rng=None,
               aug=None):
    """Numpy batch for `cfg`: ``feats/xyz/offsets/labels``, the stem
    neighbours ``stem_nidx/stem_nmask`` and the ``pyramid``.

    ``train=True`` augments every scene with `train_transform(aug)` (``aug``:
    the flattened YAML, for its ``jitter_sigma``... keys), drawing from the
    numpy Generator ``rng``: identical generators give identical batches.
    """
    if not cfg.concat_xyz:
        raise ValueError("the synthetic batch carries colors + xyz")
    transform = None
    if train:
        if rng is None:
            raise ValueError("host_batch(train=True) needs a numpy Generator")
        transform = train_transform(aug)
    b = example_batch(cfg.n_pad, cfg.num_scenes, seed=seed,
                      transform=transform, transform_rng=rng)
    b = with_stem_neighbors(b, radius=2.5 * cfg.grid_size * cfg.sigma,
                            k=cfg.max_num_neighbors)
    return {"feats": b.feats, "xyz": b.xyz, "offsets": b.offsets,
            "labels": b.labels, "stem_nidx": b.stem_nidx,
            "stem_nmask": b.stem_nmask,
            "pyramid": build_geometry_pyramid(b.xyz, b.offsets, cfg)}


def to_device(tree, device="cuda"):
    """Numpy leaves of a (nested dict / tuple) batch -> tensors on
    ``device``; integer arrays become int64 so that they index directly."""
    dev = resolve_device(device)

    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(move(v) for v in x)
        a = np.asarray(x)
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return move(tree)
