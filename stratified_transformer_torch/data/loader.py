"""Batches: datasets -> host batches -> device tensors.

`build_dataset` and `BatchLoader` are the JAX training driver's
(``train.py:113-302``): a map-style dataset (S3DIS rooms, ScanNetv2 scenes,
DCF cube scenes or synthetic rooms) read in batches of ``batch_size`` scenes, each batch
the collated scenes, the KPConv stem's radius neighbours and the host
geometry pyramid, built ahead of the training step by an ordered pool of
threads.
`host_batch` builds one such batch from synthetic rooms directly; with
``train=True`` each scene is first augmented by the train loader's four
transforms. `to_device` moves a batch onto the card as int64/float32/bool
tensors.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from stratified_transformer_torch.data.collate import (
    collate_scenes, mix3d_pairs, with_stem_neighbors)
from stratified_transformer_torch.data.datasets import (
    DCF, S3DIS, Scannetv2, SyntheticRooms)
from stratified_transformer_torch.data.prepare import with_xyz_concat
from stratified_transformer_torch.data.pyramid import build_geometry_pyramid
from stratified_transformer_torch.data.transforms import train_transform
from stratified_transformer_torch.device import resolve_device


def build_dataset(cfg, split):
    """The ``split`` ("train" or "val") dataset of the flattened YAML
    ``cfg`` (``train.py:113-161``): ``data_name`` s3dis (the ``.npy`` rooms
    under ``data_root``, points shuffled, ``loop`` passes for training),
    scannetv2 (the ``.pth`` scenes of ``data_root``'s ``train`` directory
    for training, of ``val`` otherwise; points shuffled, ``loop`` passes for
    training), dcf (the cube files of the ``train`` directory of each
    ``data_root``, a str or a list, for training, of ``test`` otherwise;
    points shuffled, Gaussian noise of ``noise_sigma``, offset targets) or
    synthetic (``synthetic_scenes`` rooms of ``synthetic_points`` points,
    seed 0 for training and 10000 for validation, with offset targets when
    ``with_regressor`` is set); training items are augmented when ``aug``
    is set (not DCF's, as in the JAX driver)."""
    name = cfg.get("data_name", "synthetic")
    voxel_max = cfg.get("voxel_max")
    tfm = (train_transform(cfg)
           if bool(cfg.get("aug", False)) and split == "train" else None)
    if name in ("s3dis", "scannetv2", "dcf") and not cfg.get("data_root"):
        raise ValueError(f"data_name {name} needs data_root, " + {
            "s3dis": "the directory of the .npy rooms",
            "scannetv2": "the directory holding train/ and val/ .pth scenes",
            "dcf": "the directories (a str or a list) holding train/ and "
                   "test/ cube files"}[name])
    if name == "s3dis":
        return S3DIS(
            split=split, data_root=cfg["data_root"],
            test_area=cfg.get("test_area", 5),
            voxel_size=cfg.get("voxel_size", 0.04), voxel_max=voxel_max,
            transform=tfm, shuffle_index=True,
            loop=cfg.get("loop", 1) if split == "train" else 1)
    if name == "scannetv2":
        return Scannetv2(
            split="train" if split == "train" else "val",
            data_root=cfg["data_root"],
            voxel_size=cfg.get("voxel_size", 0.02), voxel_max=voxel_max,
            transform=tfm, shuffle_index=True,
            loop=cfg.get("loop", 1) if split == "train" else 1)
    if name == "dcf":
        roots = cfg["data_root"]
        return DCF(
            split=split,
            data_root=[roots] if isinstance(roots, str) else roots,
            voxel_size=cfg.get("voxel_size", 0.04),
            sigma=cfg.get("noise_sigma", 0.02), voxel_max=voxel_max,
            shuffle_index=True)
    if name == "synthetic":
        return SyntheticRooms(
            num_scenes=int(cfg.get("synthetic_scenes", 32)),
            points=int(cfg.get("synthetic_points", 40000)),
            voxel_size=cfg.get("voxel_size", 0.04), voxel_max=voxel_max,
            num_classes=int(cfg.get("classes", 13)), transform=tfm,
            seed=0 if split == "train" else 10_000, split=split,
            with_shift=bool(cfg.get("with_regressor", False)))
    raise ValueError(name)


class BatchLoader:
    """Batches of ``cfg.num_scenes`` scenes of ``dataset`` per epoch
    (``train.py:164-302``), in an order shuffled by ``seed`` (the same
    order every epoch) or in dataset order.

    Data parallel (``rank`` of ``world`` ranks, ``cfg`` the per-rank
    configuration of ``config.from_cfg(..., world)``): a batch is
    ``cfg.num_scenes * world`` scenes of the order, every rank iterates the
    same ``len(dataset) // (num_scenes * world)`` batches, and rank r builds
    the r-th ``num_scenes`` of each, as the JAX loader's device r
    (``train.py:164-200``). With ``world`` 1 this is the one-device loader.

    ``yaml_cfg`` keys: ``prefetch`` (default true) builds the batches ahead
    in ``prefetch_workers`` threads (default 2), worker ``w`` building
    batches ``w, w + W, ...`` into its own queue of 2 and the consumer
    reading the queues in turn, so the order equals the synchronous
    loader's; ``mix3d`` merges consecutive scene pairs of a training batch
    with that probability, drawn once per rank's share of a batch (``world``
    draws per batch, in rank order, the r-th deciding rank r's) from
    ``seed + 101`` (one worker then, so the draws keep their order);
    ``host_pyramid`` (default true) ships the geometry pyramid with a
    ``grid``-sampler batch, else the model builds it on the device;
    ``ignore_label``. ``compress_payload`` is accepted and ignored: integer
    arrays travel as int64.
    """

    def __init__(self, dataset, cfg, yaml_cfg, shuffle, seed=0, rank=0,
                 world=1):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} of {world} ranks")
        self.dataset = dataset
        self.cfg = cfg
        self.yaml_cfg = yaml_cfg
        self.shuffle = shuffle
        self.seed = seed
        self.rank, self.world = rank, world
        self.scenes_per_batch = cfg.num_scenes * world
        self.batches_per_epoch = max(len(dataset) // self.scenes_per_batch, 1)
        self.mix3d_p = float(yaml_cfg.get("mix3d", 0.0)) if shuffle else 0.0
        self._mix_rng = np.random.default_rng(seed + 101)

    def make_batch(self, scene_ids):
        """This rank's host batch of the batch of scenes ``scene_ids``
        (``scenes_per_batch`` of them; the rank's ``num_scenes``-slice):
        ``feats/xyz/offsets/labels``, ``stem_nidx/stem_nmask`` and, for the
        grid sampler with ``host_pyramid``, the ``pyramid``."""
        cfg = self.cfg
        spd = cfg.num_scenes
        ids = scene_ids[self.rank * spd:(self.rank + 1) * spd]
        scenes = [self.dataset[i] for i in ids]
        if self.mix3d_p > 0:
            draws = self._mix_rng.random(self.world)
            if draws[self.rank] <= self.mix3d_p:
                scenes = mix3d_pairs(scenes)
        if cfg.concat_xyz:
            scenes = [with_xyz_concat(s) for s in scenes]
        b = collate_scenes(scenes, cfg.n_pad, cfg.num_scenes,
                           ignore_label=int(self.yaml_cfg.get("ignore_label",
                                                              255)))
        return finish_batch(b, cfg, pyramid=bool(
            self.yaml_cfg.get("host_pyramid", True)) and cfg.sampler == "grid")

    def init_batch(self):
        """This rank's share of the batch the JAX driver initialises its
        model from (``train.py:426``: the first ``scenes_per_batch`` items).
        The JAX loader builds every device's share, which visits each of
        those items once; this rank reads the other ranks' items too, so
        that the datasets' per-item visit counters (the augmentation draws
        of the items it reads later) stay equal to the JAX loader's."""
        ids = list(range(self.scenes_per_batch))
        spd = self.cfg.num_scenes
        for i in ids[:self.rank * spd] + ids[(self.rank + 1) * spd:]:
            self.dataset[i]
        return self.make_batch(ids)

    def _ids(self, order, bi):
        return order[bi * self.scenes_per_batch:
                     (bi + 1) * self.scenes_per_batch]

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(order)
        if not bool(self.yaml_cfg.get("prefetch", True)):
            for bi in range(self.batches_per_epoch):
                yield self.make_batch(self._ids(order, bi))
            return
        n_workers = max(int(self.yaml_cfg.get("prefetch_workers", 2)), 1)
        if self.mix3d_p > 0:
            n_workers = 1
        queues = [queue.Queue(maxsize=2) for _ in range(n_workers)]
        stop = threading.Event()

        def worker(w):
            for bi in range(w, self.batches_per_epoch, n_workers):
                try:
                    item = self.make_batch(self._ids(order, bi))
                except BaseException as e:      # the consumer raises it
                    item = e
                while not stop.is_set():
                    try:
                        queues[w].put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set() or isinstance(item, BaseException):
                    return

        threads = [threading.Thread(target=worker, args=(w,), daemon=True,
                                    name=f"BatchLoader-{w}")
                   for w in range(n_workers)]
        for t in threads:
            t.start()
        try:
            for bi in range(self.batches_per_epoch):
                item = queues[bi % n_workers].get()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            for t in threads:
                t.join()


def finish_batch(b, cfg, pyramid=True):
    """The host batch of the collated `PaddedBatch` ``b``: its
    ``feats/xyz/offsets/labels`` (and ``target_shift`` where ``b`` has
    one), the KPConv stem's radius neighbours ``stem_nidx/stem_nmask`` and,
    with ``pyramid``, the geometry ``pyramid``."""
    b = with_stem_neighbors(b, radius=2.5 * cfg.grid_size * cfg.sigma,
                            k=cfg.max_num_neighbors)
    batch = {"feats": b.feats, "xyz": b.xyz, "offsets": b.offsets,
             "labels": b.labels, "stem_nidx": b.stem_nidx,
             "stem_nmask": b.stem_nmask}
    if pyramid:
        batch["pyramid"] = build_geometry_pyramid(b.xyz, b.offsets, cfg)
    if b.target_shift is not None:
        batch["target_shift"] = b.target_shift
    return batch


def example_batch(n_pad, num_scenes, seed=0, transform=None,
                  transform_rng=None, *, ignore_label=255, voxel_size=0.04,
                  extent=4.0, points=None, voxel_max=None):
    """The JAX package's ``__graft_entry__._example_batch``: synthetic rooms
    of ``extent`` metres over-sampled ~28% so that after voxel dedup at
    ``voxel_size`` each scene still fills its ``n_pad // num_scenes`` quota
    (or ``points`` per room, cropped to ``voxel_max``); ``transform``
    augments each scene, drawing from ``transform_rng``; pad rows take
    ``ignore_label``."""
    ds = SyntheticRooms(
        num_scenes=num_scenes,
        points=points or max(int(n_pad // num_scenes * 1.28), 512),
        extent=extent, voxel_size=voxel_size,
        voxel_max=voxel_max or n_pad // num_scenes,
        seed=seed, transform=transform, transform_rng=transform_rng)
    scenes = [with_xyz_concat(ds[i]) for i in range(num_scenes)]
    return collate_scenes(scenes, n_pad, num_scenes,
                          ignore_label=ignore_label)


def host_batch(cfg, seed=0, ignore_label=255, *, train=False, rng=None,
               aug=None, voxel_size=0.04, extent=4.0, points=None,
               voxel_max=None):
    """Numpy batch for `cfg`: ``feats/xyz/offsets/labels``, the stem
    neighbours ``stem_nidx/stem_nmask`` and the ``pyramid``; the rooms and
    the pad label as `example_batch` makes them.

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
    return finish_batch(example_batch(
        cfg.n_pad, cfg.num_scenes, seed=seed, transform=transform,
        transform_rng=rng, ignore_label=ignore_label, voxel_size=voxel_size,
        extent=extent, points=points, voxel_max=voxel_max), cfg)


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
