"""Static model / shape configuration of the Stratified Transformer.

Field names and derived hyper-parameters follow the JAX package's
``StratifiedConfig`` so that one YAML file drives both. Derived values follow
the reference ``train.py:110-113``: ``patch = grid_size * patch_size``;
``window[i] = patch * window * 2**i``; ``grid[i] = patch * 2**i``;
``quant[i] = quant_size * 2**i``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import numpy as np



@dataclasses.dataclass(frozen=True)
class StratifiedConfig:
    num_classes: int = 13
    in_channels: int = 6                      # colors (+xyz if concat_xyz)
    channels: Tuple[int, ...] = (48, 96, 192, 384)
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    num_layers: int = 4
    window_size: float = 4.0
    patch_size: float = 1.0
    grid_size: float = 0.04
    quant_size: float = 0.01
    downsample_scale: int = 8
    rel_query: bool = True
    rel_key: bool = True
    rel_value: bool = True
    drop_path_rate: float = 0.3
    concat_xyz: bool = True
    # True: the KPConv stem feeds transformer stage 0 (S3DIS); False: a
    # second, residual KPConv block and a TransitionDown follow the stem,
    # its level is only a skip, and the stages run from 1 (ScanNet)
    stem_transformer: bool = True
    up_k: int = 3
    ratio: float = 0.25
    k: int = 16
    sigma: float = 1.0
    max_num_neighbors: int = 34
    mlp_ratio: float = 4.0
    # the DCF family's per-point offset head (3-vector regression) and its
    # activation, "Relu" or "Tanh"
    with_regressor: bool = False
    activation: str = "Relu"
    # False: plain windows without stratified far keys (no member masks, no
    # sparse layout; the Swin3D family); rpe_mode "swin_window": Swin3D's
    # window-quantized cRPE bins over 2*int(window/quant) - 1 table rows
    # (``models/attention.py:57-109`` of the JAX package), which needs
    # use_stratified False
    use_stratified: bool = True
    rpe_mode: str = "stratified"

    # static layout
    n_pad: int = 140_000                      # flat point capacity
    num_scenes: int = 8                       # static batch capacity
    band: int = 128                           # one-sided dense band width
    band_per_stage: Optional[Tuple[int, ...]] = None
    tile: int = 128                           # attention query tile
    sparse_cap: int = 48                      # sparse keys per large window
    s_band: int = 128                         # sparse aux window per tile
    # on-device sampling and neighbour search (a batch without the host
    # pyramid, as whole-scene evaluation runs it): the stratified members'
    # and TransitionDown's sampler ("grid" | "fps" | "blocked_fps"), the
    # grid sampler's count policy ("scene": floor(n * ratio) + 1 per scene;
    # "cells": every occupied cell), and the neighbour search ("grid" cell
    # list | "brute") with its per-cell capacity and query chunks
    sampler: str = "grid"
    down_quota: str = "scene"
    knn_chunk: int = 1024
    neighbor_method: str = "grid"
    neighbor_cap: int = 32
    grid_knn_chunk: Optional[int] = 4096
    # "fused": the CUDA kernels on the card (their plain versions on the
    # CPU); "reference": the plain PyTorch versions on any device.
    attn_impl: str = "fused"
    # the YAML's precision keys (``train.py:105-107`` of the JAX package):
    # with both precisions "default" the four attention kernels run their
    # bf16 forms (`fast`; every shipped YAML sets both); "highest" is fp32
    # throughout. ``compute_dtype`` "bfloat16" runs the blocks' qkv, proj,
    # fc1 and fc2 products in bf16 with fp32 parameters.
    rpe_precision: str = "highest"
    qk_precision: str = "highest"
    compute_dtype: Optional[str] = None
    # SyncBN, named as the JAX package names its mesh axis: "data" sums
    # every `MaskedBatchNorm`'s training statistics over the data-parallel
    # ranks (the default process group); None keeps them per rank
    bn_axis_name: Optional[str] = None

    # Accepted for config compatibility with the JAX package and ignored:
    # they size Mosaic programs and XLA maps, which the port does not have.
    # Every stage runs through the kernels whatever ``fused_stages`` says.
    fused_stages: int = 3
    head_group: int = 6
    tile_batch: int = 16
    attn_remat: str = "full"
    pallas_interpret: bool = False

    def __post_init__(self):
        for name, allowed in (("attn_impl", ("fused", "reference")),
                              ("sampler", ("grid", "fps", "blocked_fps")),
                              ("down_quota", ("scene", "cells")),
                              ("neighbor_method", ("grid", "brute")),
                              ("activation", ("Relu", "Tanh")),
                              ("rpe_precision", ("highest", "default")),
                              ("qk_precision", ("highest", "default")),
                              ("compute_dtype", (None, "bfloat16")),
                              ("bn_axis_name", (None, "data")),
                              ("rpe_mode", ("stratified", "swin_window"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} {getattr(self, name)!r}: expected "
                                 f"one of {allowed}")
        if self.use_stratified and self.rpe_mode == "swin_window":
            # the JAX package asserts the same (ops/attention.py:461-465)
            raise ValueError("rpe_mode 'swin_window' is window-dense only: "
                             "it needs use_stratified False")

    @property
    def fast(self) -> bool:
        """The attention kernels' bf16 forms: both precisions "default"
        (``ops/attention_fused.py:229`` of the JAX package); one "highest"
        keeps them fp32."""
        return self.rpe_precision == "default" and self.qk_precision == "default"

    # -------- derived (reference train.py:110-113) --------
    @property
    def patch(self) -> float:
        return self.grid_size * self.patch_size

    def window_sizes(self):
        return [self.patch * self.window_size * 2 ** i
                for i in range(self.num_layers)]

    def grid_sizes(self):
        return [self.patch * 2 ** i for i in range(self.num_layers)]

    def quant_sizes(self):
        return [self.quant_size * 2 ** i for i in range(self.num_layers)]

    @property
    def layer_start(self) -> int:
        """The first transformer stage."""
        return 0 if self.stem_transformer else 1

    def stage_caps(self):
        """Static point capacity of each level 0..num_layers-1: the input,
        then ``int(n * ratio) + num_scenes`` per TransitionDown
        (``models/stratified.py:153-163`` of the JAX package)."""
        caps = [self.n_pad]
        for _ in range(1, self.num_layers):
            caps.append(int(caps[-1] * self.ratio) + self.num_scenes)
        return caps

    def drop_path_schedule(self):
        """Drop-path rate of each block in global order,
        ``linspace(0, rate, sum(depths))`` (``models/stratified.py:165-168``);
        block ``b`` of stage ``i`` takes entry ``sum(depths[:i]) + b``."""
        return [float(x) for x in
                np.linspace(0.0, self.drop_path_rate, sum(self.depths))]

    def stage_band(self, i):
        return (self.band_per_stage[i] if self.band_per_stage is not None
                else self.band)


def from_cfg(cfg, n_devices: int = 1) -> StratifiedConfig:
    """`StratifiedConfig` from a flattened YAML config (same keys and
    defaults as ``train.py::build_model_config`` of the JAX package).
    ``arch: swin3d_transformer`` selects the Swin3D family
    (``use_stratified`` False, ``rpe_mode`` "swin_window"); explicit keys
    still win (``train.py:49-83``).

    ``n_devices`` D (data-parallel ranks) gives each rank's share of a
    batch (``train.py:32-41``): ``max_batch_points // D`` points rounded up
    to a tile and ``batch_size // D`` scenes (at least one tile and one
    scene), and SyncBN when D > 1 and ``sync_bn`` (default True,
    ``train.py:84-85``). D = 1 is the one-device configuration.

    ``attn_impl`` under ``rpe_mode: swin_window``: the JAX package has one
    implementation of that mode (``models/attention.py:100-109`` runs its
    jnp path whatever the key says), so the value selects nothing there,
    and the shipped Swin YAMLs say "reference". The port builds its main
    path, "fused" (the kernels on the card, their plain versions on the
    CPU), and logs one line saying so; a `StratifiedConfig` built with
    ``attn_impl="reference"`` still selects the plain versions."""
    swin = str(cfg.get("arch", "stratified_transformer")) == \
        "swin3d_transformer"
    rpe_mode = str(cfg.get("rpe_mode",
                           "swin_window" if swin else "stratified"))
    attn_impl = str(cfg.get("attn_impl", "fused"))
    if rpe_mode == "swin_window" and attn_impl != "fused":
        logging.getLogger("st_torch").info(
            f"attn_impl {attn_impl!r} under rpe_mode 'swin_window': the "
            "JAX package runs its one implementation of this mode whatever "
            "the key says; the port runs its main path, 'fused' (the CUDA "
            "kernels on the card, their plain versions on the CPU)")
        attn_impl = "fused"
    tile = int(cfg.get("tile", 128))
    n_pad = int(cfg.get("max_batch_points", 140000))
    d = max(int(n_devices), 1)
    n_pad = max((n_pad // d + tile - 1) // tile * tile, tile)
    fea_dim = int(cfg.get("fea_dim", 6))
    concat_xyz = bool(cfg.get("concat_xyz", True))
    return StratifiedConfig(
        num_classes=int(cfg.get("classes", 13)),
        in_channels=fea_dim if concat_xyz else fea_dim - 3,
        channels=tuple(cfg.get("channels")),
        depths=tuple(cfg.get("depths")),
        num_heads=tuple(cfg.get("num_heads")),
        num_layers=int(cfg.get("num_layers")),
        window_size=float(cfg.get("window_size", 4)),
        patch_size=float(cfg.get("patch_size", 1)),
        grid_size=float(cfg.get("grid_size", 0.04)),
        quant_size=float(cfg.get("quant_size", 0.01)),
        downsample_scale=int(cfg.get("downsample_scale", 8)),
        rel_query=bool(cfg.get("rel_query", True)),
        rel_key=bool(cfg.get("rel_key", True)),
        rel_value=bool(cfg.get("rel_value", True)),
        drop_path_rate=float(cfg.get("drop_path_rate", 0.3)),
        concat_xyz=concat_xyz,
        stem_transformer=bool(cfg.get("stem_transformer", True)),
        up_k=int(cfg.get("up_k", 3)),
        ratio=float(cfg.get("ratio", 0.25)),
        k=int(cfg.get("k", 16)),
        sigma=float(cfg.get("sigma", 1.0)),
        max_num_neighbors=int(cfg.get("max_num_neighbors", 34)),
        mlp_ratio=float(cfg.get("mlp_ratio", 4.0)),
        with_regressor=bool(cfg.get("with_regressor", False)),
        activation=str(cfg.get("activation", "Relu")),
        n_pad=n_pad,
        num_scenes=max(int(cfg.get("batch_size", 8)) // d, 1),
        band=int(cfg.get("band", 128)),
        band_per_stage=(tuple(int(x) for x in cfg.get("band_per_stage"))
                        if cfg.get("band_per_stage") else None),
        tile=tile,
        sparse_cap=int(cfg.get("sparse_cap", 48)),
        s_band=int(cfg.get("s_band", 128)),
        sampler=str(cfg.get("sampler", "grid")),
        down_quota=str(cfg.get("down_quota", "scene")),
        knn_chunk=int(cfg.get("knn_chunk", 1024)),
        neighbor_method=str(cfg.get("neighbor_method", "grid")),
        neighbor_cap=int(cfg.get("neighbor_cap", 32)),
        grid_knn_chunk=int(cfg.get("grid_knn_chunk", 4096)),
        use_stratified=bool(cfg.get("use_stratified", not swin)),
        rpe_mode=rpe_mode,
        attn_impl=attn_impl,
        rpe_precision=str(cfg.get("rpe_precision", "highest")),
        qk_precision=str(cfg.get("qk_precision", "highest")),
        compute_dtype=cfg.get("compute_dtype"),
        bn_axis_name="data" if d > 1 and bool(cfg.get("sync_bn", True))
        else None,
        fused_stages=int(cfg.get("fused_stages", 3)),
        head_group=int(cfg.get("head_group", 6)),
        tile_batch=int(cfg.get("tile_batch", 16)),
        attn_remat=str(cfg.get("attn_remat", "full")),
        pallas_interpret=bool(cfg.get("pallas_interpret", False)),
    )
