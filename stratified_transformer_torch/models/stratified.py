"""The Stratified Transformer segmentation model (the JAX package's
``models/stratified.py``; reference ``model/stratified_transformer.py:
398-502``).

KPConv stem, U-Net encoder of `BasicLayer` stages with stratified window
attention, ``TransitionDown``/``Upsample`` pyramid, classifier head. With
``stem_transformer`` False (the ScanNet family) a residual KPConv block
follows the stem, the stem's level is a skip level only, and the
``stem_down`` TransitionDown leads to the first transformer stage, stage 1
(``models/stratified.py:312-351`` of the JAX package). Flat
``[N_pad]`` arrays + cumulative ``offsets``; per-stage attention plans are
built once per shift parity and shared across the stage's blocks. The stem
radius neighbours and the geometry pyramid (sample indices, kNN graphs,
3-NN upsample indices, stratified member masks) arrive with a host batch
(``data/loader.py::host_batch``) or, when absent, are computed on the
device from the coordinates alone (`stem_neighbors`, `geometry_pyramid`),
as whole-scene evaluation runs the model. With ``with_regressor`` (the DCF
family) an offset head beside the classifier regresses a 3-vector per
point (``models/stratified.py:410-416``). In training mode the BatchNorms
use batch statistics and the blocks drop-path with the rates of
``StratifiedConfig.drop_path_schedule``.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from stratified_transformer_torch.config import StratifiedConfig
from stratified_transformer_torch.device import resolve_device
from stratified_transformer_torch.models.attention import Block
from stratified_transformer_torch.models.kpconv import (
    KPConv, KPConvResBlock, KPConvSimpleBlock)
from stratified_transformer_torch.models.layers import (
    MaskedBatchNorm, TransitionDown, Upsample)
from stratified_transformer_torch.ops import neighbors, sampling
from stratified_transformer_torch.ops.plan import build_attention_plan
from stratified_transformer_torch.utils import trace


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def stem_neighbors(cfg: StratifiedConfig, xyz, offsets, anchor=None):
    """The KPConv stem's radius neighbours on the device
    (``models/stratified.py:302-307`` of the JAX package): up to
    ``max_num_neighbors`` within ``2.5 grid_size sigma``, the cell list
    anchored at ``anchor`` when given. Returns ``(idx [N, K] int64, mask
    [N, K])``."""
    n = xyz.shape[0]
    batch = sampling.offsets_to_batch(offsets, n)
    idx, mask = neighbors.radius_neighbors(
        xyz, batch, xyz, batch, sampling.offsets_to_valid(offsets, n),
        2.5 * cfg.grid_size * cfg.sigma, cfg.max_num_neighbors,
        chunk=cfg.knn_chunk, method=cfg.neighbor_method,
        cap=cfg.neighbor_cap, grid_chunk=cfg.grid_knn_chunk, origin=anchor)
    return idx.long(), mask


def _stage_members(cfg, stage, xyz, offsets, anchor=None):
    """The stratified members (far keys) of one stage, as a mask over its
    points (``models/stratified.py:196-218``). A slot of the sampler that
    is not valid sets nothing, as in the host pyramid: the JAX package
    scatters the padding slots' False too, and where such a slot aliases a
    scene's first point that point can lose its membership."""
    n = xyz.shape[0]
    counts = offsets - sampling.scene_starts(offsets)
    d_offsets = sampling.counts_to_offsets(sampling.floor_ratio_counts(
        counts, 1.0 / cfg.downsample_scale))
    d_pad = n // cfg.downsample_scale + cfg.num_scenes
    if cfg.sampler == "grid":
        cell = cfg.grid_sizes()[stage] * float(cfg.downsample_scale) ** 0.5
        if cfg.down_quota == "cells":
            d_idx, d_valid, _ = sampling.grid_pool_sampling_all(
                xyz, offsets, d_pad, cell, origin=anchor)
        else:
            d_idx, d_valid = sampling.grid_pool_sampling(
                xyz, offsets, d_offsets, d_pad, cell, origin=anchor)
    elif cfg.sampler == "blocked_fps":
        d_idx, d_valid = sampling.blocked_fps(
            xyz, offsets, d_offsets, d_pad, cfg.window_sizes()[stage] * 4.0)
    else:
        d_idx, d_valid = sampling.farthest_point_sampling(
            xyz, offsets, d_offsets, d_pad)
    is_down = torch.zeros(n + 1, dtype=torch.bool, device=xyz.device)
    is_down[torch.where(d_valid, d_idx.long(), n)] = True
    return is_down[:n]


def _down_level(cfg, stage, xyz, offsets, anchor=None):
    """One ``TransitionDown`` level (``models/layers.py:163-208``): sample
    indices, their offsets and the kNN graph of the samples against the
    level's points."""
    n = xyz.shape[0]
    out_pad = _round_up(int(n * cfg.ratio) + cfg.num_scenes, cfg.tile)
    grid_cell = cfg.grid_sizes()[stage] * 2.0
    counts = offsets - sampling.scene_starts(offsets)
    new_offsets = sampling.counts_to_offsets(
        sampling.floor_ratio_counts(counts, cfg.ratio))
    if cfg.sampler == "grid" and cfg.down_quota == "cells":
        idx, valid, new_offsets = sampling.grid_pool_sampling_all(
            xyz, offsets, out_pad, grid_cell, origin=anchor)
    elif cfg.sampler == "grid":
        idx, valid = sampling.grid_pool_sampling(
            xyz, offsets, new_offsets, out_pad, grid_cell, origin=anchor)
    elif cfg.sampler == "blocked_fps":
        idx, valid = sampling.blocked_fps(
            xyz, offsets, new_offsets, out_pad, max(grid_cell * 8.0, 1e-3))
    else:
        idx, valid = sampling.farthest_point_sampling(
            xyz, offsets, new_offsets, out_pad)
    idx = idx.long()
    args = (xyz[idx], sampling.offsets_to_batch(new_offsets, out_pad), xyz,
            sampling.offsets_to_batch(offsets, n),
            sampling.offsets_to_valid(offsets, n), cfg.k)
    if cfg.neighbor_method == "grid":
        knn_idx, _, knn_mask = neighbors.grid_knn(
            *args, cell=cfg.grid_sizes()[stage] * 3.0, cap=cfg.neighbor_cap,
            query_valid=valid, chunk=cfg.grid_knn_chunk, origin=anchor)
    else:
        knn_idx, _, knn_mask = neighbors.knn(*args, query_valid=valid)
    return {"idx": idx, "valid": valid, "offsets": new_offsets,
            "knn_idx": knn_idx.long(), "knn_mask": knn_mask}


def _up_level(cfg, fine_stage, fine_xyz, fine_offsets, xyz, offsets,
              anchor=None):
    """One ``Upsample`` level's 3-NN of the fine points among the coarse
    ones (``models/layers.py:237-247``)."""
    n, n_fine = xyz.shape[0], fine_xyz.shape[0]
    args = (fine_xyz, sampling.offsets_to_batch(fine_offsets, n_fine), xyz,
            sampling.offsets_to_batch(offsets, n),
            sampling.offsets_to_valid(offsets, n), 3)
    fine_valid = sampling.offsets_to_valid(fine_offsets, n_fine)
    if cfg.neighbor_method == "grid":
        idx, _, mask = neighbors.grid_knn(
            *args, cell=cfg.grid_sizes()[fine_stage] * 6.0,
            cap=cfg.neighbor_cap, query_valid=fine_valid,
            chunk=cfg.grid_knn_chunk, origin=anchor)
    else:
        idx, _, mask = neighbors.knn(*args, query_valid=fine_valid)
    return {"idx": idx.long(), "mask": mask}


def geometry_pyramid(cfg: StratifiedConfig, xyz, offsets, anchor=None):
    """The geometry pyramid computed on ``xyz``'s device, in the host
    pyramid's layout (``data/pyramid.py::build_geometry_pyramid``): the
    samplers and neighbour searches that the JAX package's model runs
    inside ``BasicLayer``, ``TransitionDown`` (``stem_down`` included) and
    ``Upsample`` when it gets no pyramid; member masks for the transformer
    stages only, and none without stratified keys (``use_stratified``
    False, ``models/stratified.py:191-218``). They read the coordinates and
    offsets alone, so they run before the first layer. ``anchor``
    (``[3]``): the origin of every sampling grid and cell list, as the
    model's."""
    levels = [(xyz, offsets)]
    down, stage_down = [], []
    for i in range(cfg.num_layers):
        cur_xyz, cur_off = levels[-1]
        if i >= cfg.layer_start and cfg.use_stratified:
            stage_down.append({"is_down": _stage_members(
                cfg, i, cur_xyz, cur_off, anchor)})
        if i < cfg.num_layers - 1:
            level = _down_level(cfg, i, cur_xyz, cur_off, anchor)
            down.append(level)
            levels.append((cur_xyz[level["idx"]], level["offsets"]))
    up = [_up_level(cfg, j - 1, *levels[j - 1], *levels[j], anchor)
          for j in range(cfg.num_layers - 1, 0, -1)]
    return {"down": tuple(down), "up": tuple(up),
            "stage_down": tuple(stage_down)}


class BasicLayer(nn.Module):
    """One encoder stage: two plans + depth x Block (reference :250-326).
    Without stratified keys (``use_stratified`` False) the plans hold no
    far-key layout, and the odd blocks, on the shifted plan, take the
    shift ``window / 2`` for Swin3D's quantized positions
    (``models/stratified.py:219-248`` of the JAX package)."""

    def __init__(self, cfg: StratifiedConfig, stage: int):
        super().__init__()
        self.cfg = cfg
        self.stage = stage
        i = stage
        rates = cfg.drop_path_schedule()[sum(cfg.depths[:i]):]
        ws = cfg.window_sizes()[i]
        for b in range(cfg.depths[i]):
            self.add_module(f"blocks_{b}", Block(
                cfg.channels[i], cfg.num_heads[i], ws,
                cfg.quant_sizes()[i], band=cfg.stage_band(i), tile=cfg.tile,
                s_band=cfg.s_band, mlp_ratio=cfg.mlp_ratio,
                rel_query=cfg.rel_query, rel_key=cfg.rel_key,
                rel_value=cfg.rel_value,
                plain=cfg.attn_impl == "reference",
                drop_path_rate=rates[b], fast=cfg.fast,
                dtype=(torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                       else None),
                rpe_mode=cfg.rpe_mode,
                shift_size=ws / 2.0 if b % 2 else 0.0))

    def forward(self, feats, xyz, offsets, is_down, generator=None,
                anchor=None):
        """``is_down``: the stage's member mask (None without stratified
        keys); ``anchor``: the plans' window-grid origin (None: the batch
        min)."""
        cfg = self.cfg
        n = xyz.shape[0]
        batch = sampling.offsets_to_batch(offsets, n)
        valid = sampling.offsets_to_valid(offsets, n)
        d_pad = n // cfg.downsample_scale + cfg.num_scenes
        if not cfg.use_stratified:
            is_down = None
        with trace.span(f"st.stage{self.stage}.plan"):
            plans = [
                build_attention_plan(
                    xyz, batch, valid, cfg.window_sizes()[self.stage],
                    shifted=bool(parity), is_down=is_down,
                    sparse_cap=cfg.sparse_cap,
                    aux_pad=_round_up(d_pad, 128) if is_down is not None
                    else None, anchor=anchor)
                for parity in (0, 1)
            ]
        for b in range(cfg.depths[self.stage]):
            with trace.span(f"st.stage{self.stage}.block{b}"):
                feats = getattr(self, f"blocks_{b}")(feats, plans[b % 2],
                                                      generator)
        return feats


def down_name(cfg: StratifiedConfig, i):
    """The module name of the TransitionDown out of level ``i``: the flax
    names, ``stem_down`` out of the skip level, else ``down_<i>``."""
    return "stem_down" if i < cfg.layer_start else f"down_{i}"


class Stratified(nn.Module):
    def __init__(self, cfg: StratifiedConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.channels
        sync = cfg.bn_axis_name is not None
        self.stem_0 = KPConvSimpleBlock(cfg.in_channels, c[0],
                                        cfg.grid_size * cfg.sigma, sync=sync)
        if not cfg.stem_transformer:
            self.stem_1 = KPConvResBlock(c[0], c[0],
                                         cfg.grid_size * cfg.sigma, sync=sync)
        for i in range(cfg.num_layers):
            if i >= cfg.layer_start:
                self.add_module(f"layer_{i}", BasicLayer(cfg, i))
            if i < cfg.num_layers - 1:
                self.add_module(down_name(cfg, i),
                                TransitionDown(c[i], c[i + 1]))
        for j in range(cfg.num_layers - 1):
            fine = cfg.num_layers - 2 - j
            self.add_module(f"up_{j}", Upsample(c[fine + 1], c[fine]))
        self.cls_fc1 = nn.Linear(c[0], c[0])
        self.cls_bn = MaskedBatchNorm(c[0], sync=sync)
        self.cls_fc2 = nn.Linear(c[0], cfg.num_classes)
        if cfg.with_regressor:
            self.reg_fc1 = nn.Linear(c[0], c[0])
            self.reg_bn = MaskedBatchNorm(c[0], sync=sync)
            self.reg_fc2 = nn.Linear(c[0], 3)

    def forward(self, feats, xyz, offsets, *, stem_nidx=None,
                stem_nmask=None, pyramid=None, generator=None, anchor=None):
        """feats ``[N_pad, C_in]``, xyz ``[N_pad, 3]``, offsets ``[B]``;
        stem_nidx/stem_nmask ``[N_pad, K]`` the stem's radius neighbours and
        pyramid the geometry pyramid, from the host, or computed on the
        device when None (`stem_neighbors`, `geometry_pyramid`);
        ``generator`` (a ``torch.Generator`` on the model's device) draws
        the drop-path masks in training mode; ``anchor`` (``[3]``) is the
        origin of every window grid, sampling grid and cell list the
        forward builds (None: each is anchored at its batch min, as the
        reference's ``xyz.min(0)``): sharded inference passes the scene's
        anchor so that its spatial blocks share one grid
        (`parallel.halo`). Returns ``(logits [N_pad,
        classes], shift)``: ``shift [N_pad, 3]`` from the offset head with
        ``with_regressor``, else None."""
        cfg = self.cfg
        n = xyz.shape[0]
        if n % cfg.tile:
            raise ValueError(f"n_pad {n} must be a multiple of tile {cfg.tile}")
        if stem_nidx is None:
            with trace.span("st.geometry.stem"):
                stem_nidx, stem_nmask = stem_neighbors(cfg, xyz, offsets,
                                                       anchor)
        if pyramid is None:
            with trace.span("st.geometry.pyramid"):
                pyramid = geometry_pyramid(cfg, xyz, offsets, anchor)
        valid = sampling.offsets_to_valid(offsets, n)
        with trace.span("st.stem"):
            feats = self.stem_0(feats, xyz, stem_nidx, stem_nmask, valid)
            if not cfg.stem_transformer:
                feats = self.stem_1(feats, xyz, stem_nidx, stem_nmask, valid)

        stack = []
        for i in range(cfg.num_layers):
            if i >= cfg.layer_start:
                is_down = (pyramid["stage_down"][i - cfg.layer_start]
                           ["is_down"] if cfg.use_stratified else None)
                with trace.span(f"st.stage{i}"):
                    feats = getattr(self, f"layer_{i}")(
                        feats, xyz, offsets, is_down, generator, anchor)
            stack.append((feats, xyz, offsets))
            if i < cfg.num_layers - 1:
                with trace.span(f"st.down{i}"):
                    feats, xyz, offsets = getattr(self, down_name(cfg, i))(
                        feats, xyz, pyramid["down"][i])

        feats, xyz, offsets = stack.pop()
        for j in range(cfg.num_layers - 1):
            skip_feats, skip_xyz, offsets = stack.pop()
            with trace.span(f"st.up{j}"):
                feats = getattr(self, f"up_{j}")(
                    feats, xyz, skip_feats, skip_xyz, pyramid["up"][j])
            xyz = skip_xyz

        with trace.span("st.head"):
            valid0 = sampling.offsets_to_valid(offsets, xyz.shape[0])
            h = F.relu(self.cls_bn(self.cls_fc1(feats), valid0))
            shift = None
            if cfg.with_regressor:
                g = self.reg_bn(self.reg_fc1(feats), valid0)
                g = torch.tanh(g) if cfg.activation == "Tanh" else F.relu(g)
                shift = self.reg_fc2(g)
            return self.cls_fc2(h), shift


def _trunc_normal_(t, std, gen):
    """Normal(0, std) truncated to +-2 std (flax ``truncated_normal``)."""
    z = torch.randn(t.shape, generator=gen)
    bad = z.abs() > 2.0
    while bad.any():
        z[bad] = torch.randn(int(bad.sum()), generator=gen)
        bad = z.abs() > 2.0
    t.copy_(z * std)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0):
    """The JAX package's initialisers, drawn from ``torch.Generator(seed)``:
    trunc-normal(0.02) Linear weights and cRPE tables, zero biases, unit
    norms, He-uniform KPConv weights, BN statistics (0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            _trunc_normal_(mod.weight, 0.02, gen)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, MaskedBatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, KPConv):
            w = mod.kernel_weights
            fan_in = w.shape[0] * w.shape[1]
            limit = math.sqrt(6.0 / fan_in)
            w.copy_(torch.rand(w.shape, generator=gen) * 2 * limit - limit)
    for name, p in model.named_parameters():
        if name.endswith("_table"):
            _trunc_normal_(p, 0.02, gen)


def build_model(cfg: StratifiedConfig, device="cuda", seed=0,
                train=False) -> Stratified:
    """A `Stratified` with weights from ``seed`` on ``device``, in eval mode
    or, with ``train=True``, in training mode."""
    dev = resolve_device(device)
    model = Stratified(cfg)
    init_weights(model, seed)
    return model.to(dev).train(train)
