"""Sharded whole-scene inference: spatial slabs with receptive halos (the
JAX package's ``parallel/halo.py``).

A vote chunk of a scene is cut into ``D`` slabs of equal point count along
its longest horizontal axis, one per rank, and each slab is evaluated with
a halo of neighbouring points wide enough for the model's receptive field
(`receptive_halo`), so that each rank's forward is exact for its core
points where no static capacity of the layout binds. Every block's forward
anchors its grids at the chunk's own origin (``anchor=zeros(3)`` on
coordinates from which the chunk's min is subtracted), so all blocks share
one window grid.

Two data paths share the partition:

* `sharded_scene_probs`, host replication: each rank builds its block, core
  and halo, from the chunk on the host, truncating the deepest halo points
  first when the block exceeds its capacity;
* `sharded_scene_probs_collective`, the exchange: each rank uploads only
  its core slab, and the halo moves between the ranks over collectives,
  ``"ppermute"`` (each rank's two boundary bands, closest-first, to the
  adjacent ranks) or ``"allgather"`` (every core slab to every rank, which
  selects its own halo closest-first).

The JAX package drives a mesh from one process; here every rank runs the
same host code on the same chunk, so the partition, the exchange mode and
every fallback are decided alike on every rank, and the overflow counts
that only one rank sees are summed over the ranks before anything depends
on them. Both exchanges and the gather of the ranks' core probabilities
are sums of zero-filled buffers in which each rank fills its own rows
(`parallel.mesh.all_gather_rows`, `parallel.mesh.all_reduce_sum`): an
all-reduce, which NCCL and gloo both take on CUDA tensors (gloo takes
neither ``all_gather`` nor point-to-point on them). The one-hop exchange
therefore moves every rank's bands to every rank, and each keeps its
neighbours'.

Three behaviours of the JAX package are not mirrored:

* only a core slab beyond ``core_pad`` (`CoreSlabOverflow`) sends a chunk
  to host replication; any other error propagates (JAX falls back on any
  ``ValueError``, ``eval/voting.py:251-252``);
* an empty slab ships no core point (JAX's placeholder of
  `partition_scene` makes point 0 a core point of two ranks in its
  collective path, ``parallel/halo.py:99-103``);
* a chunk whose halo exceeds ``halo_cap`` raises `HaloCapOverflow` before
  its forward, and the caller re-runs it through host replication (JAX
  accepts it degraded and counts the dropped points).
"""

from __future__ import annotations

import numpy as np
import torch

from stratified_transformer_torch.ops.windows import put_drop
from stratified_transformer_torch.parallel.mesh import (
    all_gather_rows, all_reduce_sum, rank, world_size)

# the global index of the padding rows of a block: sorts after every point
PAD_INDEX = torch.iinfo(torch.int32).max
MODES = ("ppermute", "allgather")


class CoreSlabOverflow(ValueError):
    """A core slab of the collective path holds more points than
    ``core_pad``: the chunk goes to host replication, which truncates."""


class HaloCapOverflow(RuntimeError):
    """Halo points of the collective path beyond ``halo_cap`` (``dropped``,
    summed over the ranks): the chunk is re-run through host
    replication."""

    def __init__(self, dropped, halo_cap):
        super().__init__(f"{dropped} halo points beyond halo_cap {halo_cap}")
        self.dropped = dropped


def receptive_halo(cfg) -> float:
    """Receptive-field halo width along the slab axis of a
    `StratifiedConfig` (``parallel/halo.py:33-66``): a query reads its
    small window (``ws_i`` of axis reach) and its large window's far keys
    (``2 ws_i``), so each attention block of stage ``i`` adds ``2 ws_i``;
    each TransitionDown's kNN adds its cell list's reach ``2 * 3 g_i``, each
    Upsample's 3-NN ``2 * 6 g_i``, and the KPConv stem its ball radius. A
    hard bound for ``neighbor_method: grid``. Exactness needs
    ``down_quota: cells`` besides: a per-scene quota makes the sampled
    points depend on the block's point count."""
    ws = cfg.window_sizes()
    gs = cfg.grid_sizes()
    r = 2.5 * cfg.grid_size * cfg.sigma            # stem ball query
    for i in range(cfg.layer_start, cfg.num_layers):
        r += cfg.depths[i] * 2.0 * ws[i]           # attention hops
    if not cfg.stem_transformer:                   # stem TransitionDown
        r += 2.0 * (gs[0] * 3.0)
    for i in range(cfg.layer_start, cfg.num_layers - 1):
        r += 2.0 * (gs[i] * 3.0)                   # TransitionDown kNN
    for i in range(cfg.layer_start, cfg.num_layers - 1):
        r += 2.0 * (gs[i] * 6.0)                   # Upsample 3-NN
    if not cfg.stem_transformer:
        r += 2.0 * (gs[0] * 6.0)
    return r


def slab_edges(coord, n_blocks):
    """The slab axis (the longer horizontal extent) and the equal-count
    quantile edges, the outer two infinite (``parallel/halo.py:69-81``)."""
    coord = np.asarray(coord)
    extent = coord.max(0) - coord.min(0)
    axis = int(np.argmax(extent[:2])) if coord.shape[1] >= 2 else 0
    qs = np.quantile(coord[:, axis], np.linspace(0, 1, n_blocks + 1))
    qs[0], qs[-1] = -np.inf, np.inf
    return axis, qs


def partition_scene(coord, n_blocks, halo, min_points_per_block=1):
    """Slabs of `slab_edges` with their halos (``parallel/halo.py:84-
    111``): a list of ``{"idx": global indices of the block's points in
    ascending order, "core": bool mask over idx, "halo_depth": float32
    distance beyond the core slab}``. A block of fewer than
    ``min_points_per_block`` points holds the first points of the scene as
    a placeholder, none of them core."""
    coord = np.asarray(coord)
    axis, qs = slab_edges(coord, n_blocks)
    x = coord[:, axis]
    blocks = []
    for b in range(n_blocks):
        lo, hi = qs[b], qs[b + 1]
        core = (x >= lo) & (x < hi)
        with_halo = (x >= lo - halo) & (x < hi + halo)
        idx = np.where(with_halo)[0]
        if len(idx) < min_points_per_block:
            idx = np.arange(min(len(coord), min_points_per_block))
            blocks.append({"idx": idx,
                           "core": np.zeros(len(idx), bool),
                           "halo_depth": np.zeros(len(idx), np.float32)})
            continue
        xd = x[idx]
        depth = np.maximum(np.maximum(lo - xd, xd - hi), 0.0)
        blocks.append({"idx": idx, "core": core[idx],
                       "halo_depth": depth.astype(np.float32)})
    return blocks


def exchange_mode(qs, halo):
    """``"ppermute"`` when the halo cannot reach past the adjacent slab
    (every interior slab at least ``halo`` wide; always at two ranks, which
    have no interior slab), else ``"allgather"``
    (``parallel/halo.py:329-333``)."""
    widths = np.diff(qs)[1:-1]
    return ("ppermute" if not len(widths) or halo <= widths.min()
            else "allgather")


def block_predict(model):
    """``predict(feats, xyz, offsets) -> probs`` on ``model``'s device: the
    softmax of one eval-mode forward of a block anchored at the origin (its
    coordinates arrive with the chunk's min subtracted)."""
    dev = next(model.parameters()).device
    anchor = torch.zeros(3, dtype=torch.float32, device=dev)

    @torch.inference_mode()
    def predict(feats, xyz, offsets):
        logits, _ = model(feats, xyz, offsets, anchor=anchor)
        return torch.softmax(logits, -1)

    return predict


def _block_inputs(c, f, concat_xyz, n_pad, device):
    """``(feats [n_pad, C], xyz [n_pad, 3])`` on ``device`` from a block's
    coordinates and features, zero rows after them."""
    fcat = np.concatenate([f, c], 1) if concat_xyz else f
    feats = np.zeros((n_pad, fcat.shape[1]), np.float32)
    xyz = np.zeros((n_pad, 3), np.float32)
    feats[:len(c)] = fcat
    xyz[:len(c)] = c
    return (torch.from_numpy(feats).to(device),
            torch.from_numpy(xyz).to(device))


def _gathered(out):
    """The chunk's probabilities assembled from every rank's core rows."""
    return all_reduce_sum(out).cpu().numpy().astype(np.float64)


def sharded_scene_probs(predict, coord, feat, num_classes, *, n_pad, device,
                        concat_xyz=True, halo=0.5, stats=None):
    """Host replication (``parallel/halo.py:384-464``): the chunk is cut
    into one block per rank (`partition_scene`), rank ``r`` evaluates block
    ``r`` at the flat capacity ``n_pad`` and the ranks' core probabilities
    are summed into every rank's result.

    ``predict(feats [n_pad, C], xyz [n_pad, 3], offsets [1])`` returns the
    block's probabilities on ``device`` (`block_predict`); ``coord`` /
    ``feat`` are the chunk's (features scaled). A block beyond ``n_pad``
    loses its deepest halo points first, never a core point, and keeps its
    points in global index order (the samplers' tie-breaks depend on it).
    ``stats`` gets ``truncated_halo_points`` (non-zero: the halo no longer
    covers the receptive field) and ``block_points``. Returns ``probs [N,
    num_classes]`` float64, the same on every rank."""
    d, r = world_size(), rank()
    coord = np.asarray(coord)
    blocks = partition_scene(coord, d, halo)
    kept, truncated = [], 0
    for blk in blocks:
        idx, core = blk["idx"], blk["core"]
        if len(idx) > n_pad:
            truncated += len(idx) - n_pad
            order = np.argsort(blk["halo_depth"], kind="stable")[:n_pad]
            order.sort()                        # back to global index order
            idx, core = idx[order], core[order]
        kept.append((idx, core))
    if stats is not None:
        stats["truncated_halo_points"] = truncated
        stats["block_points"] = [len(i) for i, _ in kept]

    out = torch.zeros((len(coord), num_classes), dtype=torch.float32,
                      device=device)
    idx, core = kept[r]
    if core.any():                  # a placeholder block has no core point
        # every block anchored at the chunk's min: one window grid
        c = np.asarray(coord[idx], np.float32) - np.asarray(
            coord.min(0), np.float32)
        feats, xyz = _block_inputs(c, np.asarray(feat[idx], np.float32),
                                   concat_xyz, n_pad, device)
        offsets = torch.tensor([len(idx)], dtype=torch.int64, device=device)
        probs = predict(feats, xyz, offsets)
        sel = torch.from_numpy(np.where(core)[0]).to(device)
        out[torch.from_numpy(idx).to(device)[sel]] = probs[sel].to(
            out.dtype)
    return _gathered(out)


def _closest(score, cap):
    """The ``cap`` rows of least finite ``score``, closest first (stable on
    ties, as ``jnp.argsort``), their validity and the finite rows beyond
    ``cap``."""
    order = torch.argsort(score, stable=True)[:cap]
    ok = torch.isfinite(score[order])
    if len(order) < cap:
        pad = cap - len(order)
        order = torch.cat([order, order.new_zeros(pad)])
        ok = torch.cat([ok, ok.new_zeros(pad)])
    dropped = (torch.isfinite(score).sum() - cap).clamp_min(0)
    return order, ok, dropped


def _pack(rows, gidx, ok):
    """One float64 tensor ``[..., F + 2]`` of rows with their global index
    and validity, exact (float32 rows, indices below 2**53): what the
    exchange carries, in one collective."""
    f64 = torch.float64
    return torch.cat([rows.to(f64), gidx.to(f64)[..., None],
                      ok.to(f64)[..., None]], -1)


def _unpack(packed):
    """`_pack`'s ``(rows float32, gidx int64, ok)``."""
    return (packed[..., :-2].to(torch.float32),
            packed[..., -2].to(torch.int64), packed[..., -1] > 0)


def _ppermute_halo(rows, gidx, valid, x, lo, hi, hw, halo_cap):
    """``"ppermute"`` (``parallel/halo.py:151-207``): each rank's left and
    right boundary bands (core points within ``hw`` of its edges), closest
    to the edge first, in ``[halo_cap]`` buffers, reach the adjacent ranks;
    a rank's halo is its left neighbour's right band and its right
    neighbour's left band. Returns ``(rows, gidx, ok, dropped)`` of the
    received halo."""
    inf = torch.full_like(x, float("inf"))
    bands = [
        _closest(torch.where(valid & (x < lo + hw), x - lo, inf), halo_cap),
        _closest(torch.where(valid & (x > hi - hw), hi - x, inf), halo_cap)]
    got = all_gather_rows(torch.stack(
        [_pack(rows[o], gidx[o], ok) for o, ok, _ in bands]))
    r, d = rank(), world_size()
    h_rows, h_gidx, h_ok = _unpack(torch.cat(
        [got[src, side] for src, side in ((r - 1, 1), (r + 1, 0))
         if 0 <= src < d] or [got[0, 0, :0]]))
    return h_rows, h_gidx, h_ok, bands[0][2] + bands[1][2]


def _allgather_halo(rows, gidx, valid, axis, lo, hi, hw, halo_cap):
    """``"allgather"`` (``parallel/halo.py:224-274``): every rank gathers
    every core slab and takes as its halo the other ranks' points within
    ``hw`` of its slab (depth 0, on its boundary, included), closest first,
    at most ``2 * halo_cap``. Returns ``(rows, gidx, ok, dropped)``."""
    all_rows, all_gidx, all_valid = _unpack(
        all_gather_rows(_pack(rows, gidx, valid)))     # [D, core_pad, ...]
    d, core_pad = all_gidx.shape
    xval = all_rows[..., axis]
    zero = torch.zeros((), dtype=xval.dtype, device=xval.device)
    depth = torch.maximum(torch.maximum(lo - xval, xval - hi), zero)
    me = torch.arange(d, device=xval.device)[:, None] == rank()
    cand = all_valid & ~me & (depth <= hw)
    score = torch.where(cand, depth, torch.full_like(depth, float("inf")))
    order, ok, dropped = _closest(score.reshape(-1), 2 * halo_cap)
    return (all_rows.reshape(d * core_pad, -1)[order],
            all_gidx.reshape(-1)[order], ok, dropped)


def sharded_scene_probs_collective(predict, coord, feat, num_classes, *,
                                   core_pad, halo_cap, device,
                                   concat_xyz=True, halo=0.5, stats=None,
                                   mode=None):
    """`sharded_scene_probs` with the halo exchanged over collectives
    (``parallel/halo.py:114-381``). Rank ``r`` uploads only its core slab
    (at most ``core_pad`` points); the halo arrives by the exchange
    ``mode`` (None: `exchange_mode`'s rule); the block, core then halo, is
    sorted by global index (the samplers' tie-breaks depend on point
    order), evaluated at ``core_pad + 2 * halo_cap`` rows, and the core
    rows' probabilities are summed into every rank's result. An empty slab
    ships no core point and runs no forward.

    Raises `CoreSlabOverflow` (before any collective) when a core slab
    exceeds ``core_pad``, and `HaloCapOverflow` (before the forward, every
    rank alike) when halo points exceed ``halo_cap``. ``stats`` gets
    ``halo_cap_dropped`` (summed over the ranks), ``block_points`` (each
    slab's core points) and ``collective_<mode>_scenes``. Returns ``probs
    [N, num_classes]`` float64, the same on every rank."""
    coord = np.asarray(coord, np.float32)
    coord0 = coord - coord.min(0)
    d, r = world_size(), rank()
    axis, qs = slab_edges(coord0, d)
    mode = mode or exchange_mode(qs, halo)
    if mode not in MODES:
        raise ValueError(f"exchange mode {mode!r}: expected one of {MODES}")
    cores = [blk["idx"][blk["core"]]
             for blk in partition_scene(coord0, d, halo=0.0)]
    for b, idx in enumerate(cores):
        if len(idx) > core_pad:
            raise CoreSlabOverflow(
                f"core slab {b} ({len(idx)} points) exceeds core_pad "
                f"{core_pad}: raise sharded_core_points")

    idx = cores[r]
    nc = len(idx)
    feats, xyz = _block_inputs(coord0[idx], np.asarray(feat[idx], np.float32),
                               concat_xyz, core_pad, device)
    rows = torch.cat([xyz, feats], 1)            # what the exchange carries
    gidx = torch.zeros(core_pad, dtype=torch.int64, device=device)
    gidx[:nc] = torch.from_numpy(idx).to(device)
    valid = torch.arange(core_pad, device=device) < nc
    bound = np.float32([qs[r] if np.isfinite(qs[r]) else -1e30,
                        qs[r + 1] if np.isfinite(qs[r + 1]) else 1e30])
    lo, hi = torch.from_numpy(bound).to(device)
    hw = torch.tensor(halo, dtype=torch.float32, device=device)
    if mode == "ppermute":
        h_rows, h_gidx, h_ok, dropped = _ppermute_halo(
            rows, gidx, valid, xyz[:, axis], lo, hi, hw, halo_cap)
    else:
        h_rows, h_gidx, h_ok, dropped = _allgather_halo(
            rows, gidx, valid, axis, lo, hi, hw, halo_cap)
    dropped = int(all_reduce_sum(dropped.reshape(1).to(torch.float64)))
    if stats is not None:
        stats["halo_cap_dropped"] = dropped
        stats["block_points"] = [len(i) for i in cores]
        key = f"collective_{mode}_scenes"
        stats[key] = stats.get(key, 0) + 1
    if dropped:
        raise HaloCapOverflow(dropped, halo_cap)

    out = torch.zeros((len(coord), num_classes), dtype=torch.float32,
                      device=device)
    if nc:
        # the block: core rows and the received halo rows in global index
        # order, zero rows after
        b_pad = core_pad + 2 * halo_cap
        n_h = len(h_ok)
        blk_rows = torch.cat([rows[:nc], h_rows])
        blk_gidx = torch.cat([gidx[:nc], torch.where(
            h_ok, h_gidx, torch.full_like(h_gidx, PAD_INDEX))])
        order = torch.argsort(blk_gidx, stable=True)
        n_valid = nc + h_ok.sum()
        slot = torch.arange(nc + n_h, device=device)
        dest = torch.where(slot < n_valid, slot, b_pad)
        block = put_drop(rows.new_zeros((b_pad, rows.shape[1])), dest,
                         blk_rows[order])
        probs = predict(block[:, 3:].contiguous(), block[:, :3].contiguous(),
                        n_valid.reshape(1).to(torch.int64))
        inv = torch.empty_like(order)
        inv[order] = torch.arange(len(order), device=device)
        out[gidx[:nc]] = probs[inv[:nc]].to(out.dtype)
    return _gathered(out)
