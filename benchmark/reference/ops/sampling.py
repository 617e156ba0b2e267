"""Point down-sampling on the device (the JAX package's ``ops/sampling.py``):
exact farthest-point sampling, grid pooling and blocked FPS.

Points of scene ``b`` occupy flat positions ``[offsets[b-1], offsets[b])``;
positions ``>= offsets[-1]`` are padding. Every sampler returns ``idx
[out_pad]`` int32 indices into the flat input, packed scene-contiguously per
``new_offsets``, and ``valid [out_pad]``; unfilled slots alias their scene's
first point. Index outputs are bit-identical to the JAX package's, and
between the card and the CPU: the arithmetic is spelled as separate eager
operations (no fused or contracted form), divisions take a tensor divisor,
sorts are stable, and ties go to the lower index as JAX's do.
"""

from __future__ import annotations

import torch

from reference.ops import windows as win
from reference.ops.hashing import INVALID_KEY

BIG = 1e10


def offsets_to_batch(offsets, n_pad):
    """Scene id per flat position; padding tail gets id ``B`` (out of
    range). Reference ``train.py:319-321``."""
    idx = torch.arange(n_pad, device=offsets.device, dtype=torch.int64)
    return torch.searchsorted(offsets.to(torch.int64), idx,
                              right=True).to(torch.int32)


def offsets_to_valid(offsets, n_pad):
    return torch.arange(n_pad, device=offsets.device) < offsets[-1]


def floor_ratio_counts(counts, ratio):
    """Per-scene target counts ``int(n * ratio) + 1`` (float32 product, as
    in the JAX package)."""
    return torch.floor(counts.to(torch.float32) * ratio).to(torch.int32) + 1


def counts_to_offsets(counts):
    return torch.cumsum(counts, 0).to(torch.int32)


def scene_starts(offsets):
    return torch.cat([offsets.new_zeros(1), offsets[:-1]])


def segment_reduce(values, ids, num_segments, reduce):
    """``jax.ops.segment_{sum,min,max}`` for ``reduce`` "sum", "amin",
    "amax": ids outside ``[0, num_segments)`` are dropped, and an empty
    segment holds the reduction's identity (0; +inf or the integer type's
    max; -inf or its min)."""
    dt = values.dtype
    if reduce == "sum":
        fill = 0
    elif dt.is_floating_point:
        fill = float("inf") if reduce == "amin" else -float("inf")
    else:
        info = torch.iinfo(dt)
        fill = info.max if reduce == "amin" else info.min
    out = torch.full((num_segments + 1,), fill, dtype=dt,
                     device=values.device)
    ids = ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out.scatter_reduce_(0, ids, values, reduce, include_self=False)
    return out[:num_segments]


def sqdist(a, b):
    """``sum((a - b) ** 2, -1)`` over three coordinates, added in axis
    order as separate operations."""
    d = a - b
    s = d[..., 0] * d[..., 0]
    s = s + d[..., 1] * d[..., 1]
    return s + d[..., 2] * d[..., 2]


def _segment_argmax(score, batch, num_scenes, n):
    """Index of the max-score point per scene (first index on ties;
    ``sampling.py:62-71``)."""
    seg_max = segment_reduce(score, batch, num_scenes + 1, "amax")
    b = batch.long().clamp(0, num_scenes - 1)
    is_max = (score >= seg_max[b]) & (batch < num_scenes)
    idx = torch.arange(n, dtype=torch.int64, device=score.device)
    arg = segment_reduce(torch.where(is_max, idx, n), batch, num_scenes + 1,
                         "amin")
    return arg[:num_scenes].clamp(0, n - 1)


def farthest_point_sampling(xyz, offsets, new_offsets, out_pad):
    """Exact per-scene FPS (``sampling.py:74-129``; reference
    ``pointops.furthestsampling``): each scene starts from its first point
    and adds, step by step, the point farthest from those chosen. The loop
    stops once every scene has its ``new_offsets`` count (at most
    ``out_pad``), where the JAX package's scan runs on without writing.
    """
    n = xyz.shape[0]
    num_scenes = offsets.shape[0]
    dev = xyz.device
    batch = offsets_to_batch(offsets, n)
    valid = offsets_to_valid(offsets, n)
    starts = scene_starts(offsets).long()
    new_starts = scene_starts(new_offsets).long()
    new_counts = new_offsets.long() - new_starts
    scene_counts = offsets.long() - starts
    xyz32 = xyz.to(torch.float32)
    b = batch.long().clamp(0, num_scenes - 1)

    out = torch.zeros(out_pad, dtype=torch.int64, device=dev)
    first = starts.clamp(0, n - 1)
    out = win.put_drop(out, torch.where((new_counts > 0) & (scene_counts > 0),
                                new_starts, out_pad), first)
    min_d = torch.where(valid, BIG, -BIG)
    cur = first
    steps = min(out_pad, int(torch.minimum(new_counts, scene_counts).max()))
    for j in range(1, steps):
        d = sqdist(xyz32, xyz32[cur][b])
        min_d = torch.minimum(min_d, torch.where(valid, d, -BIG))
        cur = _segment_argmax(min_d, batch, num_scenes, n)
        write = torch.where((j < new_counts) & (j < scene_counts),
                            new_starts + j, out_pad)
        out = win.put_drop(out, write, cur)
    out_valid = torch.arange(out_pad, device=dev) < new_offsets[-1]
    return out.to(torch.int32), out_valid


def _grid_cells(xyz32, valid, cell_size, origin=None):
    """Cells ``floor((xyz - mins) / cell_size)`` of a batch-wide grid
    anchored at ``origin`` (``[3]``) when given, else at the valid points'
    min, with the divisor a device tensor (PyTorch's CUDA division by a
    Python number multiplies by its reciprocal, which is not the correctly
    rounded quotient)."""
    if origin is None:
        mins = torch.where(valid[:, None], xyz32,
                           torch.full_like(xyz32, BIG)).min(0).values
    else:
        mins = torch.as_tensor(origin, dtype=torch.float32,
                               device=xyz32.device)
    cell = torch.tensor(cell_size, dtype=torch.float32, device=xyz32.device)
    cells = torch.floor((xyz32 - mins) / cell).to(torch.int32)
    return cells, mins, cell


def _cell_keys(cells, batch, valid, num_scenes):
    """Scene-major, then x/y/z-lexicographic int32 cell keys; padding gets
    ``INVALID_KEY``."""
    zero = torch.zeros_like(cells)
    hi = torch.where(valid[:, None], cells, zero).max(0).values + 1
    key = batch.clamp(0, num_scenes)
    for a in range(3):
        key = key * hi[a] + torch.where(valid, cells[:, a], zero[:, a])
    return torch.where(valid, key, torch.full_like(key, INVALID_KEY))


def _grid_reps(xyz, offsets, cell_size, origin=None):
    """Center-most representative per grid cell (``sampling.py:132-172``),
    in key-sorted order: returns ``(order, batch of each sorted point,
    is_rep, starts, n, num_scenes)``."""
    n = xyz.shape[0]
    num_scenes = offsets.shape[0]
    batch = offsets_to_batch(offsets, n)
    valid = offsets_to_valid(offsets, n)
    xyz32 = xyz.to(torch.float32)
    cells, mins, cell = _grid_cells(xyz32, valid, cell_size, origin)
    key = _cell_keys(cells, batch, valid, num_scenes)
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    center = cells.to(torch.float32) + 0.5
    center = center * cell
    center = center + mins
    d2c_s = sqdist(xyz32, center)[order]
    idx = torch.arange(n, dtype=torch.int64, device=xyz.device)
    seg_id = torch.cumsum(win.head_flags(key_s), 0) - 1
    seg_min = segment_reduce(d2c_s, seg_id, n, "amin")
    is_rep = (d2c_s <= seg_min[seg_id]) & (key_s != INVALID_KEY)
    # ties: the first position of the cell with the least distance
    first_min = segment_reduce(torch.where(is_rep, idx, n), seg_id, n,
                               "amin")
    is_rep = is_rep & (idx == first_min[seg_id])
    return (order, batch[order], is_rep, scene_starts(offsets).long(), n,
            num_scenes)


def _pack(out_pad, n, starts, new_offsets, write, values):
    """The samplers' output slots: each aliases its scene's first point,
    then ``values`` land at ``write`` (dropped outside ``[0, out_pad)``).
    Returns ``(idx, slot scene ids clamped to a scene, slot rank in its
    scene, slot scene ids)``."""
    num_scenes = new_offsets.shape[0]
    slot = torch.arange(out_pad, dtype=torch.int64, device=starts.device)
    slot_batch = torch.searchsorted(new_offsets.long(), slot, right=True)
    sb = slot_batch.clamp(0, num_scenes - 1)
    out = win.put_drop(starts.clamp(0, n - 1)[sb], write, values)
    slot_rank = slot - scene_starts(new_offsets).long()[sb]
    return out.to(torch.int32), sb, slot_rank, slot_batch


def _scene_ranks(is_rep, rep_batch, num_scenes, n):
    """Rank of each representative within its scene, in sorted order."""
    cum = torch.cumsum(is_rep.to(torch.int64), 0)
    scene_first = segment_reduce(torch.where(is_rep, cum - 1, n), rep_batch,
                                 num_scenes + 1, "amin")[:num_scenes]
    rb = rep_batch.long().clamp(0, num_scenes - 1)
    return (cum - 1) - scene_first[rb], rb


def grid_pool_sampling(xyz, offsets, new_offsets, out_pad, cell_size,
                       origin=None):
    """The center-most point of each grid cell, at most ``new_offsets``'
    count per scene in flat key order (``sampling.py:175-232``), on a grid
    anchored at ``origin`` when given (sharded inference's global anchor),
    else at the batch min of the valid points."""
    order, rep_batch, is_rep, starts, n, num_scenes = _grid_reps(
        xyz, offsets, cell_size, origin)
    new_starts = scene_starts(new_offsets).long()
    new_counts = new_offsets.long() - new_starts
    rank, rb = _scene_ranks(is_rep, rep_batch, num_scenes, n)
    ok = is_rep & (rep_batch < num_scenes) & (rank < new_counts[rb])
    write = torch.where(ok, new_starts[rb] + rank, out_pad)
    out, sb, slot_rank, slot_batch = _pack(out_pad, n, starts, new_offsets,
                                           write, order)
    produced = torch.minimum(
        segment_reduce(ok.to(torch.int64), rb, num_scenes, "sum"),
        new_counts)
    out_valid = (slot_batch < num_scenes) & (slot_rank < produced[sb])
    return out, out_valid


def grid_pool_sampling_all(xyz, offsets, out_pad, cell_size, origin=None):
    """`grid_pool_sampling` without the per-scene quota: every occupied
    cell keeps its representative, up to ``out_pad`` in all
    (``sampling.py:235-284``). Returns ``(idx, valid, new_offsets)``, the
    last the cumulative representative counts."""
    order, rep_batch, is_rep, starts, n, num_scenes = _grid_reps(
        xyz, offsets, cell_size, origin)
    rank, rb = _scene_ranks(is_rep, rep_batch, num_scenes, n)
    rep_counts = segment_reduce(is_rep.to(torch.int64), rb, num_scenes, "sum")
    new_offsets = torch.cumsum(rep_counts, 0).clamp_max(out_pad)
    new_starts = scene_starts(new_offsets)
    ok = (is_rep & (rep_batch < num_scenes)
          & (rank < (new_offsets - new_starts)[rb]))
    write = torch.where(ok, new_starts[rb] + rank, out_pad)
    out = _pack(out_pad, n, starts, new_offsets, write, order)[0]
    out_valid = torch.arange(out_pad, device=xyz.device) < new_offsets[-1]
    return out, out_valid, new_offsets.to(torch.int32)


def blocked_fps(xyz, offsets, new_offsets, out_pad, cell_size, *,
                block_cap=256):
    """Exact FPS inside each grid block of edge ``cell_size``, all blocks in
    lockstep, with a quota proportional to the block's population
    (``sampling.py:287-403``); packed per scene as `grid_pool_sampling`.

    Only the used rows of the block table (``block_cap`` members each) run,
    and the loop stops at the largest quota: the JAX package's vmapped scan
    runs its other rows and steps without choosing a point.
    """
    n = xyz.shape[0]
    num_scenes = offsets.shape[0]
    dev = xyz.device
    batch = offsets_to_batch(offsets, n)
    valid = offsets_to_valid(offsets, n)
    starts = scene_starts(offsets).long()
    new_starts = scene_starts(new_offsets).long()
    new_counts = new_offsets.long() - new_starts
    scene_counts = offsets.long() - starts
    ratio = torch.where(
        scene_counts > 0,
        new_counts.to(torch.float32)
        / scene_counts.clamp_min(1).to(torch.float32),
        torch.zeros((), device=dev))

    xyz32 = xyz.to(torch.float32)
    cells = _grid_cells(xyz32, valid, cell_size)[0]
    key = _cell_keys(cells, batch, valid, num_scenes)
    table, table_keys = win.sparse_key_table(key, valid, block_cap)
    used = int((table_keys != INVALID_KEY).sum())   # used rows come first
    table = table[:used].long()
    member_ok = table >= 0
    member_count = member_ok.sum(1)
    tbl = table.clamp(0, n - 1)
    blk_batch = batch[tbl[:, 0]].long().clamp(0, num_scenes - 1)
    quota = torch.ceil(member_count.to(torch.float32)
                       * ratio[blk_batch]).to(torch.int64)
    quota = torch.minimum(quota, member_count)

    pts = xyz32[tbl]                                      # [used, cap, 3]
    rows = torch.arange(used, device=dev)
    mind = torch.where(member_ok, BIG, -BIG)
    chosen = torch.zeros_like(member_ok)
    chosen[:, 0] = quota > 0
    last = torch.zeros(used, dtype=torch.int64, device=dev)
    steps = int(quota.max()) if used else 0
    for j in range(1, steps):
        dd = sqdist(pts, pts[rows, last][:, None, :])
        mind = torch.minimum(mind, torch.where(member_ok, dd, -BIG))
        mind = torch.where(chosen, -BIG, mind)
        nxt = torch.argmax(mind, 1)
        take = j < quota
        chosen[rows, nxt] = take | chosen[rows, nxt]
        last = torch.where(take, nxt, last)

    # pack per scene in flat order, cut to each scene's target
    sel = (chosen & member_ok).reshape(-1)
    idx_flat = tbl.reshape(-1)
    sel_batch = torch.where(sel, batch[idx_flat].long(), num_scenes)
    order = torch.argsort(torch.where(sel, sel_batch, num_scenes + 1),
                          stable=True)
    sb_sorted = sel_batch[order]
    pos = torch.arange(sel.shape[0], dtype=torch.int64, device=dev)
    sbc = sb_sorted.clamp(0, num_scenes - 1)
    scene_first = segment_reduce(
        torch.where(sb_sorted < num_scenes, pos, sel.shape[0]), sbc,
        num_scenes, "amin")
    rank = pos - scene_first[sbc]
    ok = (sb_sorted < num_scenes) & (rank < new_counts[sbc])
    write = torch.where(ok, new_starts[sbc] + rank, out_pad)
    out, sb, slot_rank, slot_batch = _pack(out_pad, n, starts, new_offsets,
                                           write, idx_flat[order])
    produced = torch.minimum(
        segment_reduce(ok.to(torch.int64), sbc, num_scenes, "sum"),
        new_counts)
    out_valid = (slot_batch < num_scenes) & (slot_rank < produced[sb])
    return out, out_valid
