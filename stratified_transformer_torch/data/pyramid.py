"""Host-side geometry pyramid: downsampling + kNN graphs on the CPU.

The JAX package's ``data/pyramid.py``: grid-pool sample indices, per-level
kNN, 3-NN upsample indices and per-stage stratified member masks are
computed from coordinates alone on the host and shipped with the batch, so
the model's ``TransitionDown`` / ``Upsample`` / plan machinery runs no
neighbour search on the device.
"""

from __future__ import annotations

import numpy as np

from stratified_transformer_torch.data import host_neighbors


def host_grid_pool(xyz, offsets, new_offsets, out_pad, cell_size):
    """Center-most point per grid cell, per scene, capped at the scene's
    quota, emitted in cell-key order.

    Returns ``(idx [out_pad] int32, valid [out_pad] bool)``.
    """
    xyz = np.asarray(xyz, np.float32)
    offsets = np.asarray(offsets, np.int64)
    new_offsets = np.asarray(new_offsets, np.int64)
    total = int(offsets[-1])
    idx_out = np.zeros(out_pad, np.int32)
    valid_out = np.zeros(out_pad, bool)

    if total:
        mins = xyz[:total].min(0)
    else:
        mins = np.zeros(3, np.float32)
    cells = np.floor((xyz[:total] - mins) / np.float32(cell_size))
    center = (cells + 0.5) * np.float32(cell_size) + mins
    d2c = ((xyz[:total] - center) ** 2).sum(-1)

    start = 0
    new_start = 0
    for s in range(len(offsets)):
        end = int(offsets[s])
        ns, ne = new_start, int(new_offsets[s])
        count = ne - ns
        # scene-first fill (gathers stay in-scene)
        first = start if end > start else 0
        idx_out[ns:ne] = first
        if end > start and count > 0:
            c = cells[start:end].astype(np.int64)
            hi = c.max(0) + 1                # exact packing, no collisions
            key = (c[:, 0] * hi[1] + c[:, 1]) * hi[2] + c[:, 2]
            # representative = min distance-to-center per cell, first wins
            order = np.lexsort((np.arange(end - start), d2c[start:end], key))
            k_s = key[order]
            head = np.ones(len(k_s), bool)
            head[1:] = k_s[1:] != k_s[:-1]
            take = order[head][:count] + start
            m = len(take)
            idx_out[ns:ns + m] = take.astype(np.int32)
            valid_out[ns:ns + m] = True
        start = end
        new_start = ne
    return idx_out, valid_out


def floor_ratio_counts(offsets, ratio):
    """Per-scene ``floor(count * ratio) + 1`` targets -> new offsets
    (reference ``model/stratified_transformer.py:99-101``)."""
    offsets = np.asarray(offsets, np.int64)
    counts = np.diff(np.concatenate([[0], offsets]))
    new_counts = np.where(counts > 0, (counts * ratio).astype(np.int64) + 1,
                          0)
    return np.cumsum(new_counts)


def _round_up(n, m):
    return (n + m - 1) // m * m


def build_geometry_pyramid(xyz, offsets, cfg):
    """Host pyramid for a `StratifiedConfig`.

    Returns a dict:
      down:  per TransitionDown level — {"idx", "valid", "offsets",
             "knn_idx", "knn_mask"} (kNN of pooled points vs their level).
      up:    per Upsample (decoder order) — {"idx", "mask"} 3-NN of fine
             points vs coarse points.
      stage_down: per transformer stage (``layer_start`` on) — {"is_down"}
             stratified member mask at that stage's level.
    All shapes are static given cfg; padding is gather-safe.
    """
    xyz = np.asarray(xyz, np.float32)
    offsets64 = np.asarray(offsets, np.int64)

    levels = [(xyz, offsets64, len(xyz))]
    down = []
    grid_sizes = cfg.grid_sizes()

    n_cur = cfg.n_pad
    for i in range(cfg.num_layers - 1):
        cur_xyz, cur_off, _ = levels[-1]
        out_pad = _round_up(int(n_cur * cfg.ratio) + cfg.num_scenes,
                            cfg.tile)
        new_off = floor_ratio_counts(cur_off, cfg.ratio)
        idx, valid = host_grid_pool(
            cur_xyz, cur_off, new_off, out_pad, grid_sizes[i] * 2.0)
        new_xyz = cur_xyz[idx]
        knn_idx = host_neighbors.knn(new_xyz, new_off, cur_xyz, cur_off,
                                     cfg.k)
        knn_mask = (knn_idx >= 0) & valid[:, None]
        own = np.where(valid, idx, 0)[:, None].astype(np.int32)
        knn_idx = np.where(knn_mask, knn_idx, own).astype(np.int32)
        down.append({"idx": idx, "valid": valid,
                     "offsets": np.asarray(new_off, np.int32),
                     "knn_idx": knn_idx, "knn_mask": knn_mask})
        levels.append((new_xyz, new_off, out_pad))
        n_cur = out_pad

    # decoder: 3-NN of each finer level against the coarser one
    up = []
    for li in range(len(levels) - 1, 0, -1):
        fine_xyz, fine_off, _ = levels[li - 1]
        coarse_xyz, coarse_off, _ = levels[li]
        up_idx = host_neighbors.knn(
            fine_xyz, fine_off, coarse_xyz, coarse_off, cfg.up_k)
        up_mask = up_idx >= 0
        up.append({"idx": np.where(up_mask, up_idx, 0).astype(np.int32),
                   "mask": up_mask})

    # stratified member masks per transformer stage, from layer_start: with
    # stem_transformer False, level 0 is the skip level and the stem_down
    # TransitionDown (the first down level, at grid_sizes[0] * 2) leads to
    # stage 1 (the JAX package's data/pyramid.py:133-139,179-201)
    stage_down = []
    for i in range(cfg.layer_start, cfg.num_layers):
        cur_xyz, cur_off, n_lvl = levels[i]
        cnts = np.diff(np.concatenate([[0], cur_off]))
        d_pad = n_lvl // cfg.downsample_scale + cfg.num_scenes
        cell = grid_sizes[i] * float(cfg.downsample_scale) ** 0.5
        d_off = np.cumsum(
            np.where(cnts > 0, cnts // cfg.downsample_scale + 1, 0))
        d_idx, d_valid = host_grid_pool(cur_xyz, cur_off, d_off, d_pad, cell)
        is_down = np.zeros(n_lvl, bool)
        is_down[d_idx[d_valid]] = True
        stage_down.append({"is_down": is_down})

    return {"down": tuple(down), "up": tuple(up),
            "stage_down": tuple(stage_down)}
