"""Per-block attention layout ("plan"), the JAX package's ``ops/plan.py``.

A plan is built once per (stage, shift parity) and reused by every block of
that parity: the small-window partition (sorted order + segment bounds) for
the dense keys, and the band-structured `SparseBandLayout` for the
stratified far keys (the FPS/grid-downsampled points of the query's large
window, excluding its own small window; reference
``model/stratified_transformer.py:10-42,277-317``).

Every integer field is bit-identical to the JAX package's plan, on the CPU
and on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from reference.ops import hashing
from reference.ops import windows as win


class SparseBandLayout(NamedTuple):
    """Far keys compacted into an aux array sorted by *large*-window key.

    lw_map / lw_unmap: ``[N]`` small-sorted position of each lw-sorted
      position, and its inverse.
    xyz_lw / valid_lw / q_skey_lw: queries in lw order (coordinates,
      validity, small-window key).
    sb_start / sb_end: ``[N]`` aux segment bounds per lw-sorted query.
    sb_src: ``[A]`` small-sorted index of the member in each aux slot (-1
      pad); sb_skey ``[A]`` member small-window key (INVALID_KEY pad);
      sb_xyz ``[A, 3]``; sb_valid ``[A]``.
    """

    lw_map: torch.Tensor
    lw_unmap: torch.Tensor
    xyz_lw: torch.Tensor
    valid_lw: torch.Tensor
    q_skey_lw: torch.Tensor
    sb_start: torch.Tensor
    sb_end: torch.Tensor
    sb_src: torch.Tensor
    sb_skey: torch.Tensor
    sb_xyz: torch.Tensor
    sb_valid: torch.Tensor


class AttentionPlan(NamedTuple):
    order: torch.Tensor
    inv_order: torch.Tensor
    seg_start: torch.Tensor
    seg_end: torch.Tensor
    valid_sorted: torch.Tensor
    xyz_sorted: torch.Tensor
    sparse_band: Optional[SparseBandLayout] = None
    grid_start: Optional[torch.Tensor] = None


def build_attention_plan(xyz, batch, valid, window_size, *, shifted,
                         is_down=None, sparse_cap=64, aux_pad=None,
                         anchor=None):
    """Attention layout for one shift parity.

    Args:
      xyz: ``[N, 3]`` float32 (original order); batch ``[N]`` scene ids;
        valid ``[N]`` bool.
      window_size: small-window edge.
      shifted: shifted partition (odd blocks).
      is_down: ``[N]`` bool stratified members (downsampled points); when
        given, the far-key layout is built from the 2x large windows.
      sparse_cap: far keys kept per large window.
      aux_pad: aux-array capacity (default ``N // 4`` rounded up to 128).

    The window grid's origin is ``anchor`` (``[3]``) when given, so that
    the spatial blocks of one scene share one grid (`parallel.halo`), else
    the batch min of valid points (the reference's ``xyz.min(0)``); it is
    returned as ``grid_start``.
    """
    ws = float(window_size)
    n = xyz.shape[0]
    start = (hashing.masked_min(xyz, valid) if anchor is None
             else torch.as_tensor(anchor, dtype=torch.float32,
                                  device=xyz.device))
    shift_small = 0.5 * ws if shifted else 0.0
    cells_small = hashing.window_cells(xyz, ws, start=start, shift=shift_small)
    key_small = hashing.window_keys(cells_small, batch, valid)
    part = win.partition_windows(key_small, valid)
    order = part.order.long()

    sparse_band = None
    if is_down is not None:
        lws = 2.0 * ws
        shift_large = ws if shifted else 0.0
        cells_large = hashing.window_cells(
            xyz, lws, start=start, shift=shift_large)
        key_large = hashing.window_keys(cells_large, batch, valid)
        member = is_down & valid
        if aux_pad is None:
            aux_pad = ((n // 4 + 127) // 128) * 128

        invalid = torch.full_like(key_large, hashing.INVALID_KEY)
        lw_key_sort = torch.where(valid, key_large, invalid)
        lw_order = torch.argsort(lw_key_sort, stable=True)
        lw_inv = win.inverse_permutation(lw_order.to(torch.int32))
        lw_map = part.inv_order[lw_order]
        lw_unmap = lw_inv[order]
        q_key_lw = lw_key_sort[lw_order]

        head = win.head_flags(q_key_lw)
        member_lw = (member[lw_order] & (q_key_lw != hashing.INVALID_KEY)
                     ).to(torch.int32)
        cmem = torch.cumsum(member_lw, 0, dtype=torch.int32)   # inclusive
        # member rank within its window: exclusive member count at the
        # window head, broadcast forward by cummax
        grp0 = win.cummax(torch.where(head, cmem - member_lw, 0))
        mrank = cmem - 1 - grp0
        keep = (member_lw > 0) & (mrank < sparse_cap)
        keep_i = keep.to(torch.int32)
        kept_cum = torch.cumsum(keep_i, 0, dtype=torch.int32)  # inclusive
        slot = torch.where(keep, kept_cum - 1, aux_pad)
        sb_src = win.scatter_drop(aux_pad, -1, slot, lw_map)
        sb_skey = win.scatter_drop(aux_pad, hashing.INVALID_KEY, slot,
                                key_small[lw_order])
        sb_xyz = win.scatter_drop(aux_pad, 0.0, slot, xyz[lw_order])

        # per-query aux segment bounds: kept-member counts before/through
        # the query's window (empty when the window has no members)
        sb_start = win.cummax(torch.where(head, kept_cum - keep_i, 0))
        sb_end = win.reverse_cummin(
            torch.where(win.tail_flags(head), kept_cum, n + 1))
        sparse_band = SparseBandLayout(
            lw_map=lw_map,
            lw_unmap=lw_unmap,
            xyz_lw=xyz[lw_order],
            valid_lw=valid[lw_order],
            q_skey_lw=key_small[lw_order],
            sb_start=sb_start.to(torch.int32),
            sb_end=sb_end.to(torch.int32),
            sb_src=sb_src,
            sb_skey=sb_skey,
            sb_xyz=sb_xyz,
            sb_valid=sb_src >= 0,
        )

    return AttentionPlan(
        order=part.order,
        inv_order=part.inv_order,
        seg_start=part.seg_start,
        seg_end=part.seg_end,
        valid_sorted=part.valid_sorted,
        xyz_sorted=xyz[order],
        sparse_band=sparse_band,
        grid_start=start,
    )
