"""Neighbour search and interpolation on the device (the JAX package's
``ops/neighbors.py``).

Covers the reference's ``pointops.knnquery`` (exact kNN within the query's
scene), ``ball_query`` (radius-limited lists for the KPConv stem,
``train.py:324-329``) and ``pointops.interpolation`` (inverse-distance 3-NN).
`knn` is brute force over query chunks; `grid_knn` is the cell list the
model uses (``neighbor_method: grid``). `subtraction` and `aggregation` are
the point-transformer ops of ``pointops``' public API, which no model here
uses.

Index lists are bit-identical to the JAX package's: the ``k`` smallest
distances are selected by one key per candidate that packs the distance's
bits above its position, so equal distances go to the lower position as
``lax.top_k`` sends them (``torch.topk`` promises no order among equals).

The feature gathers whose gradient autograd will take (`gathers_grad`) go
through `GatherRows`, the masked row gather of ``kernels/gather_rows.py``;
every other gather is plain indexing.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from stratified_transformer_torch.kernels import gather_rows as gather_k
from stratified_transformer_torch.ops import hashing
from stratified_transformer_torch.ops import windows as win
from stratified_transformer_torch.ops.sampling import BIG

# rows of the cell list's dense key -> row map (``neighbors.py:185-190``): a
# cell whose key is at or beyond it finds no row
DENSE_KEYS = 1 << 22
# candidates (queries x searched cells x cap) one slice of `grid_knn` holds
# on a CUDA device; on the CPU a slice is ``chunk`` queries. The result does
# not depend on the slicing.
CUDA_SLICE_CANDIDATES = 1 << 25


def _smallest_k(d, k):
    """Positions and values of the ``k`` smallest entries of each row of
    ``d`` (non-negative float32), ascending, lower position first among
    equals."""
    bits = torch.where(d == 0, torch.zeros_like(d), d).view(torch.int32)
    shift = max(int(d.shape[1] - 1).bit_length(), 1)
    pos = torch.arange(d.shape[1], dtype=torch.int64, device=d.device)
    keys = (bits.to(torch.int64) << shift) | pos
    sel = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
    pos = sel & ((1 << shift) - 1)
    return pos, torch.gather(d, 1, pos)


def _square(radius, device):
    """``float32(radius) ** 2`` as one float32 product."""
    r = torch.tensor(radius, dtype=torch.float32, device=device)
    return r * r


def _pairwise_sqdist(q, r):
    """``[M, 3] x [N, 3] -> [M, N]`` squared distances by ``|q|^2 + |r|^2 -
    2 q.r``, centred at the query chunk's centroid (``neighbors.py:30-42``)."""
    q = q.to(torch.float32)
    r = r.to(torch.float32)
    center = q.mean(0, keepdim=True)
    q = q - center
    r = r - center
    qq = (q * q).sum(-1, keepdim=True)
    rr = (r * r).sum(-1)
    return (qq + rr[None, :] - 2.0 * (q @ r.T)).clamp_min(0.0)


def knn(query_xyz, query_batch, ref_xyz, ref_batch, ref_valid, k, *,
        query_valid=None, chunk=512):
    """Exact k nearest neighbours within the query's scene
    (``neighbors.py:45-103``), over query chunks of ``chunk`` (the last
    padded with zero rows, which move its centroid as in the JAX package).

    Returns ``idx [M, k]`` int32 nearest-first (slots without a neighbour
    repeat the nearest), ``dist [M, k]`` squared distances, ``mask [M, k]``.
    """
    m = query_xyz.shape[0]
    pad = (-m) % chunk
    qx = torch.cat([query_xyz, query_xyz.new_zeros((pad, 3))])
    qb = torch.cat([query_batch.long(),
                    query_batch.new_full((pad,), -1).long()])
    ref_batch = ref_batch.long()
    idx, dist = [], []
    for s in range(0, m + pad, chunk):
        d = _pairwise_sqdist(qx[s:s + chunk], ref_xyz)
        same = (qb[s:s + chunk, None] == ref_batch[None, :]) & ref_valid
        d = torch.where(same, d, torch.full_like(d, BIG))
        pos, dd = _smallest_k(d, k)
        idx.append(pos)
        dist.append(dd)
    idx, dist = torch.cat(idx)[:m], torch.cat(dist)[:m]
    mask = dist < BIG
    idx = torch.where(mask, idx, idx[:, :1]).to(torch.int32)
    if query_valid is not None:
        mask = mask & query_valid[:, None]
    return idx, dist, mask


def grid_knn(query_xyz, query_batch, ref_xyz, ref_batch, ref_valid, k, *,
             cell, cap=32, radius=None, query_valid=None, chunk=None,
             selector="exact", origin=None):
    """Cell-list k nearest neighbours (``neighbors.py:106-272``).

    Reference points are bucketed into grid cells of edge ``cell`` (at most
    ``cap`` per cell, in index order) on a grid anchored at ``origin``
    (``[3]``) when given, else at the valid refs' min; each query examines
    the 27 cells around its own. ``radius`` drops
    candidates beyond it (the ball-query mode). Queries run in slices of
    ``chunk``
    (None: all at once), or on a CUDA device of as many as
    `CUDA_SLICE_CANDIDATES` allows. Returns ``(idx, dist, mask)`` as `knn`.
    """
    if selector != "exact":
        raise ValueError(
            f"grid_knn: selector {selector!r} is not ported; 'approx' is the "
            "TPU's lax.approx_min_k, and the port selects exactly")
    dev = query_xyz.device
    nq = query_xyz.shape[0]
    n_ref = ref_xyz.shape[0]
    query_ok = (torch.ones(nq, dtype=torch.bool, device=dev)
                if query_valid is None else query_valid)

    # sharded inference passes the scene's anchor: a batch-min origin
    # would move the cells per block, and with them which refs the per-cell
    # ``cap`` keeps
    start = (hashing.masked_min(ref_xyz, ref_valid) if origin is None
             else torch.as_tensor(origin, dtype=torch.float32, device=dev))
    rcells = hashing.window_cells(ref_xyz, cell, start=start)
    hi = torch.where(ref_valid[:, None], rcells,
                     torch.zeros_like(rcells)).max(0).values + 1
    rkey = hashing.window_keys(rcells, ref_batch, ref_valid, cells_hi=hi)

    # per-cell tables: up to ``cap`` ref indices and their coordinates
    order = torch.argsort(rkey, stable=True)
    key_sorted = rkey[order]
    pos = torch.arange(n_ref, dtype=torch.int64, device=dev)
    head = win.head_flags(key_sorted)
    row_of_pos = torch.cumsum(head, 0) - 1
    rank = pos - win.cummax(torch.where(head, pos, 0))
    ok_pos = (key_sorted != hashing.INVALID_KEY) & (rank < cap)
    slot = torch.where(ok_pos, row_of_pos * cap + rank, -1)
    table = win.scatter_drop(n_ref * cap, -1, slot, order.to(torch.int32)
                             ).view(n_ref, cap)
    ctab = win.scatter_drop(n_ref * cap, BIG, slot,
                            ref_xyz[order].to(torch.float32)
                            ).view(n_ref, cap, 3)

    # dense key -> row map; keys at or beyond DENSE_KEYS find no row
    rowmap = win.scatter_drop(
        DENSE_KEYS, -1, torch.where(head & ok_pos, key_sorted.long(), -1),
        row_of_pos)

    axr = torch.arange(-1, 2, dtype=torch.int32, device=dev)
    offs = torch.stack(torch.meshgrid(axr, axr, axr, indexing="ij"),
                       -1).reshape(-1, 3)                  # [D, 3]
    n_cells = offs.shape[0]
    kk = min(k, n_cells * cap)
    qcells_all = hashing.window_cells(query_xyz, cell, start=start)
    r2 = None if radius is None else _square(radius, dev)

    def one_slice(qx, qb, qcells, qok):
        m = qx.shape[0]
        ncells = qcells[:, None, :] + offs[None]            # [m, D, 3]
        in_range = ((ncells >= 0) & (ncells < hi)).all(-1) & qok[:, None]
        nkey = hashing.window_keys(
            ncells.reshape(-1, 3), qb.repeat_interleave(n_cells),
            in_range.reshape(-1), cells_hi=hi).long()
        safe = in_range.reshape(-1) & (nkey >= 0) & (nkey < DENSE_KEYS)
        row = torch.where(safe, rowmap[nkey.clamp(0, DENSE_KEYS - 1)],
                          -1).view(m, n_cells)
        rowc = row.clamp(0, n_ref - 1)
        crows = ctab[rowc]                                  # [m, D, cap, 3]
        irows = table[rowc]                                 # [m, D, cap]
        ok = (row >= 0)[..., None] & (irows >= 0)
        cand = torch.where(ok, irows, 0).view(m, -1)
        ok = ok.view(m, -1)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        d2 = torch.zeros((m, n_cells * cap), dtype=torch.float32, device=dev)
        for a in range(3):
            diff = torch.where(
                ok, crows[..., a].reshape(m, -1) - qx[:, a, None], zero)
            d2 = d2 + diff * diff
        d2 = torch.where(ok, d2, BIG)
        if r2 is not None:
            d2 = torch.where(d2 <= r2, d2, BIG)
        pos, dist = _smallest_k(d2, kk)
        return torch.gather(cand, 1, pos), dist

    step = nq if chunk is None else chunk
    if dev.type == "cuda":
        step = max(step, CUDA_SLICE_CANDIDATES // (n_cells * cap))
    qx32 = query_xyz.to(torch.float32)
    parts = [one_slice(qx32[s:s + step], query_batch[s:s + step],
                       qcells_all[s:s + step], query_ok[s:s + step])
             for s in range(0, nq, max(step, 1))]
    idx = torch.cat([p[0] for p in parts])
    dist = torch.cat([p[1] for p in parts])
    mask = dist < BIG
    if kk < k:                                              # degenerate cap
        idx = torch.cat([idx, idx.new_zeros((nq, k - kk))], 1)
        dist = torch.cat([dist, dist.new_full((nq, k - kk), BIG)], 1)
        mask = torch.cat([mask, mask.new_zeros((nq, k - kk))], 1)
    idx = torch.where(mask, idx, idx[:, :1]).to(torch.int32)
    return idx, dist, mask & query_ok[:, None]


def radius_neighbors(query_xyz, query_batch, ref_xyz, ref_batch, ref_valid,
                     radius, k, *, chunk=512, method="brute", cap=32,
                     grid_chunk=None, origin=None):
    """Up to ``k`` neighbours within ``radius``, nearest first
    (``neighbors.py:275-322``; the reference's ``ball_query``); the cell
    list's cells are ``radius`` wide, anchored at ``origin`` (see
    `grid_knn`). Returns ``(idx [M, k] int32, mask [M, k])``."""
    if method == "grid":
        idx, _, mask = grid_knn(
            query_xyz, query_batch, ref_xyz, ref_batch, ref_valid, k,
            cell=float(radius), cap=cap, radius=radius, chunk=grid_chunk,
            origin=origin)
        return idx, mask
    idx, dist, mask = knn(query_xyz, query_batch, ref_xyz, ref_batch,
                          ref_valid, k, chunk=chunk)
    mask = mask & (dist <= _square(radius, dist.device))
    return torch.where(mask, idx, idx[:, :1]), mask


def inverse_distance_weights(d, mask):
    """``pointops.interpolation``'s weights from euclidean distances ``d``
    ``[M, k]``: ``(1 / (d + 1e-8)) / sum``, 0 where ``mask`` is False."""
    recip = torch.where(mask, 1.0 / (d + 1e-8), torch.zeros_like(d))
    return recip / recip.sum(-1, keepdim=True).clamp_min(1e-12)


def three_nn_interpolate(query_xyz, query_batch, support_xyz, support_batch,
                         support_valid, support_feats, *, query_valid=None,
                         chunk=512, method="brute", cell=None, cap=32,
                         grid_chunk=None, origin=None):
    """Inverse-distance weighted 3-NN feature interpolation
    (``neighbors.py:325-367``; ``origin`` as `grid_knn`'s). Returns ``[M,
    C]``."""
    args = (query_xyz, query_batch, support_xyz, support_batch,
            support_valid, 3)
    if method == "grid":
        idx, dist2, mask = grid_knn(*args, cell=cell, cap=cap,
                                    query_valid=query_valid, chunk=grid_chunk,
                                    origin=origin)
    else:
        idx, dist2, mask = knn(*args, query_valid=query_valid, chunk=chunk)
    w = inverse_distance_weights(torch.sqrt(dist2), mask)
    return (support_feats[idx.long()]
            * w[..., None].to(support_feats.dtype)).sum(1)


def interpolate_from_idx(query_xyz, support_xyz, support_feats, idx, mask):
    """Inverse-distance 3-NN interpolation from precomputed indices
    (``neighbors.py:370-386``); distances are recomputed from the gathered
    coordinates."""
    qx = query_xyz.to(torch.float32)
    sx = support_xyz.to(torch.float32)
    d = torch.sqrt(((qx[:, None, :] - sx[idx]) ** 2).sum(-1))
    w = inverse_distance_weights(d, mask)
    # masked slots weigh 0, so the masked gather's fill of 0 adds the same
    rows = (GatherRows.apply(support_feats, idx, mask, 0.0)
            if gathers_grad(support_feats) else support_feats[idx])
    return (rows * w[..., None].to(support_feats.dtype)).sum(1)


def subtraction(input1, input2, idx, mask=None):
    """Pairwise difference ``out[i, j] = input1[i] - input2[idx[i, j]]``
    (``neighbors.py:389-406``; ``pointops.subtraction``,
    ``functions/pointops.py:695-722``): ``[N, C], [N, C], [N, k] -> [N, k,
    C]``, zero where the optional ``[N, k]`` ``mask`` is False.
    Differentiable through autograd (the gather's backward is the CUDA
    backward's scatter-add)."""
    out = input1[:, None, :] - input2[idx.long()]
    if mask is not None:
        out = torch.where(mask[..., None], out, torch.zeros_like(out))
    return out


def aggregation(feats, position, weight, idx, mask=None):
    """Point-transformer vector aggregation (``neighbors.py:409-431``;
    ``pointops.aggregation``, ``functions/pointops.py:725-753``):
    ``out[n] = sum_j (feats[idx[n, j]] + position[n, j]) * weight[n, j]``,
    weight channel ``c % w_c`` scaling feature channel ``c``
    (``aggregation_cuda_kernel.cu:5-20``). ``feats [N, C]``, ``position
    [N, k, C]``, ``weight [N, k, w_c]`` with ``C % w_c == 0``, ``idx [N,
    k]``, optional ``mask [N, k]`` (masked slots add nothing). Returns ``[N,
    C]``; differentiable through autograd."""
    c = feats.shape[-1]
    w_c = weight.shape[-1]
    if c % w_c:
        raise ValueError(f"aggregation: {c} channels in groups of {w_c}")
    vals = feats[idx.long()] + position
    w = weight.repeat(1, 1, c // w_c)                  # channel groups
    if mask is not None:
        w = torch.where(mask[..., None], w, torch.zeros_like(w))
    return (vals * w).sum(1)


class GatherRows(torch.autograd.Function):
    """``apply(feats, idx, mask, fill)``: ``torch.where(mask[..., None],
    feats[idx], fill)`` (``[*idx.shape, C]``), whose backward sums each
    source row's unmasked slots in slot order (`gather_rows.gather_rows`
    and `gather_rows.gather_rows_bwd`: the kernels on the card, the plain
    versions on the CPU). Autograd's own backward of ``feats[idx]`` walks
    every masked slot of a row's duplicates serially on the card."""

    @staticmethod
    def forward(ctx, feats, idx, mask, fill):
        ctx.save_for_backward(idx, mask)
        ctx.rows = feats.shape[0]
        return gather_k.gather_rows(feats, idx, mask, fill)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        idx, mask = ctx.saved_tensors
        return (gather_k.gather_rows_bwd(g, idx, mask, ctx.rows), None,
                None, None)


def gathers_grad(feats):
    """Whether autograd records a gather of ``feats``: the gathers that
    `GatherRows` takes (never under ``torch.no_grad`` or
    ``torch.inference_mode``, nor of features that need no gradient)."""
    return torch.is_grad_enabled() and feats.requires_grad


def gather_group(feats, idx, mask, fill=0.0):
    """``feats[idx] -> [M, k, C]`` with masked slots set to ``fill``
    (``pointops.grouping``)."""
    if gathers_grad(feats):
        return GatherRows.apply(feats, idx, mask, fill)
    g = feats[idx]
    return torch.where(mask[..., None], g, torch.full_like(g, fill))
