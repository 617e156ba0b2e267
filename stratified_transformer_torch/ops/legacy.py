"""Dense-batch compatibility ops (reference ``lib/pointops`` v1 API; the JAX
package's ``ops/legacy.py``).

The reference ships a legacy CUDA extension (``lib/pointops/src``) with a
dense ``[b, n, ...]`` batch layout that the live models never import (only
``lib/pointops2`` is, reference ``model/stratified_transformer.py:8``), but
whose API is part of the framework surface a reference user may rely on:
ball query, class-histogram label statistics, nearest-anchor feature
distribution, and dense gather/group. Here they are ordinary PyTorch on the
tensors' own device, not hot-path kernels (the models use `ops.neighbors`
and `ops.plan`).

Outputs equal the JAX package's: squared distances are the three-term sum
``dx*dx + dy*dy + dz*dz`` in axis order, as separate operations (no
``cdist``, whose matmul expansion rounds differently); ``radius * radius``
is taken as the caller's numbers multiply (a Python float squares in
double precision, as in the JAX op) and rounded once to float32; integer
histograms are counted in float64, exact below 2^53 (CUDA has no integer
``bmm``). The dense ``[b, m, n]`` temporaries are built over slices of at
most `CHUNK_ELEMENTS` query-reference pairs.

Semantics mirrored from:
  - ballquery: ``lib/pointops/src/ballquery/ballquery_cuda_kernel.cu:6-39``
    (first ``nsample`` in-radius refs in index order; all slots pre-filled
    with the first hit; no hit => 0).
  - labelstat: ``lib/pointops/src/labelstat/labelstat_cuda_kernel.cu:6-50``
    (``_and_ballquery``), ``:100-151`` (``_ballrange``, ``_idx``).
  - featuredistribute / featuregather: ``lib/pointops/src/
    featuredistribute/featuredistribute_cuda_kernel.cu:4-30``.
  - gathering / grouping:
    ``lib/pointops/src/gathering``, ``src/grouping`` (v1 dense layout).
  - knnquery_heap: ``lib/pointops/src/knnquery_heap``.
"""

from __future__ import annotations

import torch

from stratified_transformer_torch.ops import neighbors, sampling

# query-reference pairs ([b, rows, n] elements) of one slice of the dense ops
CHUNK_ELEMENTS = 1 << 24


def _row_slices(m, b, n):
    """Query slices ``[s, s + step)`` covering ``m`` queries, at most
    `CHUNK_ELEMENTS` pairs each."""
    step = max(CHUNK_ELEMENTS // max(b * n, 1), 1)
    return [(s, min(s + step, m)) for s in range(0, m, step)]


def _sqdist(q, r):
    """``[b, m, 3] x [b, n, 3] -> [b, m, n]``: ``sum((q - r) ** 2, -1)``
    added in axis order."""
    s = None
    for ax in range(3):
        d = q[:, :, None, ax] - r[:, None, :, ax]
        s = d * d if s is None else s + d * d
    return s


def _radius_sq(radius, device):
    """The JAX op's ``radius * radius`` as its float32 comparand."""
    return torch.as_tensor(radius * radius, dtype=torch.float32,
                           device=device)


def ball_query_dense(new_xyz, xyz, radius, nsample):
    """First-``nsample`` in-radius neighbours per query, CUDA scan order.

    ``new_xyz [b, m, 3]`` queries, ``xyz [b, n, 3]`` references, strict
    ``d2 < radius**2`` as in the kernel. Returns ``idx [b, m, nsample]``
    int32 and ``cnt [b, m]`` int32 (``min(hits, nsample)``). Slots beyond
    ``cnt`` repeat the first hit; queries with no hit are all zero (the
    CUDA output buffer is zero-initialised)."""
    b, m, _ = new_xyz.shape
    n = xyz.shape[1]
    ns = min(nsample, n)
    r2 = _radius_sq(radius, xyz.device)
    idx, cnt = [], []
    for s, e in _row_slices(m, b, n):
        mask = _sqdist(new_xyz[:, s:e], xyz) < r2               # [b, c, n]
        # each hit's place in scan order; hits past ``ns`` and misses go to
        # a spare slot that is dropped
        rank = torch.cumsum(mask, -1, dtype=torch.int32)
        slot = torch.where(mask & (rank <= ns), rank - 1, ns).long()
        pos = torch.arange(n, device=xyz.device).expand_as(slot)
        sel = torch.full((b, e - s, ns + 1), -1, dtype=torch.int64,
                         device=xyz.device).scatter_(2, slot, pos)[..., :ns]
        first = sel[..., :1].clamp_min(0)
        idx.append(torch.where(sel >= 0, sel, first).to(torch.int32))
        cnt.append(rank[..., -1].clamp_max(nsample))
    return torch.cat(idx, 1), torch.cat(cnt, 1)


def _gather_stat(label_stat, idx):
    """``[b, n, nclass]`` rows at ``idx [b, m, nsample]``: ``[b, m,
    nsample, nclass]``."""
    b, m, ns = idx.shape
    c = label_stat.shape[-1]
    flat = idx.reshape(b, m * ns, 1).long().expand(b, m * ns, c)
    return label_stat.gather(1, flat).reshape(b, m, ns, c)


def labelstat_idx(label_stat, idx):
    """``[b, n, nclass]`` per-point class histograms summed over the
    neighbour indices ``idx [b, m, nsample]``: ``[b, m, nclass]``, duplicate
    indices counted multiply, as the CUDA loop does
    (``labelstat_cuda_kernel.cu:140-150``)."""
    return _gather_stat(label_stat, idx).sum(2).to(label_stat.dtype)


def labelstat_ballrange(new_xyz, xyz, label_stat, radius):
    """Class histograms summed over ALL in-radius reference points:
    ``[b, m, nclass]`` (integer histograms counted in float64)."""
    b, m, _ = new_xyz.shape
    n = xyz.shape[1]
    r2 = _radius_sq(radius, xyz.device)
    acc = (torch.float64 if not label_stat.dtype.is_floating_point
           else label_stat.dtype)
    stat = label_stat.to(acc)
    out = [torch.bmm((_sqdist(new_xyz[:, s:e], xyz) < r2).to(acc), stat)
           for s, e in _row_slices(m, b, n)]
    return torch.cat(out, 1).to(label_stat.dtype)


def labelstat_and_ballquery(new_xyz, xyz, label_stat, radius, nsample):
    """Ball query and the histogram over its distinct hits, capped at
    ``nsample``: ``(idx [b, m, nsample], new_label_stat [b, m, nclass])``.
    The CUDA kernel adds each in-radius point once until ``nsample`` hits
    (``labelstat_cuda_kernel.cu:28-47``), so the histogram counts distinct
    hits only, unlike `labelstat_idx` over the padded index list."""
    idx, cnt = ball_query_dense(new_xyz, xyz, radius, nsample)
    gathered = _gather_stat(label_stat, idx)
    slot_ok = (torch.arange(idx.shape[-1], device=idx.device)[None, None]
               < cnt[..., None])
    stat = torch.where(slot_ok[..., None], gathered,
                       torch.zeros_like(gathered)).sum(2)
    return idx, stat.to(label_stat.dtype)


def feature_distribute(max_xyz, xyz):
    """Nearest-anchor assignment ``argmin_k ||xyz - max_xyz[k]||`` (the
    first of equal distances): ``max_xyz [b, n, 3]`` anchors, ``xyz [b, m,
    3]`` points; returns ``[b, m]`` int32."""
    b, m, _ = xyz.shape
    n = max_xyz.shape[1]
    return torch.cat([_sqdist(xyz[:, s:e], max_xyz).argmin(-1)
                      for s, e in _row_slices(m, b, n)], 1).to(torch.int32)


def feature_gather(max_feature, distribute_idx):
    """Anchor features per point: ``[b, c, n], [b, m] -> [b, c, m]``.
    Differentiable: the gather's backward is the CUDA backward's atomicAdd
    scatter (``featuredistribute_cuda_kernel.cu:60+``)."""
    return gathering(max_feature, distribute_idx)


def gathering(feats, idx):
    """v1 ``gathering``: ``[b, c, n], [b, m] -> [b, c, m]``."""
    b, c, _ = feats.shape
    return feats.gather(2, idx[:, None, :].long().expand(b, c, idx.shape[1]))


def grouping_dense(feats, idx):
    """v1 ``grouping``: ``[b, c, n], [b, m, nsample] -> [b, c, m,
    nsample]``, float or integer features (the reference's
    ``grouping_int`` is the same kernel over int64)."""
    b, c, _ = feats.shape
    m, ns = idx.shape[1], idx.shape[2]
    flat = idx.reshape(b, 1, m * ns).long().expand(b, c, m * ns)
    return feats.gather(2, flat).reshape(b, c, m, ns)


def knn_dense(new_xyz, xyz, k):
    """Dense-batch exact kNN (v1 ``knnquery_heap``): ``new_xyz [b, m, 3]``,
    ``xyz [b, n, 3]``; returns ``idx [b, m, k]`` int32 nearest-first (equal
    distances lower index first, as ``lax.top_k``) and ``dist2 [b, m, k]``
    float32 squared distances (the kernel's native quantity)."""
    b, m, _ = new_xyz.shape
    n = xyz.shape[1]
    idx, dist = [], []
    for s, e in _row_slices(m, b, n):
        d = _sqdist(new_xyz[:, s:e], xyz).reshape(b * (e - s), n)
        pos, dd = neighbors._smallest_k(d, k)
        idx.append(pos.reshape(b, e - s, k))
        dist.append(dd.reshape(b, e - s, k))
    return torch.cat(idx, 1).to(torch.int32), torch.cat(dist, 1)


def divide2patch(nsample, xyz, offsets, n_pad, *, anchor_scale=None,
                 return_offset=False):
    """FPS-anchored kNN patches (``functions/pointops.py:678-693``).

    Picks ``count // anchor_scale`` (default ``nsample``) FPS anchors per
    scene of the flat ``xyz [N, 3]`` / ``offsets [B]`` batch and returns
    each anchor's ``nsample`` nearest points of its scene: ``p_idx [n_pad,
    nsample]`` int32 and ``p_mask [n_pad, nsample]`` (``n_pad`` the anchor
    capacity), and with ``return_offset`` the anchors' ``new_offsets``."""
    n = xyz.shape[0]
    scale = anchor_scale or nsample
    counts = offsets - torch.cat([offsets.new_zeros(1), offsets[:-1]])
    new_offsets = sampling.counts_to_offsets(counts // scale)
    anchor_idx, anchor_valid = sampling.farthest_point_sampling(
        xyz, offsets, new_offsets, n_pad)
    valid = sampling.offsets_to_valid(offsets, n)
    batch = sampling.offsets_to_batch(offsets, n)
    a_batch = sampling.offsets_to_batch(new_offsets, n_pad)
    p_idx, _, p_mask = neighbors.knn(
        xyz[anchor_idx.long()], a_batch, xyz, batch, valid, nsample,
        query_valid=anchor_valid)
    if return_offset:
        return p_idx, p_mask, new_offsets
    return p_idx, p_mask
