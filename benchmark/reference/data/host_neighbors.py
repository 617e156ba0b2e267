"""Host (CPU) neighbour queries over per-scene point segments.

Counterparts of the JAX package's ``data/native.py`` radius and kNN queries
(which wrap ``cpp/ingest.cpp``), built on ``scipy.spatial.cKDTree``. Scenes
are the flat segments given by cumulative ``offsets``. Results are
nearest first, -1 where a neighbour is absent.

Order: like ``cpp/ingest.cpp:198-250`` the candidates are ranked by the pair
(float32 squared distance, index), so equal distances list the lower index
first. The C++ query may fuse the distance arithmetic into FMAs, so lists
can differ from it where two distances are within an ulp of each other; as
sets they agree.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

# extra candidates taken from the tree so that float32 re-ranking and ties
# at the k-th place still see every contender
_SLACK = 8


def _ranked(q, ref, idx, k):
    """Re-rank tree candidates ``idx`` ([M, K'] into ``ref``, ``len(ref)``
    where absent) by (float32 d2, index); returns (idx, d2) of the first k."""
    present = idx < len(ref)
    safe = np.where(present, idx, 0)
    diff = ref[safe] - q[:, None, :]                        # float32
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
          + diff[..., 2] * diff[..., 2])
    d2 = np.where(present, d2, np.float32(np.inf))
    key_idx = np.where(present, safe, np.iinfo(np.int64).max)
    order = np.lexsort((key_idx, d2), axis=-1)[:, :k]
    return (np.take_along_axis(np.where(present, safe, -1), order, 1),
            np.take_along_axis(d2, order, 1))


def knn(query_pts, query_offsets, ref_pts, ref_offsets, k, with_dist=False):
    """Exact per-scene kNN: ``idx [Nq, k]`` int32 into the reference set
    (-1 where fewer than k exist), optionally with squared distances
    (1e10 where absent)."""
    q = np.ascontiguousarray(query_pts, np.float32)
    r = np.ascontiguousarray(ref_pts, np.float32)
    out = np.full((len(q), k), -1, np.int32)
    d2_out = np.full((len(q), k), 1e10, np.float32)
    qs = rs = 0
    for qe, re in zip(np.asarray(query_offsets, np.int64),
                      np.asarray(ref_offsets, np.int64)):
        qe, re = int(qe), int(re)
        if qe > qs and re > rs:
            ref = r[rs:re]
            kk = min(k + _SLACK, len(ref))
            _, idx = cKDTree(ref).query(q[qs:qe], k=np.arange(1, kk + 1))
            idx, d2 = _ranked(q[qs:qe], ref, idx, k)
            ok = idx >= 0
            w = idx.shape[1]
            out[qs:qe, :w] = np.where(ok, idx + rs, -1)
            d2_out[qs:qe, :w] = np.where(ok, d2, np.float32(1e10))
        qs, rs = qe, re
    return (out, d2_out) if with_dist else out


def radius_neighbors(points, offsets, radius, k):
    """Per-scene radius query: the k nearest points within ``radius``
    (float32 ``d2 <= radius**2``, the point itself included), ``[N, k]``
    int32, -1 where absent."""
    p = np.ascontiguousarray(points, np.float32)
    r2 = np.float32(radius) * np.float32(radius)
    out = np.full((len(p), k), -1, np.int32)
    start = 0
    for end in np.asarray(offsets, np.int64):
        end = int(end)
        if end > start:
            seg = p[start:end]
            kk = min(k + _SLACK, len(seg))
            _, idx = cKDTree(seg).query(
                seg, k=np.arange(1, kk + 1),
                distance_upper_bound=float(radius) * (1.0 + 1e-5))
            idx, d2 = _ranked(seg, seg, idx, k)
            ok = (idx >= 0) & (d2 <= r2)
            w = idx.shape[1]
            out[start:end, :w] = np.where(ok, idx + start, -1)
        start = end
    return out
