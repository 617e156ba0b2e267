"""CPU voxel down-sampling (numpy), reference ``util/voxelize.py:46-95``.

The JAX package's ``data/voxelize.py``, copied so that batches and vote
chunks stay bit-identical between the two packages: mode 0 (train) picks
one random point per occupied voxel; mode 1 (val) returns the hash-sorted
order and per-voxel counts that the whole-scene vote chunking reads
(reference ``test_backup.py:177-188``).
"""

from __future__ import annotations

import numpy as np


def fnv_hash_vec(arr):
    """FNV64-1A over integer coordinate rows (reference :46-58 semantics)."""
    if arr.ndim != 2:
        raise ValueError(f"expected [N, D] coordinates, got {arr.shape}")
    arr = arr.astype(np.uint64, copy=True)
    h = np.full(arr.shape[0], np.uint64(14695981039346656037))
    for j in range(arr.shape[1]):
        h = h * np.uint64(1099511628211)
        h = np.bitwise_xor(h, arr[:, j])
    return h


def voxelize(coord, voxel_size, rng=None, mode=0):
    """Mode 0: index of one random point per occupied voxel, drawn from the
    ``np.random.Generator`` ``rng`` (the draw order matches the JAX
    package's ``voxelize(..., mode=0)`` fed the same generator). Mode 1:
    ``(idx_sort, count)``, the points in hash order and each voxel's count.
    """
    discrete = np.floor(coord / np.array(voxel_size)).astype(np.int64)
    key = fnv_hash_vec(discrete)
    idx_sort = np.argsort(key)
    key_sort = key[idx_sort]
    _, count = np.unique(key_sort, return_counts=True)
    if mode == 1:
        return idx_sort, count
    pick = rng.integers(0, count.max(), count.size) % count
    idx_select = np.cumsum(np.insert(count, 0, 0)[0:-1]) + pick
    return idx_sort[idx_select]
