"""Window / voxel keys (the JAX package's ``ops/hashing.py``).

Points get an integer key per (batch, floor((xyz + shift - start) / size))
tuple; downstream code sorts by key and derives contiguous segments.
"""

from __future__ import annotations

import torch

# Sentinel key for padding points: sorts after every real key.
INVALID_KEY = torch.iinfo(torch.int32).max


def window_cells(xyz, window_size, *, start, shift=0.0):
    """``[N, 3]`` int32 cell coordinates ``floor((xyz + shift - start) /
    window_size)``, in that order of fp32 operations.

    The divisor is a device tensor on purpose: PyTorch's CUDA division by a
    Python scalar multiplies by the reciprocal instead, which is not the
    correctly rounded quotient the JAX package (and the CPU) computes.
    """
    ws = torch.tensor(window_size, dtype=xyz.dtype, device=xyz.device)
    cells = torch.floor((xyz + shift - start) / ws)
    return cells.to(torch.int32)


def window_keys(cells, batch, valid, *, cells_hi=None):
    """Fuse (batch, cell) into one sortable int32 key; the multipliers are
    the per-axis cell bounds ``cells_hi`` (default: the maxima of the valid
    cells, plus one), so the packing is collision-free. Invalid points get
    ``INVALID_KEY``."""
    c = torch.where(valid[:, None], cells, torch.zeros_like(cells))
    hi = c.max(0).values + 1 if cells_hi is None else cells_hi.to(torch.int32)
    key = batch.to(torch.int32)
    for a in range(3):
        key = key * hi[a] + c[:, a]
    return torch.where(valid, key, torch.full_like(key, INVALID_KEY))


def masked_min(xyz, valid):
    """Per-axis min over valid points (reference ``xyz.min(0)``)."""
    big = torch.finfo(xyz.dtype).max
    return torch.where(valid[:, None], xyz,
                       torch.full_like(xyz, big)).min(0).values
