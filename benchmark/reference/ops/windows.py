"""Static-shape window partitioning (the JAX package's ``ops/windows.py``).

Points are sorted by window key; every window becomes a contiguous segment
of the sorted order, described by per-point ``[seg_start, seg_end)``. A
window's members can also be collected into a fixed-capacity row of a
table (`sparse_key_table`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reference.ops.hashing import INVALID_KEY


class WindowPartition(NamedTuple):
    order: torch.Tensor         # [N] int32 sorted position -> original idx
    inv_order: torch.Tensor     # [N] int32 original idx -> sorted position
    key_sorted: torch.Tensor    # [N] int32
    seg_start: torch.Tensor     # [N] int32 first sorted position of window
    seg_end: torch.Tensor       # [N] int32 one past its last position
    valid_sorted: torch.Tensor  # [N] bool


def head_flags(key_sorted):
    """True where a sorted key differs from its predecessor."""
    head = torch.ones_like(key_sorted, dtype=torch.bool)
    head[1:] = key_sorted[1:] != key_sorted[:-1]
    return head


def tail_flags(head):
    """True where the next position starts a new run."""
    tail = torch.ones_like(head)
    tail[:-1] = head[1:]
    return tail


def cummax(x):
    return torch.cummax(x, 0).values


def reverse_cummin(x):
    return torch.flip(torch.cummin(torch.flip(x, (0,)), 0).values, (0,))


def put_drop(out, slot, values):
    """``out.at[slot].set(values, mode="drop")``: rows whose slot lies
    outside ``[0, len(out))`` are dropped, as JAX drops them (a torch
    scatter would raise). They land in a spare last row that is cut off, so
    the device never waits for a mask's count. The kept slots must be
    distinct. Returns a new tensor."""
    size = out.shape[0]
    full = torch.cat([out, out.new_empty((1,) + tuple(out.shape[1:]))])
    slot = slot.long()
    full[torch.where((slot >= 0) & (slot < size), slot, size)] = (
        values.to(out.dtype))
    return full[:size]


def scatter_drop(size, fill, slot, values):
    """``full(size, fill).at[slot].set(values, mode="drop")``."""
    return put_drop(torch.full((size,) + tuple(values.shape[1:]), fill,
                               dtype=values.dtype, device=values.device),
                    slot, values)


def inverse_permutation(order):
    inv = torch.empty_like(order)
    inv[order.long()] = torch.arange(
        order.shape[0], dtype=order.dtype, device=order.device)
    return inv


def partition_windows(key, valid) -> WindowPartition:
    n = key.shape[0]
    key = torch.where(valid, key, torch.full_like(key, INVALID_KEY))
    order = torch.argsort(key, stable=True).to(torch.int32)
    key_sorted = key[order.long()]
    valid_sorted = valid[order.long()]
    idx = torch.arange(n, dtype=torch.int32, device=key.device)
    head = head_flags(key_sorted)
    seg_start = cummax(torch.where(head, idx, 0))
    seg_end = reverse_cummin(torch.where(tail_flags(head), idx + 1, n))
    return WindowPartition(
        order=order,
        inv_order=inverse_permutation(order),
        key_sorted=key_sorted,
        seg_start=seg_start.to(torch.int32),
        seg_end=seg_end.to(torch.int32),
        valid_sorted=valid_sorted,
    )


def sparse_key_table(key, is_member, capacity):
    """Fixed-capacity member table per window (``windows.py:96-144``).

    Returns ``table [N, capacity]`` int32 of original point indices (-1
    empty), whose row ``r`` holds the members of the ``r``-th distinct
    member key in ascending key order (members beyond ``capacity`` are
    dropped), and ``table_keys [N]`` int32, the key of each row
    (``INVALID_KEY`` for unused rows, which follow the used ones).
    """
    n = key.shape[0]
    dev = key.device
    mkey = torch.where(is_member, key, torch.full_like(key, INVALID_KEY))
    order = torch.argsort(mkey, stable=True).to(torch.int32)
    mkey_sorted = mkey[order.long()]
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    head = head_flags(mkey_sorted)
    row = torch.cumsum(head, 0) - 1
    rank = idx - cummax(torch.where(head, idx, 0))
    ok = (mkey_sorted != INVALID_KEY) & (rank < capacity)
    flat = torch.where(ok, row * capacity + rank, n * capacity)
    table = scatter_drop(n * capacity, -1, flat, order).view(n, capacity)
    table_keys = scatter_drop(n, INVALID_KEY, torch.where(ok & head, row, n),
                              mkey_sorted)
    return table, table_keys


def lookup_rows(table_keys, query_key):
    """Row of each query key in a `sparse_key_table` (-1 if absent)."""
    pos = torch.searchsorted(table_keys, query_key).clamp(
        0, table_keys.shape[0] - 1)
    hit = (table_keys[pos] == query_key) & (query_key != INVALID_KEY)
    return torch.where(hit, pos, -1).to(torch.int32)
