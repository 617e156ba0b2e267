"""Wrapper of the masked row gather (``csrc/gather_rows.cu``) and its plain
PyTorch versions.

``gather_rows(feats, idx, mask, fill)`` is ``torch.where(mask[..., None],
feats[idx], fill)``; ``gather_rows_bwd(g, idx, mask, rows)`` its gradient in
``feats``: each row's sum of ``g`` over the unmasked slots that name it, in
ascending slot order. Given CPU tensors they run the plain versions; given
CUDA tensors they launch the kernels or raise. The autograd Function that
pairs them is ``ops/neighbors.py::GatherRows``.

Three launch counters: ``FWD`` (one launch per forward), ``MAP`` (one call
of the inverse map per backward: a memset and six kernels) and ``BWD``
(one launch per backward).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from stratified_transformer_torch.kernels import (
    CudaKernel, F, I, P, build, check_cuda_inputs, ptr, stream_of)

FWD = CudaKernel("gather_rows", "gather_rows_fwd",
                 [P, P, P, P, I, I, I, F, I, P])
MAP = CudaKernel("gather_rows", "gather_rows_map", [P, P, I, I, P, P, P, P,
                                                  I, P])
BWD = CudaKernel("gather_rows", "gather_rows_bwd", [P] * 4 + [I, I, P])

# the kernels index rows and slots by 32-bit integers: slots x channels and
# rows x channels stay below this
LIMIT = 1 << 31


def gather_rows_plain(feats, idx, mask, fill=0.0):
    """``[*idx.shape, C]``: ``feats[idx]`` where ``mask``, else ``fill``."""
    g = feats[idx]
    return torch.where(mask[..., None], g, torch.full_like(g, fill))


def gather_rows_bwd_plain(g, idx, mask, rows):
    """``[rows, C]``: the sum of ``g``'s rows over the unmasked slots of
    each source row, added in slot order (``index_add_`` on the CPU)."""
    c = g.shape[-1]
    keep = mask.reshape(-1)
    out = g.new_zeros((rows, c))
    return out.index_add_(0, idx.reshape(-1)[keep].long(),
                          g.reshape(-1, c)[keep])


@functools.lru_cache(maxsize=None)
def _map_scratch():
    """``(rows, slots) -> entries`` of the int32 scratch that ``MAP`` takes
    (the C entry point ``gather_rows_map_scratch``)."""
    fn = build.load("gather_rows").gather_rows_map_scratch
    fn.argtypes, fn.restype = [I, I], ctypes.c_longlong
    return fn


def _flat(idx, mask, name):
    """``(idx int32 or int64, mask bool)`` flat and contiguous, and whether
    idx is int64."""
    if idx.shape != mask.shape:
        raise ValueError(f"{name}: idx {tuple(idx.shape)} and mask "
                         f"{tuple(mask.shape)} differ")
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.long()
    return (idx.reshape(-1).contiguous(),
            mask.to(torch.bool).reshape(-1).contiguous(),
            int(idx.dtype == torch.int64))


def _check_sizes(name, slots, rows, c):
    if slots * c >= LIMIT or (rows + 1) * max(c, 1) >= LIMIT:
        raise ValueError(f"{name}: {slots} slots and {rows} rows of {c} "
                         f"channels exceed the kernels' 32-bit indices")


def gather_rows(feats, idx, mask, fill=0.0):
    """``feats [R, C]`` rows at ``idx`` (any shape, int32 or int64) where
    the bool ``mask`` (idx's shape) holds, else ``fill``: ``[*idx.shape,
    C]``, as `gather_rows_plain`."""
    if feats.device.type == "cpu":
        return gather_rows_plain(feats, idx, mask, fill)
    dev = check_cuda_inputs("gather_rows", (feats, idx, mask))
    if feats.dim() != 2 or feats.dtype != torch.float32:
        raise ValueError(f"gather_rows: feats must be fp32 [rows, C], got "
                         f"{feats.dtype} {tuple(feats.shape)}")
    shape = tuple(idx.shape) + (feats.shape[1],)
    flat_idx, flat_mask, idx64 = _flat(idx, mask, "gather_rows")
    rows, c = feats.shape
    slots = flat_idx.numel()
    _check_sizes("gather_rows", slots, rows, c)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if slots == 0 or c == 0:
        return out
    if rows == 0:                   # every index out of range: masked
        return out.fill_(fill)
    feats = feats.contiguous()
    with torch.cuda.device(dev):
        FWD(ptr(feats), ptr(flat_idx), ptr(flat_mask), ptr(out), slots,
            rows, c, float(fill), idx64, stream_of(dev))
    return out


def inverse_map(idx, mask, rows):
    """``(start [rows + 1], order [slots])`` int32 on the card, by one
    ``MAP`` call: row r's unmasked slots are ``order[start[r]:start[r +
    1]]``, ascending (CUDA tensors only)."""
    dev = check_cuda_inputs("inverse_map", (idx, mask))
    flat_idx, flat_mask, idx64 = _flat(idx, mask, "inverse_map")
    slots = flat_idx.numel()
    i32 = torch.int32
    start = torch.empty(rows + 1, dtype=i32, device=dev)
    placed = torch.empty(slots, dtype=i32, device=dev)
    order = torch.empty(slots, dtype=i32, device=dev)
    with torch.cuda.device(dev):
        scratch = torch.empty(_map_scratch()(rows, slots), dtype=i32,
                              device=dev)
        MAP(ptr(flat_idx), ptr(flat_mask), slots, rows, ptr(scratch),
            ptr(start), ptr(placed), ptr(order), idx64, stream_of(dev))
    return start, order


def sum_rows(g, start, order, rows):
    """``[rows, C]``: each row's rows of ``g`` (``[slots, C]`` fp32,
    contiguous) over its slots of the inverse map, added in that order, by
    one ``BWD`` launch (CUDA tensors only)."""
    dev = check_cuda_inputs("sum_rows", (g, start, order))
    dfeats = torch.empty((rows, g.shape[1]), dtype=torch.float32,
                         device=dev)
    with torch.cuda.device(dev):
        BWD(ptr(g), ptr(start), ptr(order), ptr(dfeats), rows, g.shape[1],
            stream_of(dev))
    return dfeats


def gather_rows_bwd(g, idx, mask, rows):
    """The gradient of `gather_rows` in ``feats``: ``[rows, C]`` from ``g``
    ``[*idx.shape, C]``, as `gather_rows_bwd_plain`. On the card the
    `inverse_map`, then `sum_rows`: no float atomics, so two calls on the
    same inputs agree bit for bit."""
    if g.device.type == "cpu":
        return gather_rows_bwd_plain(g, idx, mask, rows)
    dev = check_cuda_inputs("gather_rows_bwd", (g, idx, mask))
    c = g.shape[-1]
    if g.dtype != torch.float32 or tuple(g.shape[:-1]) != tuple(idx.shape):
        raise ValueError(f"gather_rows_bwd: g must be fp32 [*idx.shape, C], "
                         f"got {g.dtype} {tuple(g.shape)} for idx "
                         f"{tuple(idx.shape)}")
    slots = idx.numel()
    _check_sizes("gather_rows_bwd", slots, rows, c)
    if rows == 0 or c == 0 or slots == 0:
        return torch.zeros((rows, c), dtype=torch.float32, device=dev)
    return sum_rows(g.reshape(slots, c).contiguous(),
                    *inverse_map(idx, mask, rows), rows)
