"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers.

Each wrapper takes the same arguments as its plain version in
``ops/attention.py``. Given CPU tensors it runs the plain version; given
CUDA tensors it launches the kernel or raises. It never falls back from the
card to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from stratified_transformer_torch.kernels import build

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


class CudaKernel:
    """One C entry point of the library built from ``csrc/<source>.cu``.

    ``launches`` counts the successful launches of this process; it grows
    by one inside `__call__` and nowhere else.
    """

    def __init__(self, source, symbol, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args):
        if self._fn is None:
            fn = getattr(build.load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.symbol} failed to launch: cudaError_t {rc}")
        self.launches += 1


@functools.lru_cache(maxsize=None)
def _limits(source, index, nb):
    fn = getattr(build.load(source), f"{source}_limits")
    rows, max_nb = ctypes.c_int(), ctypes.c_int()
    out = (ctypes.byref(rows), ctypes.byref(max_nb))
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    if nb is not None:
        fn.argtypes = [ctypes.c_int] + fn.argtypes
        out = (nb,) + out
    fn.restype = ctypes.c_int
    with torch.cuda.device(index):
        rc = fn(*out)
    if rc != 0:
        raise RuntimeError(f"{source}_limits failed: cudaError_t {rc}")
    return rows.value, max_nb.value


def block_limits(source, dev, nb=None):
    """``(rows per block, most table rows per axis)`` of the attention
    kernel of ``csrc/<source>.cu`` on the CUDA device ``dev``, from its C
    entry point ``<source>_limits``: the second is the most that the
    kernel's blocks fit in that device's shared memory. The backward
    kernels offer several block heights and pick one by the table size:
    give them ``nb``, the table rows per axis, and the first value is the
    rows they launch with for it (0 beyond the limit)."""
    return _limits(source, dev.index if dev.index is not None
                   else torch.cuda.current_device(), nb)


def ptr(t):
    """Device pointer of a tensor, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def check_cuda_inputs(name, tensors):
    """Every given tensor lies on one CUDA device, and none needs a gradient
    while autograd records: a wrapper is no autograd node itself (the
    autograd Function of ``ops/attention_fused.py`` pairs the forward and
    backward kernels)."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        dev = t.device
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                f"{name}: the wrapper records no autograd graph; call "
                "ops.attention_fused.stratified_attention_fused, whose "
                "autograd Function runs the backward kernels, or run under "
                "torch.no_grad()")
    return dev


def head_rows(t):
    """``(t, row stride)`` for a ``[rows, h, d]`` tensor read by a forward
    kernel in place: fp32 with head stride ``d`` and channel stride 1 (the
    model's views of its qkv projection pass as they are), else a
    contiguous copy."""
    t = t.to(torch.float32)
    if t.stride(2) != 1 or t.stride(1) != t.shape[2]:
        t = t.contiguous()
    return t, t.stride(0)


def pack_tables(tables, lo, rows):
    """cRPE tables ``[L,h,d,3]`` -> contiguous fp32 ``[h,3,rows,d]`` slices
    from row ``lo`` (the kernels' layout), None passing through."""
    return tuple(
        None if t is None else
        t.to(torch.float32)[lo:lo + rows].permute(1, 3, 0, 2).contiguous()
        for t in tables)


def stream_of(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def sum_table_partials(dt_part, tables):
    """Per-(tile, head) table grads ``[tiles, h, 3 tables, 3 axes, nb, d]``
    -> one ``[nb, h, d, 3]`` grad per present table (None for an absent
    one), summed over tiles in order."""
    return tuple(
        None if t is None else dt_part[:, :, i].sum(0).permute(2, 0, 3, 1)
        for i, t in enumerate(tables))
