"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers.

Each wrapper takes the same arguments as its plain version in
``ops/attention.py``. Given CPU tensors it runs the plain version; given
CUDA tensors it launches the kernel or raises. It never falls back from the
card to the plain version. Each attention wrapper takes ``fast``: its
kernel's bf16 form (``KERNEL_FAST``, the C entry point ``<symbol>_bf16``),
never the fp32 form in its place.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from stratified_transformer_torch.kernels import build

# the sources of the four attention kernels, which the model runs (their
# fp32, bf16 and swin forms)
ATTENTION_SOURCES = ("band_attention", "sparse_band_attention",
                     "band_attention_bwd", "sparse_band_attention_bwd")
# the sources a training step runs: those and the masked row gather of the
# gathers that autograd differentiates (no eval forward loads it)
TRAIN_SOURCES = ATTENTION_SOURCES + ("gather_rows",)

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
def _limits(source, symbol, index, nb):
    fn = getattr(build.load(source), symbol)
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
        raise RuntimeError(f"{symbol} failed: cudaError_t {rc}")
    return rows.value, max_nb.value


def block_limits(source, dev, nb=None, fast=False, swin=False):
    """``(rows per block, most table rows per axis)`` of the attention
    kernel of ``csrc/<source>.cu`` on the CUDA device ``dev``, from its C
    entry point ``<source>_limits``: the second is the most that the
    kernel's blocks fit in that device's shared memory. The backward
    kernels offer several block heights and pick one by the table size:
    give them ``nb``, the table rows per axis, and the first value is the
    rows they launch with for it (0 beyond the limit). ``fast``: the limits
    of the kernel's bf16 form (``<source>_bf16_limits``), whose staging in
    bf16 leaves room for more table rows. ``swin``: those of the fp32 band
    kernels' swin mode (``<source>_swin_limits``), whose blocks take their
    own heights and shared memory (the bf16 forms' swin mode shares their
    limits; ``fast`` wins)."""
    symbol = source + ("_bf16" if fast else "_swin" if swin else "") \
        + "_limits"
    return _limits(source, symbol, dev.index if dev.index is not None
                   else torch.cuda.current_device(), nb)


def occupancy(source, dev, nb, rpe_mode="stratified"):
    """Blocks of the fp32 launch of the kernel of ``csrc/<source>.cu`` for
    tables of ``nb`` rows per axis (the swin mode's with ``rpe_mode``
    "swin_window") that one SM of the CUDA device ``dev`` holds at once,
    from its C entry point ``<source>_occupancy``."""
    fn = getattr(build.load(source), source + "_occupancy")
    fn.argtypes = [I, I, ctypes.POINTER(I)]
    fn.restype = I
    blocks = I()
    with torch.cuda.device(dev):
        rc = fn(nb, int(rpe_mode == "swin_window"), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(
            f"{source}_occupancy failed: cudaError_t {rc}")
    return blocks.value


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
    kernel in place: fp32 with head stride ``d``, channel stride 1 and rows
    that start on 16 bytes, which the fast forms read a float4 at a time
    (the model's views of its qkv projection pass as they are), else a
    contiguous copy."""
    t = t.to(torch.float32)
    if (t.stride(2) != 1 or t.stride(1) != t.shape[2] or t.stride(0) % 4
            or t.data_ptr() % 16):
        t = t.contiguous()
    return t, t.stride(0)


def rows16(t):
    """``t`` as contiguous fp32 whose data starts on 16 bytes (the fp32
    backward kernels copy rows of q, g, k and v by cp.async): ``t`` itself
    where it is so, else a copy."""
    t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def pack_tables(tables, lo, rows):
    """cRPE tables ``[L,h,d,3]`` -> contiguous fp32 ``[h,3,rows,d]`` slices
    from row ``lo`` (the kernels' layout), None passing through."""
    return tuple(
        None if t is None else
        t.to(torch.float32)[lo:lo + rows].permute(1, 3, 0, 2).contiguous()
        for t in tables)


def stage_bf16(t, scale=None):
    """``t`` (times ``scale``, in fp32) rounded to bf16, to nearest with ties
    to even, contiguous: the operand copies the fast backward kernels read
    (equal to ``ops.attention.bf16_round`` of the same fp32 values)."""
    t = t.to(torch.float32)
    if scale is not None:
        t = t * scale
    return t.to(torch.bfloat16).contiguous()


def xyz_valid(xyz, valid):
    """``[N, 4]`` fp32 rows (x, y, z, 1 if valid else 0): the fast backward
    kernels' point records, 16 bytes each."""
    return torch.cat([xyz.to(torch.float32),
                      valid.to(torch.float32)[:, None]], 1).contiguous()


def pack_tables_bf16(tables, lo, rows):
    """`pack_tables` staged in bf16 (`stage_bf16`)."""
    return tuple(None if t is None else stage_bf16(t)
                 for t in pack_tables(tables, lo, rows))


def stream_of(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def sum_table_partials(dt_part, tables):
    """Per-(tile, head) table grads ``[tiles, h, 3 tables, 3 axes, nb, d]``
    -> one ``[nb, h, d, 3]`` grad per present table (None for an absent
    one), summed over tiles in order."""
    return tuple(
        None if t is None else dt_part[:, :, i].sum(0).permute(2, 0, 3, 1)
        for i, t in enumerate(tables))
