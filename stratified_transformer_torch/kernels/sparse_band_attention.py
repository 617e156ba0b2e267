"""Wrapper of the far-key CUDA kernel (``csrc/sparse_band_attention.cu``).

The kernel reads q, k and v in small-window order through the plan's
indices (``lw_map`` for the queries, ``sb_src`` for the aux slots) and
writes its triple straight into small-window order: the gathers and the
un-permutation that sit outside the ``pallas_call`` in the JAX package are
its own reads and writes, and the wrapper only allocates the outputs and
launches.
"""

from __future__ import annotations

import torch

from stratified_transformer_torch.kernels import (
    CudaKernel, F, I, P, block_limits, check_cuda_inputs, head_rows, ptr,
    stream_of)
from stratified_transformer_torch.ops.attention import (
    bin_constants, num_bins, sparse_band_attention_plain)

ARGTYPES = [P] * 19 + [I] * 10 + [F, F, F, P]
KERNEL = CudaKernel("sparse_band_attention", "sparse_band_attention_fwd",
                    ARGTYPES)
# the bf16 form (rpe_precision/qk_precision: default), on the tensor cores;
# the same arguments
KERNEL_FAST = CudaKernel("sparse_band_attention",
                         "sparse_band_attention_fwd_bf16", ARGTYPES)

# head sizes the kernels are instantiated for (csrc/*.cu)
HEAD_DIMS = (16,)


def launch_args(q, k, v, sb, table_q=None, table_k=None, table_v=None, *,
                window_size, quant_size, scale, s_band=128, tile=128,
                fast=False):
    """Output buffers and ``KERNEL`` (``KERNEL_FAST`` with ``fast``)
    arguments for CUDA inputs: returns
    ``(args, (acc, m, den) in small-window order, inputs)``. ``inputs``
    holds what the kernel reads in place. The argument tuple holds raw
    pointers, so keep the returned buffers alive while it is used."""
    tables = (table_q, table_k, table_v)
    dev = check_cuda_inputs("sparse_band_attention",
                            (q, k, v) + tables + tuple(sb))
    n, h, d = q.shape
    nb = num_bins(*tables)
    rows, max_nb = block_limits("sparse_band_attention", dev, fast=fast)
    if d not in HEAD_DIMS or tile <= 0 or n % tile or tile % rows:
        raise ValueError(
            f"sparse_band_attention: unsupported shape N={n}, d={d}, "
            f"tile={tile} (a multiple of {rows} rows)")
    if nb > max_nb:
        raise ValueError(
            f"sparse_band_attention: {nb} table rows per axis exceed the "
            f"{max_nb} that a {rows}-row block takes on {dev}")
    a_sz = sb.sb_src.shape[0]
    bin_offset, inv_quant = bin_constants(window_size, quant_size)
    (q, q_rs), (k, k_rs), (v, v_rs) = (head_rows(t) for t in (q, k, v))
    i32, f32 = torch.int32, torch.float32
    plan = (sb.lw_map.to(i32).contiguous(), sb.xyz_lw.to(f32).contiguous(),
            sb.valid_lw.to(torch.bool).contiguous(),
            sb.q_skey_lw.to(i32).contiguous(), sb.sb_start.to(i32).contiguous(),
            sb.sb_end.to(i32).contiguous(), sb.sb_src.to(i32).contiguous(),
            sb.sb_xyz.to(f32).contiguous(),
            sb.sb_valid.to(torch.bool).contiguous(),
            sb.sb_skey.to(i32).contiguous())
    tables = tuple(None if t is None else t.to(f32).contiguous()
                   for t in tables)
    outs = (torch.empty((n, h, d), dtype=f32, device=dev),
            torch.empty((n, h), dtype=f32, device=dev),
            torch.empty((n, h), dtype=f32, device=dev))
    inputs = (q, k, v) + plan + tables
    args = tuple(ptr(t) for t in inputs + outs) + (
        n, a_sz, h, d, q_rs, k_rs, v_rs, tile, min(s_band, a_sz), nb,
        bin_offset, inv_quant, float(scale), stream_of(dev))
    return args, outs, inputs


def sparse_band_attention(q, k, v, sb, table_q=None, table_k=None,
                          table_v=None, *, window_size, quant_size, scale,
                          s_band=128, tile=128, fast=False):
    """Far-key half of stratified attention; arguments and the returned
    triple (small-window-sorted order) as `sparse_band_attention_plain`."""
    kw = dict(window_size=window_size, quant_size=quant_size, scale=scale,
              s_band=s_band, tile=tile, fast=fast)
    if q.device.type == "cpu":
        return sparse_band_attention_plain(q, k, v, sb, table_q, table_k,
                                           table_v, **kw)
    args, outs, _inputs = launch_args(
        q, k, v, sb, table_q, table_k, table_v, **kw)
    with torch.cuda.device(q.device):
        (KERNEL_FAST if fast else KERNEL)(*args)
    return outs
