"""Wrapper of the far-key backward CUDA kernel
(``csrc/sparse_band_attention_bwd.cu``).

The gathers into large-window and aux order, the un-permutation of dq, the
sum of each tile's row slices, the scatter-adds of the tiles' windows
into aux slots and then into points, and the sum of the table partials
over tiles are plain PyTorch around the kernel, as they sit outside the
``pallas_call`` in the JAX package.
"""

from __future__ import annotations

import torch

from stratified_transformer_torch.kernels import (
    CudaKernel, F, I, P, block_limits, check_cuda_inputs, pack_tables, ptr,
    stream_of, sum_table_partials)
from stratified_transformer_torch.ops.attention import (
    bin_constants, num_bins, sparse_band_attention_bwd_plain,
    sparse_bwd_finish, sparse_inputs, sparse_window)

KERNEL = CudaKernel(
    "sparse_band_attention_bwd", "sparse_band_attention_bwd",
    [P] * 22 + [I] * 7 + [F, F, F, P])

# head sizes the kernels are instantiated for (csrc/*.cu)
HEAD_DIMS = (16,)


def launch_args(q, k, v, sb, g, o, m, den, table_q=None, table_k=None,
                table_v=None, *, window_size, quant_size, scale, s_band=128,
                tile=128):
    """Device buffers and ``KERNEL`` arguments for CUDA inputs: returns
    ``(args, (dq_lw, dk_part, dv_part, dt_part), inputs)``. The argument
    tuple holds raw pointers, so keep the returned buffers alive while it
    is used."""
    tables = (table_q, table_k, table_v)
    dev = check_cuda_inputs(
        "sparse_band_attention_bwd", (q, k, v, g, o, m, den) + tables
        + tuple(sb))
    n, h, d = q.shape
    nb = num_bins(*tables)
    rows, max_nb = block_limits("sparse_band_attention_bwd", dev, nb)
    if nb > max_nb:
        raise ValueError(
            f"sparse_band_attention_bwd: {nb} table rows per axis exceed the "
            f"{max_nb} that its blocks take on {dev}")
    if d not in HEAD_DIMS or tile <= 0 or n % tile or tile % rows:
        raise ValueError(
            f"sparse_band_attention_bwd: unsupported shape N={n}, d={d}, "
            f"tile={tile} (a multiple of {rows} rows)")
    a_sz = sb.sb_src.shape[0]
    s = min(s_band, a_sz)
    bin_offset, inv_quant = bin_constants(window_size, quant_size)
    f32 = torch.float32
    lw = sb.lw_map.long()
    q_lw, k_aux, v_aux = sparse_inputs(q, k, v, sb, scale)
    inputs = (
        q_lw.contiguous(), g.to(f32)[lw].contiguous(),
        o.to(f32)[lw].contiguous(), m.to(f32)[lw].contiguous(),
        den.to(f32)[lw].contiguous(), sb.xyz_lw.to(f32).contiguous(),
        sb.valid_lw.to(torch.bool).contiguous(),
        sb.q_skey_lw.to(torch.int32).contiguous(),
        sb.sb_start.to(torch.int32).contiguous(),
        sb.sb_end.to(torch.int32).contiguous(), k_aux.contiguous(),
        v_aux.contiguous(), sb.sb_xyz.to(f32).contiguous(),
        sb.sb_valid.to(torch.bool).contiguous(),
        sb.sb_skey.to(torch.int32).contiguous()) + pack_tables(tables, 0, nb)
    nblk = n // rows
    outs = (torch.empty((n, h, d), dtype=f32, device=dev),
            torch.zeros((nblk, s, h, d), dtype=f32, device=dev),
            torch.zeros((nblk, s, h, d), dtype=f32, device=dev),
            torch.empty((nblk, h, 3, 3, nb, d), dtype=f32, device=dev))
    args = tuple(ptr(t) for t in inputs + outs) + (
        n, a_sz, h, d, tile, s, nb, bin_offset, inv_quant, float(scale),
        stream_of(dev))
    return args, outs, inputs


def sparse_band_attention_bwd(q, k, v, sb, g, o, m, den, table_q=None,
                              table_k=None, table_v=None, *, window_size,
                              quant_size, scale, s_band=128, tile=128):
    """Backward of the far-key half; arguments and the returned
    ``(dq, dk, dv, dtq, dtk, dtv)`` (small-window order) as
    `sparse_band_attention_bwd_plain`."""
    kw = dict(window_size=window_size, quant_size=quant_size, scale=scale,
              s_band=s_band, tile=tile)
    tables = (table_q, table_k, table_v)
    if q.device.type == "cpu":
        return sparse_band_attention_bwd_plain(q, k, v, sb, g, o, m, den,
                                               *tables, **kw)
    args, (dq_lw, dk_part, dv_part, dt_part), _inputs = launch_args(
        q, k, v, sb, g, o, m, den, *tables, **kw)
    with torch.cuda.device(q.device):
        KERNEL(*args)
    n = q.shape[0]
    bases = sparse_window(sb, tile, s_band)[1]
    dk_part, dv_part = (part.view(n // tile, -1, *part.shape[1:]).sum(1)
                        for part in (dk_part, dv_part))
    return sparse_bwd_finish(sb, dq_lw, dk_part, dv_part, bases) + \
        sum_table_partials(dt_part, tables)
