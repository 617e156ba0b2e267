"""Wrapper of the dense-half backward CUDA kernel
(``csrc/band_attention_bwd.cu``).

The kernel leaves dk/dv per key slot of each (tile, row slice) and the
table grads per (tile, slice, head); adding the slices, composing the slots
by absolute key position, summing the table partials over tiles and
placing them at ``bin_lo`` are plain PyTorch around it, as the JAX
package's wrapper does them outside the ``pallas_call``.
"""

from __future__ import annotations

import torch

from stratified_transformer_torch.kernels import (
    CudaKernel, F, I, P, block_limits, check_cuda_inputs, occupancy,
    pack_tables, pack_tables_bf16, ptr, rows16, stage_bf16, stream_of,
    sum_table_partials, xyz_valid)
from stratified_transformer_torch.ops.attention import (
    band_attention_bwd_plain, band_slice, bin_constants, compose_band,
    num_bins, place_table_grads)

ARGTYPES = [P] * 18 + [I] * 9 + [F, F, F, P]
KERNEL = CudaKernel("band_attention_bwd", "band_attention_bwd", ARGTYPES)
# the bf16 form (rpe_precision/qk_precision: default), on the tensor cores:
# bf16 q, k, v, g and tables, the fp32 g, (x, y, z, valid) point records
KERNEL_FAST = CudaKernel("band_attention_bwd", "band_attention_bwd_bf16",
                         ARGTYPES)

# head sizes the kernels are instantiated for (csrc/*.cu)
HEAD_DIMS = (16,)


def launch_args(q, k, v, xyz, seg_start, seg_end, valid, g, o, m, den,
                table_q=None, table_k=None, table_v=None, *, window_size,
                quant_size, scale, band, tile=128, fast=False,
                rpe_mode="stratified"):
    """Device buffers and ``KERNEL`` (``KERNEL_FAST`` with ``fast``)
    arguments for CUDA inputs: returns
    ``(args, (dq, dk_part, dv_part, dt_part), inputs)``; ``KERNEL(*args)``
    fills the outputs. The argument tuple holds raw pointers, so keep the
    returned buffers alive while it is used."""
    tables = (table_q, table_k, table_v)
    dev = check_cuda_inputs(
        "band_attention_bwd",
        (q, k, v, xyz, seg_start, seg_end, valid, g, o, m, den) + tables)
    n, h, d = q.shape
    nb_full = num_bins(*tables)
    bin_lo, nb = band_slice(nb_full, rpe_mode)
    rows, max_nb = block_limits("band_attention_bwd", dev, nb, fast,
                                swin=rpe_mode == "swin_window")
    if nb > max_nb:
        raise ValueError(
            f"band_attention_bwd: {nb} table rows per axis "
            f"(of {nb_full}) do not fit any block's shared memory on "
            f"{dev}, which holds at most {max_nb}")
    if d not in HEAD_DIMS or tile <= 0 or n % tile or tile % rows:
        raise ValueError(
            f"band_attention_bwd: unsupported shape N={n}, d={d}, "
            f"tile={tile} (a multiple of {rows} rows)")
    bin_offset, inv_quant = bin_constants(window_size, quant_size)
    f32 = torch.float32
    segs = (seg_start.to(torch.int32).contiguous(),
            seg_end.to(torch.int32).contiguous())
    res = (o.to(f32).contiguous(), m.to(f32).contiguous(),
           den.to(f32).contiguous())
    if fast:
        # bf16 operands (q rounded after its fp32 scaling), the fp32 g for
        # g·o, and the points as (x, y, z, valid) records
        inputs = ((stage_bf16(q, scale), stage_bf16(k), stage_bf16(v),
                   stage_bf16(g), g.to(f32).contiguous()) + res
                  + (xyz_valid(xyz, valid),) + segs
                  + pack_tables_bf16(tables, bin_lo, nb))
    else:
        inputs = (
            (q.to(f32) * scale).contiguous(), rows16(k), rows16(v),
            xyz.to(f32).contiguous()) + segs + (
            valid.to(torch.bool).contiguous(), rows16(g)) \
            + res + pack_tables(tables, bin_lo, nb)
    nblk = n // rows
    outs = (torch.empty((n, h, d), dtype=f32, device=dev),
            torch.zeros((nblk, tile + 2 * band, h, d), dtype=f32, device=dev),
            torch.zeros((nblk, tile + 2 * band, h, d), dtype=f32, device=dev),
            torch.empty((nblk, h, 3, 3, nb, d), dtype=f32, device=dev))
    args = tuple(ptr(t) for t in inputs + outs) + (
        n, h, d, tile, band, nb, bin_lo, nb_full,
        int(rpe_mode == "swin_window"), bin_offset, inv_quant, float(scale),
        stream_of(dev))
    return args, outs, inputs


def blocks_per_sm(dev, nb, rpe_mode="stratified"):
    """Blocks of the fp32 kernel's launch for tables of ``nb`` rows per
    axis that one SM of the CUDA device ``dev`` holds at once (on the H100:
    1 in the stratified bins, 2 in the swin mode's 32-row blocks)."""
    return occupancy("band_attention_bwd", dev, nb, rpe_mode)


def band_attention_bwd(q, k, v, xyz, seg_start, seg_end, valid, g, o, m, den,
                       table_q=None, table_k=None, table_v=None, *,
                       window_size, quant_size, scale, band, tile=128,
                       fast=False, rpe_mode="stratified"):
    """Backward of the dense half; arguments and the returned
    ``(dq, dk, dv, dtq, dtk, dtv)`` as `band_attention_bwd_plain`."""
    kw = dict(window_size=window_size, quant_size=quant_size, scale=scale,
              band=band, tile=tile, fast=fast, rpe_mode=rpe_mode)
    tables = (table_q, table_k, table_v)
    if q.device.type == "cpu":
        return band_attention_bwd_plain(q, k, v, xyz, seg_start, seg_end,
                                        valid, g, o, m, den, *tables, **kw)
    args, (dq, dk_part, dv_part, dt_part), _inputs = launch_args(
        q, k, v, xyz, seg_start, seg_end, valid, g, o, m, den, *tables, **kw)
    with torch.cuda.device(q.device):
        (KERNEL_FAST if fast else KERNEL)(*args)
    n = q.shape[0]
    nb_full = num_bins(*tables)
    bin_lo = band_slice(nb_full, rpe_mode)[0]
    dk, dv = (compose_band(part.view(n // tile, -1, *part.shape[1:]).sum(1),
                           band, tile, n)
              for part in (dk_part, dv_part))
    return (dq, dk, dv) + place_table_grads(
        sum_table_partials(dt_part, tables), bin_lo, nb_full)
