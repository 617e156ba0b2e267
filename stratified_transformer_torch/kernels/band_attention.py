"""Wrapper of the dense-half CUDA kernel (``csrc/band_attention.cu``)."""

from __future__ import annotations

import torch

from stratified_transformer_torch.kernels import (
    CudaKernel, F, I, P, block_limits, check_cuda_inputs, head_rows,
    occupancy, ptr, stream_of)
from stratified_transformer_torch.ops.attention import (
    band_attention_plain, band_slice, bin_constants, num_bins)

ARGTYPES = [P] * 13 + [I] * 12 + [F, F, F, P]
KERNEL = CudaKernel("band_attention", "band_attention_fwd", ARGTYPES)
# the bf16 form (rpe_precision/qk_precision: default), on the tensor cores;
# the same arguments
KERNEL_FAST = CudaKernel("band_attention", "band_attention_fwd_bf16",
                         ARGTYPES)
BIN_PROBE = CudaKernel(
    "band_attention", "rel_bin_probe", [P, P, I, F, F, I, I, I, I, P])

# head sizes the kernels are instantiated for (csrc/*.cu)
HEAD_DIMS = (16,)


def launch_args(q, k, v, xyz, seg_start, seg_end, valid,
                table_q=None, table_k=None, table_v=None, *,
                window_size, quant_size, scale, band, tile=128, fast=False,
                rpe_mode="stratified"):
    """Output buffers and ``KERNEL`` (``KERNEL_FAST`` with ``fast``)
    arguments for CUDA inputs: returns ``(args, (acc, m, den), inputs)``;
    ``KERNEL(*args)`` fills the outputs.
    Both forms read q, k, v (the model's strided views pass as they are)
    and the model's tables in place; the fast one rounds its bf16 operands
    as it stages them. ``inputs`` holds what the kernel reads (the tables
    as their band slices). The argument tuple holds raw pointers, so
    keep the returned buffers alive while it is used."""
    tables = (table_q, table_k, table_v)
    dev = check_cuda_inputs(
        "band_attention", (q, k, v, xyz, seg_start, seg_end, valid) + tables)
    n, h, d = q.shape
    nb_full = num_bins(*tables)
    bin_lo, nb = band_slice(nb_full, rpe_mode)
    rows, max_nb = block_limits("band_attention", dev, fast=fast,
                                swin=rpe_mode == "swin_window")
    if d not in HEAD_DIMS or tile <= 0 or n % tile or tile % rows:
        raise ValueError(
            f"band_attention: unsupported shape N={n}, d={d}, tile={tile} "
            f"(a multiple of {rows} rows)")
    if nb > max_nb:
        raise ValueError(
            f"band_attention: {nb} table rows per axis (of "
            f"{nb_full}) do not fit a {rows}-row block's shared memory on "
            f"{dev}, which holds at most {max_nb}")
    bin_offset, inv_quant = bin_constants(window_size, quant_size)
    (q, q_rs), (k, k_rs), (v, v_rs) = (head_rows(t) for t in (q, k, v))
    tables = tuple(None if t is None else t.to(torch.float32).contiguous()
                   for t in tables)
    geom = (xyz.to(torch.float32).contiguous(),
            seg_start.to(torch.int32).contiguous(),
            seg_end.to(torch.int32).contiguous(),
            valid.to(torch.bool).contiguous())
    outs = (torch.empty((n, h, d), dtype=torch.float32, device=dev),
            torch.empty((n, h), dtype=torch.float32, device=dev),
            torch.empty((n, h), dtype=torch.float32, device=dev))
    args = tuple(ptr(t) for t in (q, k, v) + geom + tables + outs) + (
        n, h, d, q_rs, k_rs, v_rs, tile, band, nb, bin_lo, nb_full,
        int(rpe_mode == "swin_window"), bin_offset, inv_quant, float(scale),
        stream_of(dev))
    inputs = (q, k, v) + geom + tuple(
        None if t is None else t[bin_lo:bin_lo + nb] for t in tables)
    return args, outs, inputs


def blocks_per_sm(dev, nb, rpe_mode="stratified"):
    """Blocks of the fp32 kernel's launch for tables of ``nb`` rows per
    axis that one SM of the CUDA device ``dev`` holds at once (on the H100:
    2 in the stratified bins and in the swin mode's 64-row blocks)."""
    return occupancy("band_attention", dev, nb, rpe_mode)


def band_attention(q, k, v, xyz, seg_start, seg_end, valid,
                   table_q=None, table_k=None, table_v=None, *,
                   window_size, quant_size, scale, band, tile=128,
                   fast=False, rpe_mode="stratified"):
    """Dense half of stratified attention; arguments and the returned triple
    ``(acc [N,h,d], m [N,h], den [N,h])`` as `band_attention_plain`
    (``rpe_mode`` "swin_window": the kernel's swin mode)."""
    kw = dict(window_size=window_size, quant_size=quant_size, scale=scale,
              band=band, tile=tile, fast=fast, rpe_mode=rpe_mode)
    if q.device.type == "cpu":
        return band_attention_plain(q, k, v, xyz, seg_start, seg_end, valid,
                                    table_q, table_k, table_v, **kw)
    args, outs, _inputs = launch_args(q, k, v, xyz, seg_start, seg_end,
                                      valid, table_q, table_k, table_v, **kw)
    with torch.cuda.device(q.device):
        (KERNEL_FAST if fast else KERNEL)(*args)
    return outs


def rel_bins(rel, window_size, quant_size, num_bins_full, bin_lo=0, nb=None,
             rpe_mode="stratified"):
    """Bins the kernels compute on the card for ``rel`` (a CUDA float32
    tensor of one axis's relative coordinates, or in the "swin_window" mode
    of its differences of quantized positions), for checking them against
    `relative_position_index` (`swin_relative_position_index`)."""
    dev = check_cuda_inputs("rel_bins", (rel,))
    rel = rel.to(torch.float32).contiguous()
    out = torch.empty(rel.shape, dtype=torch.int32, device=dev)
    bin_offset, inv_quant = bin_constants(window_size, quant_size)
    with torch.cuda.device(dev):
        BIN_PROBE(ptr(rel), ptr(out), rel.numel(), bin_offset, inv_quant,
                  num_bins_full, bin_lo,
                  num_bins_full - bin_lo if nb is None else nb,
                  int(rpe_mode == "swin_window"), stream_of(dev))
    return out
