"""Stratified attention as one autograd Function over the plain PyTorch
versions (a frozen copy of the port's ``ops/attention_fused.py`` with its
kernel wrappers taken out: this is the ``attn_impl: reference`` path).
Forward: the dense half and the far-key half each return an unnormalised
triple, and `merge` composes them. Backward: both halves' plain backward
functions run on the merged statistics and output, and their gradients
add. ``fast``: False is fp32; True the bf16 operand rounding of the
shipped YAMLs; a callable rounds every product operand with it (the
benchmark's lower-precision control)."""

from __future__ import annotations

import torch

from reference.ops.attention import (
    band_attention_bwd_plain, band_attention_plain, merge,
    sparse_band_attention_bwd_plain, sparse_band_attention_plain)


class StratifiedAttention(torch.autograd.Function):
    """``apply(q, k, v, table_q, table_k, table_v, geometry, opts)``:
    ``geometry`` is ``(xyz, seg_start, seg_end, valid, sparse_band)`` and
    ``opts`` the keyword options of `stratified_attention_fused`."""

    @staticmethod
    def forward(ctx, q, k, v, table_q, table_k, table_v, geometry, opts):
        xyz, seg_start, seg_end, valid, sb = geometry
        tables = (table_q, table_k, table_v)
        kw = dict(window_size=opts["window_size"],
                  quant_size=opts["quant_size"], scale=opts["scale"],
                  tile=opts["tile"], fast=opts["fast"])
        band_fn = band_attention_plain
        parts = [band_fn(q, k, v, xyz, seg_start, seg_end, valid, *tables,
                         **kw, band=opts["band"],
                         rpe_mode=opts["rpe_mode"])]
        if sb is not None:
            sparse_fn = sparse_band_attention_plain
            parts.append(sparse_fn(q, k, v, sb, *tables, **kw,
                                   s_band=opts["s_band"]))
        out, m, den = merge(parts)
        ctx.save_for_backward(q, k, v, table_q, table_k, table_v, m, den,
                              out)
        ctx.geometry = geometry
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, table_q, table_k, table_v, m, den, out = ctx.saved_tensors
        xyz, seg_start, seg_end, valid, sb = ctx.geometry
        opts = ctx.opts
        tables = (table_q, table_k, table_v)
        kw = dict(window_size=opts["window_size"],
                  quant_size=opts["quant_size"], scale=opts["scale"],
                  tile=opts["tile"], fast=opts["fast"])
        g = g.to(torch.float32).contiguous()
        band_fn = band_attention_bwd_plain
        grads = band_fn(q, k, v, xyz, seg_start, seg_end, valid, g, out, m,
                        den, *tables, **kw, band=opts["band"],
                        rpe_mode=opts["rpe_mode"])
        if sb is not None:
            sparse_fn = sparse_band_attention_bwd_plain
            sgrads = sparse_fn(q, k, v, sb, g, out, m, den, *tables, **kw,
                               s_band=opts["s_band"])
            grads = tuple(a if b is None else (b if a is None else a + b)
                          for a, b in zip(grads, sgrads))
        dq, dk, dv, dtq, dtk, dtv = (
            None if x is None else x.to(y.dtype)
            for x, y in zip(grads, (q, k, v) + tables))
        return dq, dk, dv, dtq, dtk, dtv, None, None


def stratified_attention_fused(q, k, v, xyz, seg_start, seg_end, valid,
                               sparse_band=None, table_q=None, table_k=None,
                               table_v=None, *, window_size, quant_size,
                               scale, band, tile=128, s_band=128,
                               plain=False, fast=False,
                               rpe_mode="stratified"):
    """``[N, h, d]`` attention output in window-sorted order, differentiable
    in q, k, v and the three tables.

    ``plain=True`` runs the plain PyTorch versions on any device, forward
    and backward (the ``attn_impl: reference`` model path, which the chip
    smoke run compares the kernels against). ``fast=True``: the bf16 forms.
    ``rpe_mode``: "stratified" or "swin_window" (no ``sparse_band``).
    """
    if rpe_mode == "swin_window" and sparse_band is not None:
        raise ValueError("rpe_mode 'swin_window' is window-dense only: far "
                         "keys (a sparse_band layout) are refused")
    opts = dict(window_size=window_size, quant_size=quant_size, scale=scale,
                band=band, tile=tile, s_band=s_band, plain=plain, fast=fast,
                rpe_mode=rpe_mode)
    return StratifiedAttention.apply(
        q, k, v, table_q, table_k, table_v,
        (xyz, seg_start, seg_end, valid, sparse_band), opts)
