"""Stratified attention through the four kernels, as one autograd Function.

The JAX package's ``ops/attention_fused.py::stratified_attention_fused``
with its ``custom_vjp`` (``:256-305``). Forward: the dense half
(`band_attention`) and the far-key half (`sparse_band_attention`) each
return an unnormalised triple, and `merge` composes them; q, k, v, the
tables, the merged ``m``/``den`` and the output are saved. Backward: both
halves' backward kernels (`band_attention_bwd`, `sparse_band_attention_bwd`)
run on the same merged statistics and output, and their gradients add. On
the card every step is a CUDA kernel; on the CPU the wrappers run the plain
versions; ``plain=True`` runs the plain versions in both directions on any
device. ``fast=True`` selects every kernel's bf16 form (the JAX package's
``fast``: ``rpe_precision`` and ``qk_precision`` both "default",
``attention_fused.py:229``) in both directions, or the plain versions'.
``rpe_mode="swin_window"`` (Swin3D: window-quantized bins over the whole
table, ``xyz`` the points' quantized positions) runs the dense half alone:
the JAX package refuses far keys in that mode (``ops/attention.py:461-465``).
"""

from __future__ import annotations

import torch

from stratified_transformer_torch.kernels.band_attention import band_attention
from stratified_transformer_torch.kernels.band_attention_bwd import (
    band_attention_bwd)
from stratified_transformer_torch.kernels.sparse_band_attention import (
    sparse_band_attention)
from stratified_transformer_torch.kernels.sparse_band_attention_bwd import (
    sparse_band_attention_bwd)
from stratified_transformer_torch.ops.attention import (
    band_attention_bwd_plain, band_attention_plain, merge,
    sparse_band_attention_bwd_plain, sparse_band_attention_plain)


class StratifiedAttention(torch.autograd.Function):
    """``apply(q, k, v, table_q, table_k, table_v, geometry, opts)``:
    ``geometry`` is ``(xyz, seg_start, seg_end, valid, sparse_band)`` and
    ``opts`` the keyword options of `stratified_attention_fused`."""

    @staticmethod
    def forward(ctx, q, k, v, table_q, table_k, table_v, geometry, opts):
        xyz, seg_start, seg_end, valid, sb = geometry
        plain = opts["plain"]
        tables = (table_q, table_k, table_v)
        kw = dict(window_size=opts["window_size"],
                  quant_size=opts["quant_size"], scale=opts["scale"],
                  tile=opts["tile"], fast=opts["fast"])
        band_fn = band_attention_plain if plain else band_attention
        parts = [band_fn(q, k, v, xyz, seg_start, seg_end, valid, *tables,
                         **kw, band=opts["band"],
                         rpe_mode=opts["rpe_mode"])]
        if sb is not None:
            sparse_fn = (sparse_band_attention_plain if plain
                         else sparse_band_attention)
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
        plain = opts["plain"]
        tables = (table_q, table_k, table_v)
        kw = dict(window_size=opts["window_size"],
                  quant_size=opts["quant_size"], scale=opts["scale"],
                  tile=opts["tile"], fast=opts["fast"])
        g = g.to(torch.float32).contiguous()
        band_fn = band_attention_bwd_plain if plain else band_attention_bwd
        grads = band_fn(q, k, v, xyz, seg_start, seg_end, valid, g, out, m,
                        den, *tables, **kw, band=opts["band"],
                        rpe_mode=opts["rpe_mode"])
        if sb is not None:
            sparse_fn = (sparse_band_attention_bwd_plain if plain
                         else sparse_band_attention_bwd)
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
