"""WindowAttention + transformer block (the JAX package's
``models/attention.py``; reference ``model/stratified_transformer.py:
114-248``).

Fused QKV projection, contextual RPE tables of shape ``(2*qgl, heads,
head_dim, 3)``, attention in fp32 or in the kernels' bf16 forms (``fast``),
pre-LN residual blocks with drop-path in training mode. ``dtype`` (the
config's ``compute_dtype``) computes the qkv, proj, fc1 and fc2 products in
that dtype with fp32 parameters (``models/attention.py:67-68,142`` of the
JAX package).
"""

from __future__ import annotations

import torch
from torch import nn

from stratified_transformer_torch.models.layers import (
    Mlp, dense, drop_path, layer_norm)
from stratified_transformer_torch.ops.attention_fused import (
    stratified_attention_fused)


class WindowAttention(nn.Module):
    def __init__(self, dim, num_heads, window_size, quant_size, *, band,
                 tile, s_band, rel_query=True, rel_key=True, rel_value=True,
                 plain=False, fast=False, dtype=None):
        super().__init__()
        self.fast = fast
        self.dtype = dtype
        self.dim = dim
        self.num_heads = num_heads
        self.window_size = window_size
        self.quant_size = quant_size
        self.band = band
        self.tile = tile
        self.s_band = s_band
        self.plain = plain
        d = dim // num_heads
        self.scale = d ** -0.5
        # quant_grid_length, reference :142
        nbins = 2 * int((2 * window_size + 1e-4) // quant_size)
        self.qkv = nn.Linear(dim, 3 * dim)
        for name, on in (("rel_query_table", rel_query),
                         ("rel_key_table", rel_key),
                         ("rel_value_table", rel_value)):
            self.register_parameter(
                name, nn.Parameter(torch.empty(nbins, num_heads, d, 3))
                if on else None)
        self.proj = nn.Linear(dim, dim)

    def forward(self, feats, plan):
        n, c = feats.shape
        h = self.num_heads
        qkv = dense(self.qkv, feats, self.dtype).reshape(n, 3, h, c // h)
        o = plan.order.long()
        q, k, v = qkv[o].unbind(1)
        out_sorted = stratified_attention_fused(
            q, k, v, plan.xyz_sorted, plan.seg_start, plan.seg_end,
            plan.valid_sorted, plan.sparse_band, self.rel_query_table,
            self.rel_key_table, self.rel_value_table,
            window_size=self.window_size, quant_size=self.quant_size,
            scale=self.scale, band=self.band, tile=self.tile,
            s_band=self.s_band, plain=self.plain, fast=self.fast)
        out = out_sorted[plan.inv_order.long()].reshape(n, c).to(feats.dtype)
        return dense(self.proj, out, self.dtype)


class Block(nn.Module):
    """Pre-LN attention + MLP, each branch through drop-path in training
    mode (reference :219-248; ``models/attention.py:175-203``)."""

    def __init__(self, dim, num_heads, window_size, quant_size, *, band,
                 tile, s_band, mlp_ratio=4.0, rel_query=True, rel_key=True,
                 rel_value=True, plain=False, drop_path_rate=0.0, fast=False,
                 dtype=None):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = layer_norm(dim)
        self.attn = WindowAttention(
            dim, num_heads, window_size, quant_size, band=band, tile=tile,
            s_band=s_band, rel_query=rel_query, rel_key=rel_key,
            rel_value=rel_value, plain=plain, fast=fast, dtype=dtype)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype)

    def forward(self, feats, plan, generator=None):
        """``generator`` draws the drop-path masks (training mode only)."""
        rate = self.drop_path_rate if self.training else 0.0
        feats = feats + drop_path(self.attn(self.norm1(feats), plan), rate,
                                  generator)
        return feats + drop_path(self.mlp(self.norm2(feats)), rate,
                                 generator)
