"""WindowAttention + transformer block (the JAX package's
``models/attention.py``; reference ``model/stratified_transformer.py:
114-248``).

Fused QKV projection, contextual RPE tables of shape ``(2*qgl, heads,
head_dim, 3)`` (``(2*qgl - 1, ...)`` with Swin3D's window-quantized bins,
``rpe_mode="swin_window"``), attention in fp32 or in the kernels' bf16
forms (``fast``),
pre-LN residual blocks with drop-path in training mode. ``dtype`` (the
config's ``compute_dtype``) computes the qkv, proj, fc1 and fc2 products in
that dtype with fp32 parameters (``models/attention.py:67-68,142`` of the
JAX package).
"""

from __future__ import annotations

import torch
from torch import nn

from reference.models.layers import (
    Mlp, dense, drop_path, layer_norm)
from reference.ops.attention_fused import (
    stratified_attention_fused)


def swin_positions(xyz_sorted, origin, shift_size, window_size, quant_size):
    """Each point's window-quantized position ``u = floor(((xyz - origin +
    shift) mod window) / quant)`` (``models/attention.py:84-100`` of the
    JAX package; reference ``swin3d_transformer.py:151-154``): the
    coordinates whose differences Swin3D's bins take. fp32 throughout, with
    ``torch.remainder`` (fmod, then the divisor's sign, as ``jnp.mod``) and
    the constants as fp32 tensors on the points' device (PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal), so every
    device gets JAX's values bit for bit."""
    def const(x):        # rounded to fp32 first, as JAX's weak scalars
        return torch.tensor(x, dtype=torch.float32, device=xyz_sorted.device)

    r = torch.remainder(xyz_sorted.to(torch.float32) - origin.to(
        torch.float32) + const(shift_size), const(window_size))
    return torch.floor(r / const(quant_size))


class WindowAttention(nn.Module):
    def __init__(self, dim, num_heads, window_size, quant_size, *, band,
                 tile, s_band, rel_query=True, rel_key=True, rel_value=True,
                 plain=False, fast=False, dtype=None, rpe_mode="stratified",
                 shift_size=0.0):
        super().__init__()
        self.rpe_mode = rpe_mode
        self.shift_size = shift_size
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
        if rpe_mode == "swin_window":
            # 2*qgl - 1 rows, qgl = int(window/quant) (reference
            # swin3d_transformer.py:109-118)
            nbins = 2 * int(window_size / quant_size) - 1
        else:
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
        xyz = plan.xyz_sorted
        if self.rpe_mode == "swin_window":
            # the plan's window-grid origin, as the windows themselves
            xyz = swin_positions(xyz, plan.grid_start, self.shift_size,
                                 self.window_size, self.quant_size)
        out_sorted = stratified_attention_fused(
            q, k, v, xyz, plan.seg_start, plan.seg_end,
            plan.valid_sorted, plan.sparse_band, self.rel_query_table,
            self.rel_key_table, self.rel_value_table,
            window_size=self.window_size, quant_size=self.quant_size,
            scale=self.scale, band=self.band, tile=self.tile,
            s_band=self.s_band, plain=self.plain, fast=self.fast,
            rpe_mode=self.rpe_mode)
        out = out_sorted[plan.inv_order.long()].reshape(n, c).to(feats.dtype)
        return dense(self.proj, out, self.dtype)


class Block(nn.Module):
    """Pre-LN attention + MLP, each branch through drop-path in training
    mode (reference :219-248; ``models/attention.py:175-203``)."""

    def __init__(self, dim, num_heads, window_size, quant_size, *, band,
                 tile, s_band, mlp_ratio=4.0, rel_query=True, rel_key=True,
                 rel_value=True, plain=False, drop_path_rate=0.0, fast=False,
                 dtype=None, rpe_mode="stratified", shift_size=0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = layer_norm(dim)
        self.attn = WindowAttention(
            dim, num_heads, window_size, quant_size, band=band, tile=tile,
            s_band=s_band, rel_query=rel_query, rel_key=rel_key,
            rel_value=rel_value, plain=plain, fast=fast, dtype=dtype,
            rpe_mode=rpe_mode, shift_size=shift_size)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype)

    def forward(self, feats, plan, generator=None):
        """``generator`` draws the drop-path masks (training mode only)."""
        rate = self.drop_path_rate if self.training else 0.0
        feats = feats + drop_path(self.attn(self.norm1(feats), plan), rate,
                                  generator)
        return feats + drop_path(self.mlp(self.norm2(feats)), rate,
                                 generator)
