"""Shared model building blocks (the JAX package's ``models/layers.py``).

Module and parameter names mirror the flax ones (``norm``, ``linear``,
``fc1``...) so that `convert.from_flax` is a mechanical walk. Mirrors the
reference sub-modules at ``model/stratified_transformer.py``: ``Mlp``
(:67-85), ``TransitionDown`` (:87-111), ``Upsample`` (:329-342).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from reference.ops.neighbors import (
    gather_group, interpolate_from_idx)


def dense(layer, x, dtype=None):
    """The ``nn.Linear`` ``layer`` applied to ``x``; with ``dtype`` (the
    config's ``compute_dtype``) computed in that dtype from the fp32
    parameters, as flax's ``Dense(dtype=...)`` (``layers.py:31-39`` of the
    JAX package): the product is rounded to ``dtype``, then the bias is
    added in ``dtype``."""
    if dtype is None:
        return layer(x)
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


def layer_norm(dim):
    """LayerNorm with the reference's epsilon (torch default 1e-5)."""
    return nn.LayerNorm(dim, eps=1e-5)


class _AllReduceSum(torch.autograd.Function):
    """``lax.psum`` as autograd sees it under ``shard_map``: the sum over
    the ranks of the default process group forward, and the sum of the
    ranks' cotangents backward (the transpose of a sum that every rank
    reads)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid points with running statistics (``layers.py:
    45-88``): ``(x - mean) * rsqrt(var + eps) * weight + bias``. Training
    mode normalises with the valid points' batch statistics and updates the
    buffers in place, torch style: ``(1 - momentum) * running + momentum *
    batch``, the variance unbiased (``var * cnt / (cnt - 1)``). Buffers
    ``mean``/``var`` hold the flax ``batch_stats``.

    ``sync`` (SyncBN, the JAX package's ``axis_name``): in training mode
    the sums ``(s1, s2, cnt)`` are summed over the ranks of the default
    process group before the mean and variance, in one differentiable
    all-reduce (`_AllReduceSum`), so every rank normalises with the global
    statistics and updates its buffers alike. Eval mode issues no
    collective."""

    def __init__(self, dim, epsilon=1e-5, momentum=0.1, sync=False):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.sync = sync
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x, valid):
        xf = x.to(torch.float32)
        if self.training:
            w = valid.to(torch.float32)[:, None]
            s1, s2, cnt = (xf * w).sum(0), (xf * xf * w).sum(0), w.sum()
            if self.sync:
                c = s1.shape[0]
                packed = _AllReduceSum.apply(
                    torch.cat([s1, s2, cnt.reshape(1)]))
                s1, s2, cnt = packed[:c], packed[c:2 * c], packed[2 * c]
            count = cnt.clamp_min(1.0)
            mean = s1 / count
            var = (s2 / count - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                unbiased = var * count / (count - 1.0).clamp_min(1.0)
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var + m * unbiased)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.weight + self.bias).to(x.dtype)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (reference :67-85; dropout 0), computed in
    ``dtype`` if given (`dense`)."""

    def __init__(self, dim, hidden, out, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        h = F.gelu(dense(self.fc1, x, self.dtype), approximate="none")
        return dense(self.fc2, h, self.dtype)


def drop_path(x, rate, generator):
    """Per-point stochastic depth (``layers.py:111-118``, timm ``DropPath``):
    each row is kept with probability ``1 - rate`` and scaled by
    ``1 / (1 - rate)``. The keep mask is drawn from ``generator`` (a
    ``torch.Generator`` on ``x``'s device), so a seed fixes it."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape[0], generator=generator,
                      device=x.device) < keep
    return torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)), x / keep,
                       torch.zeros_like(x))


class TransitionDown(nn.Module):
    """Downsample + kNN max-pool (reference :87-111) over one ``down`` level
    of a geometry pyramid, from the host or `models.stratified.
    geometry_pyramid`.

    LayerNorm and Linear act per row, so all support points are normalised
    and projected once and gathered afterwards.
    """

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.norm = layer_norm(in_channels)
        self.linear = nn.Linear(in_channels, out_channels, bias=False)

    def forward(self, feats, xyz, precomp):
        """``precomp``: one ``down`` level of the pyramid. Returns
        ``(pooled feats, pooled xyz, new offsets)``."""
        idx = precomp["idx"]
        out_valid = precomp["valid"]
        projected = self.linear(self.norm(feats))
        gathered = gather_group(projected, precomp["knn_idx"],
                                precomp["knn_mask"], fill=-float("inf"))
        # amax splits the gradient evenly among tied maxima, as JAX's max
        pooled = gathered.amax(1)
        pooled = torch.where(out_valid[:, None], pooled,
                             torch.zeros_like(pooled))
        return pooled, xyz[idx], precomp["offsets"]


class Upsample(nn.Module):
    """``linear1(norm1(skip)) + 3NN-interp(linear2(norm2(feats)))``
    (reference :329-342)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.norm2 = layer_norm(in_channels)
        self.linear2 = nn.Linear(in_channels, out_channels)
        self.norm1 = layer_norm(out_channels)
        self.linear1 = nn.Linear(out_channels, out_channels)

    def forward(self, feats, xyz, skip_feats, skip_xyz, precomp):
        lifted = self.linear2(self.norm2(feats))
        interp = interpolate_from_idx(skip_xyz, xyz, lifted, precomp["idx"],
                                      precomp["mask"])
        return self.linear1(self.norm1(skip_feats)) + interp
