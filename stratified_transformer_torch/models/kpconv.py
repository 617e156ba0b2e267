"""Kernel Point Convolution stem (the JAX package's ``models/kpconv.py``).

15 kernel points in a ball of radius ``1.5 * point_influence``, linear
influence ``max(0, 1 - |x_n - x_q - k_p| / point_influence)``, "sum"
aggregation, one ``(in, out)`` weight matrix per kernel point (reference
stem ``model/stratified_transformer.py:344-392``): `KPConvSimpleBlock`, and
the residual `KPConvResBlock` that the ScanNet family adds after it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from stratified_transformer_torch.models.layers import MaskedBatchNorm

_INFLUENCE_TO_RADIUS = 1.5


def generate_kernel_points(radius, num_points=15, seed=0, iters=300):
    """Deterministic repulsion layout of kernel points in a ball (copied
    from the JAX package so both place the same points).

    Point 0 is fixed at the origin; the others repel each other
    (inverse-square) and are softly attracted inward, then the layout is
    scaled so the mean radius is ~0.66 * radius.
    """
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(num_points, 3))
    pts[0] = 0.0
    pts /= max(np.abs(pts).max(), 1e-6)
    step = 0.01
    for _ in range(iters):
        diff = pts[:, None, :] - pts[None, :, :]
        d = np.linalg.norm(diff, axis=-1) + 1e-6
        np.fill_diagonal(d, np.inf)
        force = (diff / d[..., None] ** 3).sum(1)
        force -= 0.5 * pts * (np.linalg.norm(pts, axis=-1, keepdims=True))
        pts[1:] += step * np.clip(force[1:], -1.0, 1.0)
        r = np.linalg.norm(pts[1:], axis=-1, keepdims=True)
        pts[1:] = np.where(r > 1.0, pts[1:] / r, pts[1:])
    shell = np.linalg.norm(pts[1:], axis=-1).mean()
    pts = pts / max(shell, 1e-6) * 0.66
    return (pts * radius).astype(np.float32)


class KPConv(nn.Module):
    def __init__(self, in_channels, out_channels, point_influence,
                 num_kernel_points=15):
        super().__init__()
        self.point_influence = point_influence
        self.kernel_weights = nn.Parameter(
            torch.empty(num_kernel_points, in_channels, out_channels))
        self.register_buffer(
            "kernel_points",
            torch.from_numpy(generate_kernel_points(
                _INFLUENCE_TO_RADIUS * point_influence, num_kernel_points)),
            persistent=False)

    def forward(self, feats, xyz, neighbor_idx, neighbor_mask):
        """feats ``[N, C]``, xyz ``[N, 3]``, neighbor_idx ``[N, K]`` (into
        the same point set), neighbor_mask ``[N, K]`` bool."""
        diff = xyz[neighbor_idx] - xyz[:, None, :]                  # [N,K,3]
        d = torch.linalg.norm(
            diff[:, :, None, :] - self.kernel_points[None, None], dim=-1)
        infl = torch.clamp(1.0 - d / self.point_influence, min=0.0)
        mask = neighbor_mask[:, :, None]
        infl = torch.where(mask, infl, torch.zeros_like(infl))      # [N,K,P]
        gathered = feats[neighbor_idx]
        gathered = torch.where(mask, gathered, torch.zeros_like(gathered))
        per_kernel = torch.einsum("nkp,nkc->npc", infl, gathered)
        return torch.einsum("npc,pcd->nd", per_kernel, self.kernel_weights)


class KPConvSimpleBlock(nn.Module):
    """KPConv -> BN (momentum 0.02) -> LeakyReLU(0.2) (reference
    :344-359)."""

    def __init__(self, in_channels, out_channels, point_influence,
                 negative_slope=0.2):
        super().__init__()
        self.negative_slope = negative_slope
        self.kpconv = KPConv(in_channels, out_channels, point_influence)
        self.bn = MaskedBatchNorm(out_channels, momentum=0.02)

    def forward(self, feats, xyz, neighbor_idx, neighbor_mask, valid):
        x = self.kpconv(feats, xyz, neighbor_idx, neighbor_mask)
        return F.leaky_relu(self.bn(x, valid), self.negative_slope)


class KPConvResBlock(nn.Module):
    """Bottleneck residual KPConv (reference :362-392; the JAX package's
    ``models/kpconv.py:115-147``): ``unary1`` to ``out / 4`` channels -> BN
    -> LeakyReLU -> KPConv -> ``unary2`` -> BN -> LeakyReLU, plus the input,
    or its ``shortcut`` projection and BN where the channels differ. The
    unaries are bias-free; every BN has momentum 0.02."""

    def __init__(self, in_channels, out_channels, point_influence,
                 negative_slope=0.2):
        super().__init__()
        d2 = out_channels // 4
        self.negative_slope = negative_slope
        self.unary1 = nn.Linear(in_channels, d2, bias=False)
        self.bn1 = MaskedBatchNorm(d2, momentum=0.02)
        self.kpconv = KPConv(d2, d2, point_influence)
        self.unary2 = nn.Linear(d2, out_channels, bias=False)
        self.bn2 = MaskedBatchNorm(out_channels, momentum=0.02)
        if in_channels != out_channels:
            self.shortcut = nn.Linear(in_channels, out_channels, bias=False)
            self.bn_sc = MaskedBatchNorm(out_channels, momentum=0.02)

    def forward(self, feats, xyz, neighbor_idx, neighbor_mask, valid):
        def act(t):
            return F.leaky_relu(t, self.negative_slope)

        x = act(self.bn1(self.unary1(feats), valid))
        x = self.kpconv(x, xyz, neighbor_idx, neighbor_mask)
        x = act(self.bn2(self.unary2(x), valid))
        if hasattr(self, "shortcut"):
            return x + self.bn_sc(self.shortcut(feats), valid)
        return x + feats
