"""Swin3D, the fixed-window baseline (the JAX package's
``models/swin3d.py``; reference ``model/swin3d_transformer.py:364-453``).

The Stratified backbone without stratified far keys (dense in-window pairs
only) and with Swin3D's own cRPE bins: each point's window-quantized
position ``u = floor(((xyz - origin + shift) mod window) / quant)``, bins
``u_i - u_j + qgl - 1`` over ``2*qgl - 1`` table rows. In the port, as in
the JAX package, that is `Stratified` with ``use_stratified=False,
rpe_mode="swin_window"``, so Swin3D is a construction helper rather than a
second code path; its attention runs through the band kernels' swin mode.
"""

from __future__ import annotations

import dataclasses

from stratified_transformer_torch.config import StratifiedConfig
from stratified_transformer_torch.models.stratified import Stratified


def Swin3D(cfg: StratifiedConfig) -> Stratified:
    """Build the fixed-window (non-stratified) baseline model."""
    return Stratified(dataclasses.replace(cfg, use_stratified=False,
                                          rpe_mode="swin_window"))
