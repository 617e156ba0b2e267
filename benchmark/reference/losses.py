"""Masked cross-entropy with an ignore label (reference
``nn.CrossEntropyLoss(ignore_index=ignore_label)``, ``train.py:123-124``;
label smoothing as ``util/common_util.py:180-185``) and the L1 offset loss
of the DCF family (reference ``L1Loss``, ``train.py:341-345``)."""

from __future__ import annotations

import torch
from torch.nn import functional as F


def cross_entropy(logits, labels, ignore_label, valid=None, smoothing=0.0):
    """Mean CE over non-ignored valid points; with ``smoothing`` the target
    is ``one_hot * (1 - smoothing) + smoothing / classes``."""
    mask = labels != ignore_label
    if valid is not None:
        mask = mask & valid
    n_class = logits.shape[-1]
    safe = labels.clamp(0, n_class - 1).long()
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    if smoothing > 0.0:
        target = (F.one_hot(safe, n_class).to(logp.dtype) * (1 - smoothing)
                  + smoothing / n_class)
        nll = -(target * logp).sum(-1)
    else:
        nll = -logp.gather(1, safe[:, None])[:, 0]
    nll = torch.where(mask, nll, torch.zeros_like(nll))
    return nll.sum() / mask.sum().clamp_min(1)


def l1_offset(pred_shift, target_shift, valid):
    """Mean absolute error over the valid points' three components
    (``train/losses.py:32-37`` of the JAX package)."""
    err = (pred_shift.to(torch.float32)
           - target_shift.to(torch.float32)).abs()
    err = torch.where(valid[:, None], err, torch.zeros_like(err))
    return err.sum() / (valid.sum() * 3).clamp_min(1)
