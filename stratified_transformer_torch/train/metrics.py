"""Segmentation counters (reference ``util/common_util.py:45-72``) and the
host-side meters of the training loop (``train/metrics.py:51-84`` of the JAX
package)."""

from __future__ import annotations

import numpy as np
import torch


def intersection_and_union(pred, target, num_classes, ignore_label,
                           valid=None):
    """Returns ``(intersection, union, target)`` int64 counts per class,
    computed on the tensors' device without a host synchronisation (unlike
    ``torch.bincount``, which reads its input's maximum on the host)."""
    mask = target != ignore_label
    if valid is not None:
        mask = mask & valid
    pred = torch.where(mask, pred, num_classes)
    target = torch.where(mask, target, num_classes)
    inter = torch.where(pred == target, pred, num_classes)

    def hist(x):
        x = x.long()
        counts = torch.zeros(num_classes + 1, dtype=torch.int64,
                             device=x.device)
        return counts.scatter_add_(0, x, torch.ones_like(x))[:num_classes]

    area_inter = hist(inter)
    area_pred = hist(pred)
    area_target = hist(target)
    return area_inter, area_pred + area_target - area_inter, area_target


def iou_from_counts(inter, union, target):
    """Per-class IoU and accuracy and their means (host-side numpy;
    ``train/metrics.py:35-48`` of the JAX package)."""
    inter = np.asarray(inter, np.float64)
    union = np.asarray(union, np.float64)
    target = np.asarray(target, np.float64)
    iou = inter / np.maximum(union, 1e-10)
    acc = inter / np.maximum(target, 1e-10)
    return {
        "iou_class": iou,
        "acc_class": acc,
        "miou": float(iou.mean()),
        "macc": float(acc.mean()),
        "all_acc": float(inter.sum() / max(target.sum(), 1e-10)),
    }


class AverageMeter:
    """Running average (reference ``util/common_util.py:13-28``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


def memory_use():
    """Device memory in GiB per CUDA device, in use and at its peak
    (``torch.cuda.memory_allocated`` / ``max_memory_allocated``; reference
    ``util/common_util.py:170-177``); empty without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {
        "bytes_in_use_gb": torch.cuda.memory_allocated(i) / 2 ** 30,
        "peak_bytes_gb": torch.cuda.max_memory_allocated(i) / 2 ** 30}
        for i in range(torch.cuda.device_count())}
