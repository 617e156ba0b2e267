"""Segmentation counters (reference ``util/common_util.py:45-72``)."""

from __future__ import annotations

import numpy as np
import torch


def intersection_and_union(pred, target, num_classes, ignore_label,
                           valid=None):
    """Returns ``(intersection, union, target)`` counts per class."""
    mask = target != ignore_label
    if valid is not None:
        mask = mask & valid
    pred = torch.where(mask, pred, num_classes)
    target = torch.where(mask, target, num_classes)
    inter = torch.where(pred == target, pred, num_classes)

    def hist(x):
        return torch.bincount(x.long(), minlength=num_classes + 1)[
            :num_classes]

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
