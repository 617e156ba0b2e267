"""Checkpoints with ``torch.save`` (the JAX package's
``train/checkpoint.py:29-70``; reference ``train.py:288-294,176-190``).

A checkpoint holds the model's state (parameters and BatchNorm
statistics), the optimizer's state (its moments and each group's step
count), the step, the epoch and the best IoU. Schedules are pure functions
of the step, so no scheduler state is kept.
"""

from __future__ import annotations

import os

import torch


def save(path, model, optimizer, step, epoch, best_iou=0.0):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(), "step": int(step),
                "epoch": int(epoch), "best_iou": float(best_iou)}, tmp)
    os.replace(tmp, path)


def restore(path, model, optimizer=None):
    """Load ``path`` into ``model`` (and ``optimizer``) in place; returns
    ``(step, epoch, best_iou)``."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"])
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
    return payload["step"], payload["epoch"], payload["best_iou"]
