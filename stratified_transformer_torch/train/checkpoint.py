"""Checkpoints with ``torch.save`` (the JAX package's
``train/checkpoint.py:19-70``; reference ``train.py:288-294,176-190``).

A checkpoint holds the model's state (parameters and BatchNorm
statistics), the optimizer's state (its moments and each group's step
count), the step, the epoch and the best IoU (always 0.0: the JAX driver
saves the default). Schedules are pure functions of the step, so no
scheduler state is kept. The training loop writes one file per epoch,
``<save_path>/ckpt/<epoch>.pt``, and keeps the newest ``max_to_keep`` (5,
orbax's setting in the JAX package). A data-parallel run writes the same
file from rank 0, so a checkpoint resumes on one device or on any number
of ranks.
"""

from __future__ import annotations

import os
import re

import torch

from stratified_transformer_torch.parallel import mesh

_EPOCH_FILE = re.compile(r"^(\d+)\.pt$")


def write(path, payload):
    """``torch.save`` of ``payload`` to ``path`` through a temporary file,
    so that a reader never sees half a checkpoint."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def epochs(directory):
    """The epochs of the checkpoints in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_EPOCH_FILE.match,
                                                os.listdir(directory)) if m)


def save(directory, model, optimizer, step, epoch, best_iou=0.0,
         max_to_keep=5):
    """Writes ``<directory>/<epoch>.pt`` and removes all but the newest
    ``max_to_keep`` epochs; returns the path written. Under data
    parallelism every rank calls it: rank 0 writes (the ranks hold the same
    state, so the file is the one a single device writes), then all wait
    for it at a barrier."""
    path = os.path.join(directory, f"{int(epoch)}.pt")
    if mesh.rank() == 0:
        write(path, {"model": model.state_dict(),
                     "optimizer": optimizer.state_dict(), "step": int(step),
                     "epoch": int(epoch), "best_iou": float(best_iou)})
        for old in epochs(directory)[:-max_to_keep]:
            os.remove(os.path.join(directory, f"{old}.pt"))
    mesh.barrier()
    return path


def restore(path, model, optimizer=None):
    """Load a checkpoint into ``model`` (and ``optimizer``) in place:
    ``path`` is a ``.pt`` file or a directory of them, whose latest epoch is
    read. Returns ``(step, epoch, best_iou)``; ``(0, 0, 0.0)``, loading
    nothing, for a directory without checkpoints, as the JAX package's
    ``restore`` does. A path that does not exist raises
    FileNotFoundError."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint file or directory {path}")
    if os.path.isdir(path):
        found = epochs(path)
        if not found:
            return 0, 0, 0.0
        path = os.path.join(path, f"{found[-1]}.pt")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"])
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
    return payload["step"], payload["epoch"], payload["best_iou"]
