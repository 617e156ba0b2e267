"""Data-parallel training step (the JAX package's ``parallel/dp.py:31-50``
and ``train/step.py:22-78`` under ``shard_map``).

Every rank holds the whole model and optimizer state and its own share of
the batch. After the backward, the gradients are averaged over the ranks
(``pmean``) in one flattened all-reduce, then clipped and applied by the
same scheduled optimizer update on every rank, so the parameters stay
identical; the step's packed statistics are summed over the ranks
(``psum``). SyncBN sums the BatchNorm statistics inside the model
(`models.layers.MaskedBatchNorm` with ``bn_axis_name``). Drop-path masks are
drawn from the generator the caller gives every rank alike, as the JAX step
folds the one replicated key with the step.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from stratified_transformer_torch.parallel.mesh import world_size
from stratified_transformer_torch.train.step import (
    make_train_step, pack_stats)


def all_reduce_grads(model):
    """``lax.pmean`` of ``model``'s gradients over the ranks, in place, as
    one flattened fp32 all-reduce. A parameter without a gradient adds
    zeros, so every rank's buffer has the same layout, and keeps none: the
    ranks run one graph, so such a parameter has no gradient on any rank,
    as on one device."""
    params = list(model.parameters())
    dev = params[0].device
    flat = torch.cat(
        [torch.zeros(p.numel(), dtype=torch.float32, device=dev)
         if p.grad is None else p.grad.reshape(-1).to(torch.float32)
         for p in params])
    dist.all_reduce(flat)
    flat /= world_size()
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        if p.grad is not None:
            p.grad.copy_(g.view_as(p))


def make_dp_train_step(ignore_label, num_classes, offset_weight=1.0):
    """Returns ``step(model, optimizer, batch, generator) -> packed``: the
    one-device `train.step.make_train_step` on this rank's ``batch``, with
    the gradients averaged over the ranks before the clip and the update,
    and ``packed`` the step's `train.step.pack_stats` summed over the ranks
    (the loss too: the caller divides it by the rank count, as
    ``train.py:596``). With one rank (or no process group) no collective is
    issued."""
    if world_size() == 1:
        inner = make_train_step(ignore_label, num_classes, offset_weight)

        def step(model, optimizer, batch, generator=None):
            return pack_stats(inner(model, optimizer, batch, generator))
        return step

    inner = make_train_step(ignore_label, num_classes, offset_weight,
                            reduce_grads=all_reduce_grads)

    def dp_step(model, optimizer, batch, generator=None):
        packed = pack_stats(inner(model, optimizer, batch, generator))
        dist.all_reduce(packed)
        return packed
    return dp_step
