"""Train and eval steps (the JAX package's ``train/step.py``; reference
loop body ``train.py:314-358``, val loop ``train_backup.py:397-409``)."""

from __future__ import annotations

import torch

from stratified_transformer_torch.ops import sampling
from stratified_transformer_torch.train import losses, metrics
from stratified_transformer_torch.train.state import optimizer_step
from stratified_transformer_torch.utils import trace


def make_train_step(ignore_label, num_classes, offset_weight=1.0,
                    reduce_grads=None):
    """Returns ``train_step(model, optimizer, batch, generator) -> stats``:
    forward in training mode (batch statistics, drop-path masks from
    ``generator``), masked CE plus, when the model returns a shift and the
    batch carries ``target_shift``, ``offset_weight`` times the L1 offset
    loss (``train/step.py:52-55``), backward through the attention kernels,
    ``reduce_grads(model)`` where given (the data-parallel gradient
    average, `parallel.dp.all_reduce_grads`), one scheduled optimizer
    update (`train.state.optimizer_step`), IoU counters.
    The stats keys are the JAX step's (``train/step.py:68-72``); they are
    device tensors, and the step reads none of them on the host, so the
    caller can prepare the next batch while the device runs this one.

    ``batch`` holds device tensors as for `make_eval_step`.
    """

    def train_step(model, optimizer, batch, generator=None):
        if not model.training:
            raise ValueError("train_step expects a model in training mode")
        with trace.span("st.train_step", optimizer.param_groups[0]["t"]):
            n = batch["xyz"].shape[0]
            valid = sampling.offsets_to_valid(batch["offsets"], n)
            with trace.span("st.forward"):
                logits, shift = model(
                    batch["feats"], batch["xyz"], batch["offsets"],
                    stem_nidx=batch["stem_nidx"],
                    stem_nmask=batch["stem_nmask"],
                    pyramid=batch.get("pyramid"), generator=generator)
            with trace.span("st.loss"):
                loss_seg = losses.cross_entropy(logits, batch["labels"],
                                                ignore_label, valid)
                loss = loss_seg
                loss_off = torch.zeros((), dtype=torch.float32,
                                       device=logits.device)
                if shift is not None and batch.get("target_shift") is not None:
                    loss_off = losses.l1_offset(shift, batch["target_shift"],
                                                valid)
                    loss = loss + offset_weight * loss_off
            optimizer.zero_grad(set_to_none=True)
            with trace.span("st.backward"):
                loss.backward()
            if reduce_grads is not None:
                reduce_grads(model)
            with trace.span("st.optimizer"):
                optimizer_step(optimizer)
            with trace.span("st.metrics"), torch.no_grad():
                pred = logits.argmax(-1)
                inter, union, target = metrics.intersection_and_union(
                    pred, batch["labels"], num_classes, ignore_label, valid)
        return {"loss": loss.detach(), "loss_seg": loss_seg.detach(),
                "loss_offset": loss_off.detach(),
                "intersection": inter, "union": union, "target": target,
                "points": valid.sum()}

    return train_step


def make_eval_step(ignore_label, num_classes):
    """Returns ``eval_step(model, batch) -> (logits, shift, stats)``.

    ``batch`` holds device tensors ``feats/xyz/offsets/labels``,
    ``stem_nidx/stem_nmask`` and, optionally, ``pyramid``
    (``data/loader.py``); without it the model builds it on the device.
    """

    @torch.no_grad()
    def eval_step(model, batch):
        if model.training:
            raise ValueError("eval_step expects a model in eval mode")
        n = batch["xyz"].shape[0]
        valid = sampling.offsets_to_valid(batch["offsets"], n)
        logits, shift = model(
            batch["feats"], batch["xyz"], batch["offsets"],
            stem_nidx=batch["stem_nidx"], stem_nmask=batch["stem_nmask"],
            pyramid=batch.get("pyramid"))
        loss = losses.cross_entropy(logits, batch["labels"], ignore_label,
                                    valid)
        pred = logits.argmax(-1)
        inter, union, target = metrics.intersection_and_union(
            pred, batch["labels"], num_classes, ignore_label, valid)
        stats = {"loss": loss, "intersection": inter, "union": union,
                 "target": target, "points": valid.sum()}
        return logits, shift, stats

    return eval_step


def pack_stats(stats):
    """A step's stats as ONE float32 tensor on its device, read by the
    training loop in one transfer (``train.py:463-470``): ``[loss,
    loss_seg, loss_offset, points, intersection[C], union[C],
    target[C]]``."""
    head = torch.stack([stats["loss"], stats["loss_seg"],
                        stats["loss_offset"],
                        stats["points"].to(torch.float32)])
    return torch.cat([head] + [stats[k].to(torch.float32)
                               for k in ("intersection", "union", "target")])
