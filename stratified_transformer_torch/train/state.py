"""Optimizer construction (the JAX package's ``train/state.py::
make_optimizer``; reference ``train.py:126-138``).

Two parameter groups: every parameter whose name contains ``blocks`` gets
the learning rate times ``transformer_lr_scale`` (0.1), every other one the
base rate. optax scales the whole AdamW update, decoupled weight decay
included, which is exactly what a torch group with ``lr = base * scale``
does; weight decay applies to every parameter, as in optax (no no-decay
group). The schedule is evaluated at the optimizer's count, from 0.

SGD follows ``torch.optim.SGD`` (weight decay added to the gradient before
momentum), which differs from the JAX package's ``sgd`` +
``add_decayed_weights`` chain; no shipped configuration uses SGD.

``max_grad_norm`` clips the gradients by their global norm before the
update, as ``optax.clip_by_global_norm`` first in the JAX package's chain
(``train/state.py:78-80``), spelled as optax spells it.
"""

from __future__ import annotations

import torch

from stratified_transformer_torch.utils import trace


def param_groups(model, transformer_lr_scale=0.1):
    """``[blocks group, rest group]``, each with its ``lr_scale``."""
    blocks, rest = [], []
    for name, p in model.named_parameters():
        (blocks if "blocks" in name else rest).append(p)
    return [{"params": blocks, "lr_scale": transformer_lr_scale},
            {"params": rest, "lr_scale": 1.0}]


def make_optimizer(model, schedule, *, weight_decay=0.01,
                   transformer_lr_scale=0.1, optimizer="AdamW",
                   momentum=0.9, max_grad_norm=None):
    """AdamW (betas 0.9/0.999, eps 1e-8) or SGD over `param_groups`; the
    returned optimizer carries ``schedule``, ``max_grad_norm`` (None or 0:
    no clip) and a step count ``t`` in each group, which `optimizer_step`
    reads."""
    groups = param_groups(model, transformer_lr_scale)
    if optimizer == "AdamW":
        opt = torch.optim.AdamW(groups, lr=float(schedule(0)),
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    elif optimizer == "SGD":
        opt = torch.optim.SGD(groups, lr=float(schedule(0)),
                              momentum=momentum, weight_decay=weight_decay)
    else:
        raise ValueError(optimizer)
    for g in opt.param_groups:
        g["t"] = 0
    opt.schedule = schedule
    opt.max_grad_norm = max_grad_norm
    return opt


def clip_by_global_norm(grads, max_norm):
    """``optax.clip_by_global_norm`` in place on the tensors ``grads``:
    with ``norm = sqrt(sum(g^2))``, each ``g`` becomes ``(g / norm) *
    max_norm`` where ``norm >= max_norm`` (no eps), and stays otherwise.
    The choice is made on the device."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


def optimizer_step(optimizer):
    """One scheduled update: the global-norm clip when the optimizer has
    ``max_grad_norm``, each group's LR ``schedule(t) * lr_scale`` at its
    count ``t`` (from 0), then the step, then the count."""
    if getattr(optimizer, "max_grad_norm", None):
        with trace.span("st.clip"):
            clip_by_global_norm(
                [p.grad for g in optimizer.param_groups for p in g["params"]
                 if p.grad is not None], float(optimizer.max_grad_norm))
    for g in optimizer.param_groups:
        g["lr"] = float(optimizer.schedule(g["t"])) * g["lr_scale"]
    optimizer.step()
    for g in optimizer.param_groups:
        g["t"] += 1
