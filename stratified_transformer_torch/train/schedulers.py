"""Learning-rate schedules as pure ``step -> lr`` functions (the JAX
package's ``train/schedulers.py``; reference ``util/lr.py`` and the
selection in ``train.py:218-246``): MultiStep, MultiStepWithWarmup, Poly,
PolyWithWarmup, Squared, Exp, StepLR and OneCycle, in Python floats.

Epoch-updated schedules are step functions of ``step // iter_per_epoch``;
the optimizer evaluates a schedule at its own count, starting at 0
(`train.state.optimizer_step`).
"""

from __future__ import annotations

import math
from typing import Sequence


def _warmup_coeff(step, warmup_iters, warmup_ratio):
    """Linear warmup: ``1 - (1 - s/w) * (1 - ratio)`` for ``s <= w``
    (``util/lr.py:25-29``)."""
    if step > warmup_iters:
        return 1.0
    return 1.0 - (1.0 - step / warmup_iters) * (1.0 - warmup_ratio)


def multi_step(base_lr, milestones: Sequence[int], gamma=0.1):
    """torch ``MultiStepLR`` (epoch-stepped in the reference)."""
    ms = sorted(milestones)

    def schedule(step):
        return base_lr * gamma ** sum(step >= m for m in ms)
    return schedule


def multi_step_with_warmup(base_lr, milestones, gamma=0.1,
                           warmup_iters=1500, warmup_ratio=1e-6):
    """``MultiStepWithWarmup`` (``util/lr.py:38-55``)."""
    ms = sorted(milestones)

    def schedule(step):
        factor = gamma ** sum(step >= m for m in ms)
        return base_lr * factor * _warmup_coeff(step, warmup_iters,
                                                warmup_ratio)
    return schedule


def poly(base_lr, max_iter, power=0.9):
    def schedule(step):
        return base_lr * (1.0 - step / (max_iter + 1)) ** power
    return schedule


def poly_with_warmup(base_lr, max_iter, power=1.0, warmup_iters=1500,
                     warmup_ratio=1e-6):
    def schedule(step):
        coeff = (1.0 - step / (max_iter + 1)) ** power
        return base_lr * coeff * _warmup_coeff(step, warmup_iters,
                                               warmup_ratio)
    return schedule


def squared(base_lr, max_iter):
    return poly(base_lr, max_iter, power=2.0)


def exponential(base_lr, step_size, gamma=0.9):
    def schedule(step):
        return base_lr * gamma ** (step / step_size)
    return schedule


def step_lr(base_lr, step_size, gamma=0.1):
    """torch ``StepLR`` (``util/lr.py`` initialize_scheduler)."""

    def schedule(step):
        return base_lr * gamma ** (step // step_size)
    return schedule


def one_cycle(max_lr, total_steps, pct_start=0.3, div_factor=25.0,
              final_div_factor=1e4):
    """``OneCycleLR`` (cos anneal): linear warm-up to ``max_lr`` over
    ``pct_start`` of the steps, then cosine decay to ``max_lr /
    div_factor / final_div_factor`` (``util/lr.py`` initialize_scheduler
    OneCycleLR branch). In double precision, where the JAX package's
    rounds to float32."""
    initial = max_lr / div_factor
    final = initial / final_div_factor
    up = pct_start * total_steps

    def schedule(step):
        if step <= up:
            return initial + (max_lr - initial) * min(step / up, 1.0)
        t = min(max((step - up) / max(total_steps - up, 1), 0.0), 1.0)
        return final + (max_lr - final) * 0.5 * (1 + math.cos(math.pi * t))
    return schedule


def from_config(cfg, iter_per_epoch):
    """The schedule the reference driver builds (``train.py:218-246``):
    returns ``(schedule, granularity)``, granularity ``"step"`` or
    ``"epoch"``."""
    name = cfg.get("scheduler", "MultiStep")
    update = cfg.get("scheduler_update", "epoch")
    base_lr = cfg["base_lr"]
    epochs = cfg["epochs"]
    if name == "MultiStepWithWarmup":
        milestones = [int(epochs * 0.6) * iter_per_epoch,
                      int(epochs * 0.8) * iter_per_epoch]
        return multi_step_with_warmup(
            base_lr, milestones, 0.1, cfg.get("warmup_iters", 1500),
            cfg.get("warmup_ratio", 1e-6)), "step"
    if name == "MultiStep":
        ms = cfg.get("milestones")
        if ms is not None and not isinstance(ms, (list, tuple)):
            # CLI override "36,48" (or its "(36, 48)" tuple repr)
            ms = [x for x in
                  str(ms).strip("()[] ").replace(" ", "").split(",") if x]
        ms_epochs = ([int(x) for x in ms] if ms
                     else [int(epochs * 0.6), int(epochs * 0.8)])
        inner = multi_step(base_lr, ms_epochs, cfg.get("gamma", 0.1))
        return (lambda step: inner(step // iter_per_epoch)), "epoch"
    if name == "Poly":
        power = cfg.get("power", 0.9)
        if update == "epoch":
            inner = poly(base_lr, epochs, power)
            return (lambda step: inner(step // iter_per_epoch)), "epoch"
        return poly(base_lr, epochs * iter_per_epoch, power), "step"
    raise ValueError(f"No such scheduler {name}")
