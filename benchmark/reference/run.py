"""Entry points of the plain reference: training steps and the eval forward
from the same inputs the program got (the collated arrays, the weights
and the drop-path seeds), with its own stem neighbours, pyramid, plans and
masks.

Precision: fp32 with TF32 off (`precision`). The control
(``control=True``) is the reference computed one step below what the
configuration states: the attention's product operands in fp8 where the
configuration states bf16, as an fp8 training path runs it (each tensor
scaled so that its largest magnitude is the format's largest; e4m3 for
the forward's operands and the backward's recomputed ones, e5m2 for the
backward's gradient operands), and every other matrix product in TF32
where it states fp32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from reference import losses, schedulers
from reference.config import from_cfg
from reference.data import host_neighbors
from reference.data.pyramid import build_geometry_pyramid
from reference.models.stratified import Stratified
from reference.ops import sampling

def _scaled(t, dtype, top):
    """``t`` rounded to ``dtype`` under a per-tensor scale that takes its
    largest magnitude to ``top``, and back to fp32. (Unscaled, the
    gradients of a mean loss over ~10^5 points, ~1e-6, fall under e4m3's
    smallest step, 2^-9, and round to 0.)"""
    amax = t.detach().abs().amax().float()
    scale = top / torch.where(amax > 0, amax, torch.ones_like(amax))
    return (t * scale).to(dtype).to(torch.float32) / scale


def fp8_round(t):
    """``t`` in scaled fp8 e4m3 (largest magnitude 448); its ``grad`` is
    the backward's gradient rounding, scaled e5m2 (57344)."""
    return _scaled(t, torch.float8_e4m3fn, 448.0)


fp8_round.grad = lambda t: _scaled(t, torch.float8_e5m2, 57344.0)


@contextlib.contextmanager
def precision(tf32):
    """TF32 on or off for matrix products and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def model_config(yaml_cfg, n_pad=None, num_scenes=None):
    """The configuration the reference runs: the YAML's, fp32 attention
    (the precision keys "highest"), at ``n_pad`` / ``num_scenes`` where
    given."""
    cfg = from_cfg(dict(yaml_cfg, rpe_precision="highest",
                        qk_precision="highest", attn_impl="reference"))
    kw = {}
    if n_pad is not None:
        kw["n_pad"] = int(n_pad)
    if num_scenes is not None:
        kw["num_scenes"] = int(num_scenes)
    return dataclasses.replace(cfg, **kw) if kw else cfg


def build(cfg, weights, device, train, control=False):
    """The reference model on ``device`` with ``weights`` (``{name:
    tensor}``) loaded by name."""
    model = Stratified(cfg, fp8_round if control else None).to(device)
    names = {n for n, _ in model.named_parameters()}
    if names != set(weights):
        raise ValueError("the weights do not match the reference's "
                         f"parameters: {sorted(names ^ set(weights))[:8]}")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n].to(device))
    return model.train(train)


def stem_neighbors(cfg, xyz, offsets):
    """The KPConv stem's radius neighbours on the host: ``(idx, mask)``,
    empty slots holding the point's own index."""
    n_pad = len(xyz)
    total = int(offsets[-1])
    k = cfg.max_num_neighbors
    idx = np.zeros((n_pad, k), np.int64)
    mask = np.zeros((n_pad, k), bool)
    raw = host_neighbors.radius_neighbors(
        xyz[:total], np.asarray(offsets, np.int64),
        float(2.5 * cfg.grid_size * cfg.sigma), int(k))
    ok = raw >= 0
    idx[:total] = np.where(ok, raw, np.arange(total)[:, None])
    mask[:total] = ok
    return idx, mask


def _device(tree, device):
    if isinstance(tree, dict):
        return {k: _device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_device(v, device) for v in tree)
    a = np.asarray(tree)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def host_inputs(cfg, batch):
    """The host tier's work for one training batch: the stem neighbours
    and the geometry pyramid from its coordinates and offsets."""
    idx, mask = stem_neighbors(cfg, batch["xyz"], batch["offsets"])
    return {"stem_nidx": idx, "stem_nmask": mask,
            "pyramid": build_geometry_pyramid(batch["xyz"], batch["offsets"],
                                              cfg)}


def optimizer(model, yaml_cfg, iter_per_epoch):
    """AdamW over two groups (``blocks`` at ``transformer_lr_scale``), the
    YAML's weight decay and schedule; returns ``(optimizer, schedule)``."""
    scale = float(yaml_cfg.get("transformer_lr_scale", 0.1))
    blocks, rest = [], []
    for name, p in model.named_parameters():
        (blocks if "blocks" in name else rest).append(p)
    opt = torch.optim.AdamW(
        [{"params": blocks, "lr_scale": scale},
         {"params": rest, "lr_scale": 1.0}],
        lr=1.0, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=float(yaml_cfg.get("weight_decay", 0.01)))
    schedule, _ = schedulers.from_config(yaml_cfg, iter_per_epoch)
    return opt, schedule


def clip_by_global_norm(grads, max_norm):
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


def leaf_norms(named):
    """``{name: float}`` L2 norms of ``(name, tensor)`` pairs, in fp64."""
    return {n: float(t.detach().double().norm()) for n, t in named}


def train_steps(yaml_cfg, cfg, weights, batches, drop_seeds, device,
                iter_per_epoch, control=False):
    """``len(batches)`` training steps from ``weights``: returns the losses,
    each leaf's gradient after the first step's clip (as the optimizer gets
    it) and each leaf's change over all the steps, as ``{name: L2 norm}``
    (`leaf_norms`). The drop-path masks come from ``torch.Generator(device)``
    seeded with ``drop_seeds[t]`` at step ``t``, drawn in the model's block
    order, as the program draws its own."""
    with precision(control):
        model = build(cfg, weights, device, True, control)
        opt, schedule = optimizer(model, yaml_cfg, iter_per_epoch)
        ignore = int(yaml_cfg.get("ignore_label", 255))
        max_norm = yaml_cfg.get("max_grad_norm")
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        out = {"loss": [], "grad1": None}
        for t, (batch, seed) in enumerate(zip(batches, drop_seeds)):
            b = _device(dict(batch, **host_inputs(cfg, batch)), device)
            n = b["xyz"].shape[0]
            valid = sampling.offsets_to_valid(b["offsets"], n)
            gen = torch.Generator(device=device).manual_seed(int(seed))
            logits, _ = model(b["feats"], b["xyz"], b["offsets"],
                              stem_nidx=b["stem_nidx"],
                              stem_nmask=b["stem_nmask"],
                              pyramid=b["pyramid"], generator=gen)
            loss = losses.cross_entropy(logits, b["labels"], ignore, valid)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            grads = [p.grad for p in model.parameters()
                     if p.grad is not None]
            if max_norm:
                clip_by_global_norm(grads, float(max_norm))
            if t == 0:
                out["grad1"] = leaf_norms(
                    (nm, p.grad) for nm, p in model.named_parameters()
                    if p.grad is not None)
            for g in opt.param_groups:
                g["lr"] = float(schedule(g.setdefault("t", 0))) * g[
                    "lr_scale"]
            opt.step()
            for g in opt.param_groups:
                g["t"] += 1
            out["loss"].append(float(loss.detach()))
            del b, logits, loss, grads
        out["change"] = leaf_norms((n, p.detach() - start[n])
                                   for n, p in model.named_parameters())
    return out


@torch.inference_mode()
def eval_probs(cfg, weights, batch, device, control=False):
    """The softmax of one eval-mode forward of ``batch`` (``feats/xyz/
    offsets`` numpy arrays), computing its own stem neighbours and
    pyramid on ``device``; float32 numpy ``[n_pad, classes]``."""
    with precision(control):
        model = build(cfg, weights, device, False, control)
        logits, _ = model(
            torch.from_numpy(batch["feats"]).to(device),
            torch.from_numpy(batch["xyz"]).to(device),
            torch.from_numpy(batch["offsets"]).to(device, torch.int64))
        return torch.softmax(logits, -1).cpu().numpy()
