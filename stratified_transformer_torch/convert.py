"""Weight conversion from the JAX package's flax variables.

Module paths are identical in both packages (``layer_0.blocks_1.attn.qkv``,
``cls_fc1``...), so the conversion walks the flax trees and renames leaves:
a Dense ``kernel [in, out]`` becomes a Linear ``weight [out, in]``;
LayerNorm / BatchNorm ``scale`` becomes ``weight``; ``bias``, the cRPE
tables ``[L, h, d, 3]`` and the KPConv ``kernel_weights [P, C, out]`` are
copied as they are; ``batch_stats`` ``mean``/``var`` become the BatchNorm
buffers of the same names. `from_flax_state` carries a whole train state
across, AdamW moments included, as a checkpoint of the port
(``tools/orbax_to_torch.py`` reads the JAX package's orbax checkpoints).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _walk(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _walk(value, path)
        else:
            yield path, np.asarray(value)


def from_flax(params, batch_stats=None) -> Dict[str, torch.Tensor]:
    """``state_dict`` for `models.stratified.Stratified` from flax
    ``params`` and ``batch_stats`` given as nested dicts of numpy arrays."""
    out = {}
    for path, value in _walk(params):
        *mod, leaf = path
        if leaf == "kernel":
            if value.ndim != 2:
                raise ValueError(f"Dense kernel expected at {path}")
            leaf, value = "weight", value.T
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(mod + [leaf])] = torch.from_numpy(
            np.array(value, np.float32, order="C"))
    for path, value in _walk(batch_stats or {}):
        out[".".join(path)] = torch.from_numpy(
            np.array(value, np.float32, order="C"))
    return out


def _adam_states(tree):
    """Every ``{count, mu, nu}`` mapping (optax's ``ScaleByAdamState``)
    inside nested mappings, tuples and lists."""
    if isinstance(tree, Mapping):
        if set(tree) == {"count", "mu", "nu"}:
            yield tree
            return
        tree = tree.values()
    elif not isinstance(tree, (tuple, list)):
        return
    for value in tree:
        yield from _adam_states(value)


def from_flax_state(params, batch_stats, opt_state, step, epoch, *, model,
                    optimizer):
    """A checkpoint payload of the port (``train/checkpoint.py``) from the
    JAX package's train state, given as numpy trees: ``params`` and
    ``batch_stats`` as for `from_flax`; ``opt_state`` the optax state of
    ``train/state.py::make_optimizer``'s AdamW chain, with or without its
    clip stage, its named tuples given as mappings (``_asdict``).

    optax's ``ScaleByAdamState`` ``mu`` / ``nu`` / ``count`` become the
    AdamW ``exp_avg`` / ``exp_avg_sq`` / ``step`` of each parameter, matched
    by name through `from_flax`'s naming, in the order of ``optimizer``'s
    ``param_groups`` (an AdamW of `train.state.make_optimizer` over
    ``model``); each group's count ``t`` becomes ``count``. ``best_iou`` is
    0.0, as the JAX driver saves it."""
    if not isinstance(optimizer, torch.optim.AdamW):
        raise ValueError("from_flax_state converts AdamW states only")
    adam = list(_adam_states(opt_state))
    if len(adam) != 1:
        raise ValueError(f"expected one ScaleByAdamState in opt_state, found "
                         f"{len(adam)}")
    count = int(np.asarray(adam[0]["count"]))
    mu, nu = from_flax(adam[0]["mu"]), from_flax(adam[0]["nu"])
    names = {id(p): n for n, p in model.named_parameters()}
    sd = optimizer.state_dict()
    sd["state"] = {}
    index = 0
    for group in sd["param_groups"]:
        group["t"] = count
    for live in optimizer.param_groups:
        for p in live["params"]:
            name = names[id(p)]
            sd["state"][index] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu[name], "exp_avg_sq": nu[name]}
            index += 1
    return {"model": from_flax(params, batch_stats),
            "optimizer": sd, "step": int(step), "epoch": int(epoch),
            "best_iou": 0.0}
