"""Convert a checkpoint of the JAX package's training driver (an orbax
``<save_path>/ckpt`` directory) into a checkpoint of the PyTorch port.

    python tools/orbax_to_torch.py --config configs/s3dis_stratified.yaml \
        --ckpt runs/s3dis_stratified/ckpt --out runs/torch/ckpt/<epoch>.pt \
        [--epoch N] [key value ...]

The YAML and the ``key value`` overrides must be those the JAX run trained
with: they shape the train state that orbax restores into (built by
``train.py::build_model_config`` and ``create_train_state``, as shapes
only, without running the model) and the port's model and AdamW, whose
parameter groups order the optimizer state. The latest epoch is read
unless ``--epoch`` is given. The output holds the weights, the BatchNorm
statistics, AdamW's moments and count, the step and the epoch
(``stratified_transformer_torch.convert.from_flax_state``); the port's
training driver resumes from it (``resume <out>``) and its evaluation
driver scores it (``model_path <out>``). Needs JAX, flax, optax and orbax
beside PyTorch (any CPU); prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def plain_tree(x):
    """Host numpy copy of a restored pytree: named tuples become dicts,
    FrozenDicts dicts."""
    import numpy as np
    if hasattr(x, "_asdict"):
        return {k: plain_tree(v) for k, v in x._asdict().items()}
    if isinstance(x, (tuple, list)):
        return tuple(plain_tree(v) for v in x)
    if hasattr(x, "items"):
        return {k: plain_tree(v) for k, v in x.items()}
    return np.asarray(x)


def restore_jax_state(cfg, ckpt_dir, epoch=None):
    """The JAX train state saved in ``ckpt_dir`` (latest epoch, or
    ``epoch``) for the flattened YAML ``cfg``: ``(state, epoch)``."""
    import jax
    import jax.numpy as jnp

    import train as jax_train
    from stratified_transformer_tpu.models.stratified import Stratified
    from stratified_transformer_tpu.train import checkpoint as jax_ckpt
    from stratified_transformer_tpu.train.state import create_train_state

    mcfg = jax_train.build_model_config(cfg, 1)
    example = (jnp.zeros((mcfg.n_pad, mcfg.in_channels), jnp.float32),
               jnp.zeros((mcfg.n_pad, 3), jnp.float32),
               jnp.zeros((mcfg.num_scenes,), jnp.int32))
    template = jax.eval_shape(lambda: create_train_state(
        Stratified(mcfg), jax.random.PRNGKey(0), example, lambda step: 0.0,
        weight_decay=float(cfg.get("weight_decay", 0.01)),
        transformer_lr_scale=float(cfg.get("transformer_lr_scale", 0.1)),
        optimizer=str(cfg.get("optimizer", "AdamW")),
        grad_clip=cfg.get("max_grad_norm")))
    state, got_epoch, _ = jax_ckpt.restore(ckpt_dir, template, epoch)
    if got_epoch == 0:
        raise SystemExit(f"no checkpoint in {ckpt_dir}")
    return state, got_epoch


def convert(cfg, ckpt_dir, out, epoch=None):
    """Writes the port's checkpoint of the JAX state in ``ckpt_dir`` to
    ``out``, after loading it into the port's model and optimizer; returns
    a summary dict."""
    from stratified_transformer_torch.config import from_cfg
    from stratified_transformer_torch.convert import from_flax_state
    from stratified_transformer_torch.models.stratified import Stratified
    from stratified_transformer_torch.train import checkpoint
    from stratified_transformer_torch.train.state import make_optimizer

    state, got_epoch = restore_jax_state(cfg, ckpt_dir, epoch)
    model = Stratified(from_cfg(cfg))
    optimizer = make_optimizer(
        model, lambda step: 0.0,
        weight_decay=float(cfg.get("weight_decay", 0.01)),
        transformer_lr_scale=float(cfg.get("transformer_lr_scale", 0.1)),
        optimizer=str(cfg.get("optimizer", "AdamW")),
        max_grad_norm=cfg.get("max_grad_norm"))
    payload = from_flax_state(
        plain_tree(state.params), plain_tree(state.batch_stats),
        plain_tree(state.opt_state), int(state.step), got_epoch,
        model=model, optimizer=optimizer)
    model.load_state_dict(payload["model"], strict=True)
    optimizer.load_state_dict(payload["optimizer"])
    checkpoint.write(out, payload)
    return {"out": out, "epoch": got_epoch, "step": payload["step"],
            "tensors": len(payload["model"]),
            "adam_count": optimizer.param_groups[0]["t"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", required=True,
                    help="the JAX run's <save_path>/ckpt directory")
    ap.add_argument("--out", required=True, help="the port's .pt to write")
    ap.add_argument("--epoch", type=int, default=None)
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="YAML overrides as key value pairs")
    args = ap.parse_args(argv)
    from stratified_transformer_tpu.utils.config import (
        load_cfg, merge_cfg_from_list)
    cfg = merge_cfg_from_list(load_cfg(args.config), args.opts)
    print(json.dumps(convert(cfg, args.ckpt, args.out, args.epoch)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
