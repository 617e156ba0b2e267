"""Training cells: the program's ``train/step.py::make_train_step`` with
``train/driver.py::build_optimizer`` on a pool of batches that the
program's host tier finished (stem neighbours and pyramid) in set-up,
pinned on the host, uploaded each step and cycled.

Set-up drives that one step object from the seed through its first
`FIRST_STEPS` steps, on the pool's first batches (rows that all differ),
through the window's own call and feed, and keeps what the comparison
reads: each step's loss, the first gradient as AdamW got it (its first
moment after one step over ``1 - beta1``) and each leaf's change after the
steps. The window then continues the same object. Afterwards the
reference takes the same steps from the same weights, batches and
drop-path seeds.
"""

from __future__ import annotations

import concurrent.futures
import gc
import statistics
import time

import numpy as np
import torch

from benchlib import common, traffic, weights

FIRST_STEPS = 3
BETA1 = 0.9


def drop_seed(seed, step):
    """The drop-path generator's seed of step ``step``."""
    return int(seed) * 1_000_003 + int(step)


def _pinned(tree):
    if isinstance(tree, dict):
        return {k: _pinned(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_pinned(v) for v in tree)
    a = np.asarray(tree)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if torch.cuda.is_available() else t


def _upload(tree, device):
    if isinstance(tree, dict):
        return {k: _upload(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_upload(v, device) for v in tree)
    return tree.to(device, non_blocking=True)


class TrainCell:
    """One run of a training cell on ``device``."""

    kind = "train"

    def __init__(self, cell, seed, device):
        from stratified_transformer_torch.config import from_cfg
        from stratified_transformer_torch.utils.config import CfgNode
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.yaml = CfgNode(cell.yaml)
        self.cfg = from_cfg(self.yaml)
        self.iter_per_epoch = int(cell.traffic["iter_per_epoch"])

    # -- set-up -----------------------------------------------------------

    def setup(self):
        from stratified_transformer_torch.data.collate import PaddedBatch
        from stratified_transformer_torch.data.loader import finish_batch
        from stratified_transformer_torch.models.stratified import Stratified
        from stratified_transformer_torch.train.driver import build_optimizer
        from stratified_transformer_torch.train.step import make_train_step
        cfg = self.cfg
        self.batches = traffic.train_batches(self.cell.traffic, cfg,
                                             self.yaml, self.seed)
        self.points = [int(b["offsets"][-1]) for b in self.batches]

        def host_tier(b):
            return finish_batch(PaddedBatch(
                xyz=b["xyz"], feats=b["feats"], labels=b["labels"],
                offsets=b["offsets"]), cfg)

        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            hbs = list(pool.map(host_tier, self.batches))
        self.pool = [_pinned(hb) for hb in hbs]
        self.model = Stratified(cfg).to(self.device).train(True)
        weights.load(self.model, self.seed)
        self.optimizer = build_optimizer(self.model, self.yaml,
                                         self.iter_per_epoch)
        self.train_step = make_train_step(
            int(self.yaml.get("ignore_label", 255)), cfg.num_classes)
        self.step_count = 0
        start = {n: p.detach().clone()
                 for n, p in self.model.named_parameters()}
        losses = []
        for t in range(FIRST_STEPS):
            stats = self.step()
            losses.append(float(stats["loss"]))
            if t == 0:
                grad1 = self.first_gradient()
        change = {n: float((p.detach() - start[n]).double().norm())
                  for n, p in self.model.named_parameters()}
        del start
        self.readings = {"loss": losses, "grad1": grad1, "change": change}

    def first_gradient(self):
        """Each leaf's first gradient as AdamW got it: its first moment
        after one step over ``1 - beta1``, as ``{name: norm}``."""
        out = {}
        for n, p in self.model.named_parameters():
            st = self.optimizer.state.get(p, {})
            if "exp_avg" in st:
                out[n] = float((st["exp_avg"].double() / (1 - BETA1)).norm())
        return out

    def step(self):
        """One train step on the next pooled batch, uploaded now."""
        k = self.step_count
        batch = _upload(self.pool[k % len(self.pool)], self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            drop_seed(self.seed, k))
        stats = self.train_step(self.model, self.optimizer, batch, gen)
        self.step_count += 1
        return stats

    # -- the window -------------------------------------------------------

    def window(self, seconds):
        """Steps until ``seconds`` have passed on the host clock, then a
        synchronize: ``{"calls", "points", "wall_s"}``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        calls = points = 0
        while time.perf_counter() - t0 < seconds:
            points += self.points[self.step_count % len(self.pool)]
            self.step()
            calls += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        self.window_stats = {"calls": calls, "points": points,
                             "wall_s": wall}
        return self.window_stats

    def end_to_end(self):
        w = self.window_stats
        return {"train_points_per_s": common.rate(w["points"], w["wall_s"])}

    # -- the trace --------------------------------------------------------

    def probe(self):
        from reference import run as ref
        from benchlib.probe import Probe, attention_launches, levels_of
        batch = _upload(self.pool[0], self.device)
        ref_cfg = ref.model_config(self.yaml)
        ref_levels = []
        for b in self.batches:
            hi = ref.host_inputs(ref_cfg, b)
            ref_levels.append((levels_of(ref_cfg, b["xyz"], b["offsets"],
                                         hi["pyramid"]),
                               int(hi["stem_nmask"].sum())))
        return Probe(kind="train", cfg=self.cfg, ref_cfg=ref_cfg,
                     device=self.device, window=self.window_stats,
                     call=self.step, call_ms=1e3 * self.window_stats[
                         "wall_s"] / self.window_stats["calls"],
                     levels=levels_of(self.cfg, batch["xyz"],
                                      batch["offsets"], batch["pyramid"]),
                     ref_levels_list=ref_levels, launches=attention_launches)

    def notes(self):
        """Earlier lines of a traced run: the attention launches per step
        and the truncation audit's dropped-pair shares of the first batch."""
        from benchlib.probe import attention_launches
        from stratified_transformer_torch.train import audit
        before = sum(attention_launches().values())
        self.step()
        torch.cuda.synchronize()
        launches = sum(attention_launches().values()) - before
        batch = _upload(self.pool[0], self.device)
        arr = audit.audit_truncation_packed(self.cfg, batch).cpu().numpy()
        return [f"attention launches per step {launches}",
                audit.format_truncation(audit.unpack_truncation(self.cfg,
                                                                arr))]

    # -- the comparison ---------------------------------------------------

    def program_readings(self):
        return self.readings

    def free(self):
        for name in ("model", "optimizer", "pool", "train_step"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, control=False):
        """The reference's readings of the first steps (`reference.run.
        train_steps`), or the control's with ``control``."""
        from reference import run as ref
        ref_cfg = ref.model_config(self.yaml)
        leaves = weights.spec(ref.Stratified(ref_cfg))
        w = weights.generate(leaves, self.seed, self.device)
        return ref.train_steps(
            self.yaml, ref_cfg, w, self.batches[:FIRST_STEPS],
            [drop_seed(self.seed, t) for t in range(FIRST_STEPS)],
            self.device, self.iter_per_epoch, control=control)


def compare(got, want):
    """The numbers compared, from the program's (or the control's)
    readings ``got`` and the reference's ``want``: the first step's
    relative loss gap (``loss1_gap``); the widest gap of a leaf's
    first-gradient norm and of its change norm, each against the larger of
    the reference's norm of that leaf and of the median leaf, the change
    over the leaves whose reference gradient is at least a thousandth of
    the median leaf's (`common.moving_leaves`); and the median leaf's gap
    of the first gradient (``grad1_median_gap``), which is steady from
    seed to seed where the widest swings with one small leaf (PERF.md).
    The later steps' losses are reported beside them (``where``) and not
    compared: the first steps of AdamW move each weight by about the
    learning rate whatever its gradient's size, so where a gradient is
    round-off its sign decides, and the later losses carry that
    (PERF.md). Returns ``(numbers, where)``."""
    steps = [common.relative_gap(g, w, 0.0)
             for g, w in zip(got["loss"], want["loss"])]
    grad, grad_leaf = common.leaf_gaps(got["grad1"], want["grad1"])
    change, change_leaf = common.leaf_gaps(
        got["change"], want["change"], common.moving_leaves(want["grad1"]))
    median = statistics.median(
        common.leaf_gap_map(got["grad1"], want["grad1"]).values())
    return ({"loss1_gap": steps[0], "grad1_gap": grad,
             "grad1_median_gap": median, "change_gap": change},
            {"loss_gaps": steps, "grad1_gap": grad_leaf,
             "change_gap": change_leaf})


CELL = TrainCell
