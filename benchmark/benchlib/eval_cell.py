"""Evaluation cells: ``eval/driver.py::make_predict_probs`` on ``models/
stratified.py``'s model at ``eval/driver.py::eval_config``'s capacity,
called synchronously batch after batch as ``test.py``'s protocol calls it,
over the packed crops of the traffic's TTA passes, cycled in an order
drawn from the seed. No host pyramid: the model samples and searches
neighbours on the device.

Each call is timed on the host from the batch's upload to its
probabilities on the host. After the window, a sample of the window's
calls drawn from the seed, with the batch of the most points in it, is
held against the reference's probabilities of the same batches.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchlib import common, traffic, weights

WARMUP_CALLS = 2


class EvalCell:
    """One run of an evaluation cell on ``device``."""

    kind = "eval"

    def __init__(self, cell, seed, device):
        from stratified_transformer_torch.eval.driver import eval_config
        from stratified_transformer_torch.utils.config import CfgNode
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.yaml = CfgNode(cell.yaml)
        self.cfg = eval_config(self.yaml)
        self.check_calls = int(cell.spec["check_calls"])

    def setup(self, batches=None):
        """``batches``: the traffic's batches where already built (they are
        the same for every seed)."""
        from stratified_transformer_torch.eval.driver import (
            make_predict_probs)
        from stratified_transformer_torch.models.stratified import Stratified
        self.batches = batches or traffic.eval_batches(
            self.cell.traffic, self.cfg, self.yaml)
        self.order = traffic.cycle_order(len(self.batches), self.seed)
        self.model = Stratified(self.cfg).to(self.device).eval()
        weights.load(self.model, self.seed)
        self.predict = make_predict_probs(self.model)
        self.calls = 0
        for _ in range(min(WARMUP_CALLS, len(self.batches))):
            self.call()
        self.calls = 0

    def batch_of(self, k):
        return self.batches[self.order[k % len(self.batches)]]

    def call(self):
        """``predict_probs`` on the next batch of the cycle."""
        b = self.batch_of(self.calls)
        probs = self.predict(b["feats"], b["xyz"], b["offsets"])
        self.calls += 1
        return probs

    def window(self, seconds):
        """Calls until ``seconds`` have passed; keeps each call's host
        milliseconds and the probabilities of the calls compared
        afterwards: the first call of the batch with the most points, and
        a uniform sample of ``check_calls - 1`` of the others, drawn from
        the seed as the calls come (a reservoir).
        ``{"calls", "points", "wall_s", "ms"}``."""
        rng = np.random.default_rng((self.seed, 11))
        longest = int(np.argmax([b["points"] for b in self.batches]))
        slots = self.check_calls - 1
        self.kept = {}
        ms, seen_batches = [], []
        points = seen = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            k = self.calls
            i = int(self.order[k % len(self.batches)])
            t1 = time.perf_counter()
            probs = self.call()
            ms.append((time.perf_counter() - t1) * 1e3)
            seen_batches.append(i)
            n = self.batches[i]["points"]
            points += n
            if i == longest and "longest" not in self.kept:
                self.kept["longest"] = (i, probs[:n].copy())
                continue
            slot = seen if seen < slots else int(rng.integers(0, seen + 1))
            seen += 1
            if slot < slots:
                self.kept[slot] = (i, probs[:n].copy())
        wall = time.perf_counter() - t0
        self.window_stats = {"calls": len(ms), "points": points,
                             "wall_s": wall, "ms": ms,
                             "batches": seen_batches}
        return self.window_stats

    def end_to_end(self):
        w = self.window_stats
        return {"eval_points_per_s": common.rate(w["points"], w["wall_s"]),
                "eval_batch_ms_p90": common.percentile(w["ms"], 90)}

    def probe(self):
        """The traced measurements on the batches of the most points (the
        cycle's full batches): the attention and the geometry timed on
        the first of them, the profiler over calls on it, the FLOPs from
        the reference's plans of four of them."""
        from reference import run as ref
        from reference.models.stratified import (
            geometry_pyramid as ref_pyramid)
        from reference.models.stratified import stem_neighbors as ref_stem
        from benchlib.probe import Probe, attention_launches, levels_of
        from stratified_transformer_torch.models.stratified import (
            geometry_pyramid, stem_neighbors)
        dev = self.device
        points = [b["points"] for b in self.batches]
        full = [i for i in np.argsort(points, kind="stable")[::-1]
                if points[i] == max(points)]
        b = self.batches[full[0]]
        xyz = torch.from_numpy(b["xyz"]).to(dev)
        offsets = torch.from_numpy(b["offsets"]).to(dev, torch.int64)
        ref_cfg = ref.model_config(self.yaml, self.cfg.n_pad,
                                   self.cfg.num_scenes)
        ref_levels = []
        for i in full[:4]:
            rx = torch.from_numpy(self.batches[i]["xyz"]).to(dev)
            ro = torch.from_numpy(self.batches[i]["offsets"]).to(
                dev, torch.int64)
            ref_levels.append((levels_of(ref_cfg, rx, ro,
                                         ref_pyramid(ref_cfg, rx, ro)),
                               int(ref_stem(ref_cfg, rx, ro)[1].sum())))
        w = self.window_stats
        call_ms = float(np.median([m for m, i in zip(w["ms"], w["batches"])
                                   if points[i] == max(points)]))

        def call():
            self.predict(b["feats"], b["xyz"], b["offsets"])

        def geometry():
            with torch.inference_mode():
                stem_neighbors(self.cfg, xyz, offsets)
                geometry_pyramid(self.cfg, xyz, offsets)

        return Probe(kind="eval", cfg=self.cfg, ref_cfg=ref_cfg, device=dev,
                     window=w, call=call, call_ms=call_ms,
                     levels=levels_of(self.cfg, xyz, offsets,
                                      geometry_pyramid(self.cfg, xyz,
                                                       offsets)),
                     ref_levels_list=ref_levels, launches=attention_launches,
                     geometry=geometry)

    def notes(self):
        from benchlib.probe import attention_launches
        before = sum(attention_launches().values())
        self.call()
        return [f"attention launches per forward "
                f"{sum(attention_launches().values()) - before}",
                f"batches in the cycle {len(self.batches)}, valid points "
                f"{[b['points'] for b in self.batches]}"]

    def free(self):
        for name in ("model", "predict"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def program_readings(self):
        """The probabilities the window kept: ``{slot: (batch index,
        probabilities)}``."""
        return self.kept

    def reference(self, control=False, batches=None):
        """The reference's probabilities (the control's with ``control``)
        of the batches ``batches`` (default: those the window kept)."""
        from reference import run as ref
        ref_cfg = ref.model_config(self.yaml, self.cfg.n_pad,
                                   self.cfg.num_scenes)
        w = weights.generate(weights.spec(ref.Stratified(ref_cfg)),
                             self.seed, self.device)
        if batches is None:
            batches = sorted({i for i, _ in self.kept.values()})
        out = {}
        for i in batches:
            b = self.batches[i]
            out[i] = ref.eval_probs(ref_cfg, w, b, self.device,
                                    control=control)[:b["points"]]
        return out


def centered_logits(probs):
    """``log p`` less its row mean: the logits up to their row's constant,
    which the softmax drops."""
    lp = np.log(np.maximum(probs.astype(np.float64), 1e-300))
    return lp - lp.mean(1, keepdims=True)


def compare(got, want):
    """The numbers compared, from the kept ``{slot: (batch, probs)}``
    ``got`` and the reference's ``{batch: probs}`` ``want``, on the logits
    behind the probabilities (`centered_logits`): the widest gap of a
    served logit from the reference's over every valid point and class of
    every compared call, over the root mean square of the reference's
    logits (``logit_gap``), and the relative L2 distance of all of them
    (``logit_rel_l2``). Returns ``(numbers, where)``."""
    gap = num = den = sq = 0.0
    count = 0
    worst = None
    for slot, (i, probs) in got.items():
        g, w = centered_logits(probs), centered_logits(want[i])
        diff = np.abs(g - w)
        if diff.max() > gap:
            gap, worst = float(diff.max()), (slot, i)
        num += float((diff ** 2).sum())
        den += float((w ** 2).sum())
        count += w.size
    rms = (den / count) ** 0.5
    return ({"logit_gap": gap / rms, "logit_rel_l2": (num / den) ** 0.5},
            {"logit_gap": worst})


CELL = EvalCell
