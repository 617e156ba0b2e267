"""Readings that a cell's limits are set from, on the card at the cell's
own size: the comparison numbers of the program on many seeds, of the
control (the reference one precision step lower, in the program's place)
and of faults planted in the reference put in the program's place: every
cell's attention scoring keys by the wrong table row (each bin shifted
by one), and in training cells the loss taken over half of each batch's
points. The benchmark's runs do not run this.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 3]

Prints one JSON line per reading and a summary line last: the largest
program reading of each number (the lower reading), the smallest control
and fault readings (the upper ones).
"""

import argparse
import contextlib
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


@contextlib.contextmanager
def bin_shift():
    """The attention fault "a key scored by the wrong table row", planted
    in the reference's bins: every relative position's bin one row up
    (clipped to the table)."""
    from reference.ops import attention
    plain = attention.relative_position_index

    def shifted(rel, window_size, quant_size, num_bins):
        return (plain(rel, window_size, quant_size, num_bins) + 1).clamp(
            0, num_bins - 1)

    attention.relative_position_index = shifted
    try:
        yield
    finally:
        attention.relative_position_index = plain


@contextlib.contextmanager
def half_batch():
    """The training fault "half of the batch left out, the mean taken over
    the rest", planted in the reference's loss: the valid mask keeps the
    first half of each batch's valid points."""
    from reference import losses
    plain = losses.cross_entropy

    def half(logits, labels, ignore_label, valid=None, smoothing=0.0):
        keep = valid & (torch.cumsum(valid.long(), 0)
                        <= valid.sum() // 2)
        return plain(logits, labels, ignore_label, keep, smoothing)

    losses.cross_entropy = half
    try:
        yield
    finally:
        losses.cross_entropy = plain


# the planted faults: name -> (the kinds of cell that can have it, the
# context that plants it in the reference)
FAULTS = {"bin_shift": (("train", "eval"), bin_shift),
          "half_batch": (("train",), half_batch)}


def readings(cell, seed, device, seconds, control=False, fault=False,
             cache=None):
    """The comparison numbers of one seed: the program's against the
    reference; with ``control`` the control's; with ``fault`` each
    planted fault's that the cell can have (`FAULTS`; ``who`` is
    ``fault_<name>``). A list of ``{"seed", "who", "numbers", "where",
    "seconds"}`` and, in training cells, each leaf's gap of the first
    gradient and of the change (``leaf_gaps``, `common.leaf_gap_map`).
    ``cache`` keeps an eval cell's batches, which are the same for every
    seed; ``seconds``: an eval cell's window."""
    from benchlib import common, runner
    cache = {} if cache is None else cache
    mod = runner.cell_module(cell.spec["kind"])
    c = mod.CELL(cell, seed, device)
    t0 = time.time()
    if c.kind == "eval":
        c.setup(batches=cache.get("batches"))
        cache["batches"] = c.batches
        c.window(seconds)
    else:
        c.setup()
    got = c.program_readings()
    c.free()
    want = c.reference()
    found = {"program": got}

    def in_place(**kw):
        r = c.reference(**kw, **(
            {"batches": sorted(want)} if c.kind == "eval" else {}))
        if c.kind == "eval":
            r = {slot: (i, r[i]) for slot, (i, _) in got.items()}
        return r

    if control:
        found["control"] = in_place(control=True)
    for name, (kinds, planted) in FAULTS.items():
        if fault and c.kind in kinds:
            with planted():
                found[f"fault_{name}"] = in_place()
    out = []
    for who, r in found.items():
        numbers, where = mod.compare(r, want)
        row = {"seed": seed, "who": who, "numbers": numbers, "where": where,
               "seconds": time.time() - t0}
        if c.kind == "train":
            row["leaf_gaps"] = {k: common.leaf_gap_map(r[k], want[k])
                                for k in ("grad1", "change")}
        out.append(row)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    from benchlib import common
    cell = common.Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    fault = {int(s) for s in args.fault_seeds.split(",") if s}
    cache = {}
    rows = []
    for seed in sorted(set(seeds) | ctl | fault):
        for r in readings(cell, seed, "cuda:0", args.seconds, seed in ctl,
                          seed in fault, cache):
            print(json.dumps(r), flush=True)
            rows.append(r)
    summary = {}
    for who in dict.fromkeys(r["who"] for r in rows):
        agg = max if who == "program" else min
        got = [r["numbers"] for r in rows if r["who"] == who]
        summary[who] = {k: agg(g[k] for g in got) for k in got[0]}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
