"""What every cell shares: the cell's files found by name, the window's
rate and percentile arithmetic, the comparison numbers beside their
limits, and the result line."""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
import time

import numpy as np

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# top-level module names that no benchmark process may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "stratified_transformer_tpu")


def load_json(*parts):
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


class Cell:
    """One entry of ``BENCHMARK.json``'s ``workloads`` and the files it
    names: ``configs/<config>.json``, ``traffic/<traffic>.json`` and
    ``workloads/<name>.json`` (its kind, limits and check sizes); the
    metrics it reports follow from ``BENCHMARK.json``."""

    def __init__(self, name, bench=None):
        bench = bench or json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
        entry = [w for w in bench["workloads"] if w["name"] == name]
        if not entry:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entry[0]
        self.config = load_json("configs", self.entry["config"] + ".json")
        self.traffic = load_json("traffic", self.entry["traffic"] + ".json")
        self.spec = load_json("workloads", name + ".json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in e2e]

    @property
    def yaml(self):
        return dict(self.config["yaml"])


def process_start():
    """This process's start on the ``time.time()`` clock (Linux: from
    ``/proc``), or None where it cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def percentile(values, q):
    """The ``q``-th percentile (0-100) of ``values`` by linear
    interpolation between order statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def quartile_spread(values):
    """The distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def rate(count, seconds):
    return count / seconds


def forbidden_modules():
    """The forbidden top-level names among ``sys.modules``, compared whole
    (the part of each name before the first dot)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def relative_gap(got, want, floor):
    """``|got - want|`` over the larger of ``|want|`` and ``floor``."""
    return abs(got - want) / max(abs(want), floor)


def leaf_gaps(got, want, rule=None):
    """The widest `relative_gap` of leaf norms ``got`` / ``want`` (``{name:
    norm}``), each against the larger of its reference norm and the median
    reference norm; ``rule(name)`` False leaves a leaf out; a leaf that
    ``got`` lacks (no gradient reached the optimizer) reads norm 0.
    Returns ``(gap, leaf)``."""
    gaps = leaf_gap_map(got, want, rule)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def leaf_gap_map(got, want, rule=None):
    """``{name: gap}`` of every leaf `leaf_gaps` takes."""
    names = [n for n in want if rule is None or rule(n)]
    med = statistics.median(want[n] for n in names)
    return {n: relative_gap(got.get(n, 0.0), want[n], med) for n in names}


def moving_leaves(grad_norms):
    """The rule that leaves out of the change the leaves whose reference
    gradient is under a thousandth of the median leaf's (round-off moves
    them under Adam)."""
    med = statistics.median(grad_norms.values())
    return lambda n: grad_norms[n] >= 1e-3 * med


def checks(numbers, limits):
    """``{name: {"value": v, "limit": l}}`` for each limit, in the order
    of ``limits``; a limit without its number raises."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def all_within(check):
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in check.values())


def emit(result):
    """Print the comparison numbers as the last lines on stderr and the
    result as the last line on stdout (its ``checks`` key last)."""
    for k, c in result.get("checks", {}).items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
