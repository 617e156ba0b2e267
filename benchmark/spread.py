"""Spreads of a cell's end-to-end metrics over two sets of runs, from which
its bounds are set: per set the median and the quartile spread
(`benchlib.common.quartile_spread`) of each metric, the widest spread, and
five times it (at least 1%) as the bound it would give.

    python3 benchmark/spread.py [--built-first] <runs.jsonl> ...

Each input line is ``{"set": "A", "seed": n, "result": <run.py's last
line>}``. With ``--built-first`` the first line's run built the kernels
(the first run of a call), and ``setup_s`` leaves it out."""

import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from benchlib.common import quartile_spread  # noqa: E402


def main(args):
    built_first = "--built-first" in args
    paths = [a for a in args if a != "--built-first"]
    rows = [json.loads(line) for p in paths for line in open(p)
            if line.strip()]
    by_set = {}
    for i, r in enumerate(rows):
        res = r["result"]
        if not res or not res.get("correct"):
            print(f"run {r.get('set')} {r.get('seed')}: not correct or no "
                  f"result: {res and res.get('checks')}")
            continue
        for name, m in res["metrics"].items():
            if name == "setup_s" and i == 0 and built_first:
                continue
            by_set.setdefault(name, {}).setdefault(r["set"], []).append(
                m["value"])
    for name, sets in sorted(by_set.items()):
        spreads = {s: quartile_spread(v) for s, v in sets.items()
                   if len(v) >= 2}
        widest = max(spreads.values())
        medians = {s: statistics.median(v) for s, v in sets.items()}
        print(json.dumps({"metric": name, "medians": medians,
                          "spreads": spreads, "widest": widest,
                          "bound_5x": max(5 * widest, 0.01),
                          "values": sets}))


if __name__ == "__main__":
    main(sys.argv[1:])
