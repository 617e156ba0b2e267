"""Runs one cell of the benchmark of ``stratified_transformer_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The cell's
configuration, traffic and kind are the files that ``BENCHMARK.json``'s
entry names (`benchlib.common.Cell`). Needs a CUDA card: without one, or
with fewer cards than the cell asks for, it prints no result and exits 2.
Prints log lines, then the comparison numbers beside their limits as the
last lines on stderr, and one JSON object as the last line on stdout. With
``--trace 0`` its metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, with the profiler's ``busy_s``,
``window_s`` and ``breakdown``. Exits 3, with no result, if a module of
JAX or of the JAX package is loaded when the result is due.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    sys.path[:0] = [HERE, ROOT]
    from benchlib import common, runner
    from benchlib.common import process_start
    cell = common.Cell(args.workload)
    import torch
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    start = process_start() or T_START
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                        "cuda:0", start, log=lambda m: print(m, flush=True))
    bad = common.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    common.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
