"""One run of one cell: set-up, the window, the traced readings, the
comparison with the reference, and the result line's fields. Independent
of the device, so that the tests drive it on the CPU."""

from __future__ import annotations

import importlib
import importlib.util
import os
import subprocess
import time

import torch

from benchlib import common, devtime


def cell_module(kind):
    """The driver module of a cell kind: ``benchlib/<kind>_cell.py``."""
    return importlib.import_module(f"benchlib.{kind}_cell")


def reader(name):
    """The ``read(probe)`` of ``metrics/<name>.py``."""
    path = os.path.join(common.BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run(cell, seed, seconds, trace, device, t_start, log=print):
    """The result of one run (without its last line's printing)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    mod = cell_module(cell.spec["kind"])
    c = mod.CELL(cell, seed, dev)
    c.setup()
    setup_s = time.time() - t_start
    w = c.window(seconds)
    e2e = dict(c.end_to_end(), setup_s=setup_s)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    log(f"window: {w['calls']} calls, {w['points']} points, "
        f"{w['wall_s']:.3f} s; set-up {setup_s:.3f} s; peak memory "
        f"{peak} bytes (max_memory_allocated)")
    if cuda:
        log(f"card: {card_line()}")
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": int(cell.entry["chips"]),
                "memory_peak_bytes": int(peak)}
    metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
               for m in cell.end_to_end}
    breakdown = None
    if trace:
        for line in c.notes():
            log(line)
        probe = c.probe()
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"])(probe)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
            log(f"per-layer {m['name']}: {v}")
        prof = probe.profile
        dev_info["busy_s"] = prof["busy_s"]
        dev_info["window_s"] = prof["window_s"]
        breakdown = {"device_ops": devtime.top(prof["ops"]),
                     "idle_gaps": devtime.top(prof["gaps"])}
        log(f"attention device ms (forward, backward) per call "
            f"{probe.attention_ms}; model FLOPs per valid point "
            f"{probe.flops_per_point()}")
        if probe.geometry is not None:
            g = probe.geometry_profile
            log(f"geometry: {g['kernels']} kernels recorded, "
                f"{g['host_launches']} host launch calls in 2 calls")
        del probe
    readings = c.program_readings()
    c.free()
    numbers, where = mod.compare(readings, c.reference())
    log(f"compared: {numbers}; widest at {where}")
    check = common.checks(numbers, cell.spec["limits"])
    result = {"correct": common.all_within(check),
              "attempted": w["calls"], "failed": 0, "metrics": metrics,
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = check
    return result
