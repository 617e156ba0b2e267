"""The program's own spans (``st.*``, ``stratified_transformer_torch/utils/
trace.py``) read from a profiled window: what each span launched on the
card and which idle gaps began inside it.

`reading` profiles ``probe.call`` over ``probe.profile_reps`` calls, held
complete as `devtime.profile_window` holds its session, and attributes:

- each device record to its host launch, by the profiler's correlation id
  (the runtime call and the record share it), and the launch to the
  innermost ``st.`` span open when the call began;
- each idle gap of the card (between two stretches of device activity) by
  its start to the innermost ``st.`` span then open: **sync idle** if a
  synchronizing host call (`SYNC_CALLS`, or a copy to pageable host
  memory) covers the start, **launch idle** otherwise. A gap that begins
  outside every span is neither.

It prints a table of the spans per call, and the coverage, as log lines
before the result line. A program without the spans (no module ``utils/
trace.py``, or no ``st.`` span in the session) reads None everywhere.
"""

from __future__ import annotations

import bisect
import importlib.util
import re

import torch

from benchlib import devtime

SPAN_PREFIX = "st."

# host calls that wait for the card
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize"})

# copies that wait for the card when their device record is a copy to
# pageable host memory (``cudaMemcpy`` always waits)
COPY_CALLS = frozenset({"cudaMemcpy", "cudaMemcpyAsync"})
PAGEABLE_DTOH = re.compile(r"DtoH.*Pageable|Device -> Pageable")

# the plans' spans (``models/stratified.py::BasicLayer.forward``)
PLAN_SPAN = re.compile(r"^st\.stage\d+\.plan$")

# attempts at a complete session before the run fails
ATTEMPTS = 3


def _timeline(spans):
    """``(times, chains, parents)`` of ``spans`` (``[(start, end,
    name)]``): from ``times[k]`` on, the spans ``chains[k]`` are open
    (indices, outermost first); ``parents[i]`` is the innermost span open
    when span ``i`` began (None at the top)."""
    bounds = sorted([(s, 1, -e, i) for i, (s, e, _) in enumerate(spans)]
                    + [(e, 0, 0, i) for i, (_, e, _) in enumerate(spans)])
    active, parents = [], [None] * len(spans)
    times, chains = [], []
    k = 0
    while k < len(bounds):
        t = bounds[k][0]
        while k < len(bounds) and bounds[k][0] == t:
            _, is_start, _, i = bounds[k]
            if is_start:
                parents[i] = active[-1] if active else None
                active.append(i)
                active.sort(key=lambda j: (spans[j][0], -spans[j][1]))
            else:
                active.remove(i)
            k += 1
        times.append(t)
        chains.append(tuple(active))
    return times, chains, parents


def _chain_at(times, chains, t):
    k = bisect.bisect_right(times, t) - 1
    return chains[k] if k >= 0 else ()


def _gaps(records):
    """The idle gaps ``[(start, end)]`` between the union of the device
    records' intervals."""
    iv = sorted((s, e) for s, e, _ in records)
    gaps = []
    cur = iv[0][1]
    for s, e in iv[1:]:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    return gaps


def attribute(spans, records, syncs, reps):
    """The per-call table of ``spans`` (``[(start, end, name)]``, host
    intervals) over device ``records`` (``[(start, end, launched_at)]``,
    ``launched_at`` the host time of the launching call or None) and the
    synchronizing host calls ``syncs`` (``[(start, end)]``), all on one
    clock, for ``reps`` calls. Returns ``{"spans": {name: row}, ...}``
    where a row holds, per call: ``calls``, ``host_ms`` and its
    ``host_self_ms`` (less the spans directly inside), ``dev_ms`` (device
    time launched inside it, the spans inside included) and
    ``dev_self_ms`` (launched with it the innermost), ``idle_ms`` /
    ``idle_self_ms`` (idle begun inside it), ``syncs`` (synchronizing
    calls begun with it the innermost) and ``sync_idle_ms`` (its own
    idle begun inside one), ``order`` and ``depth`` (of its first
    occurrence); beside them ``launch_idle_ms``, ``sync_idle_ms``,
    ``idle_ms`` (every gap), ``outside_idle_ms`` (gaps begun outside every
    span), ``dev_ms`` and ``unlaunched_ms`` (records with no launch
    found)."""
    times, chains, parents = _timeline(spans)
    rows = {}

    def row(i):
        name = spans[i][2]
        if name not in rows:
            depth, p = 0, parents[i]
            while p is not None:
                depth, p = depth + 1, parents[p]
            rows[name] = {"calls": 0, "host_ms": 0.0, "host_self_ms": 0.0,
                          "dev_ms": 0.0, "dev_self_ms": 0.0, "idle_ms": 0.0,
                          "idle_self_ms": 0.0, "syncs": 0,
                          "sync_idle_ms": 0.0, "order": spans[i][0],
                          "depth": depth}
        return rows[name]

    for i in sorted(range(len(spans)), key=lambda j: spans[j][0]):
        s, e, _ = spans[i]
        r = row(i)
        r["calls"] += 1
        r["host_ms"] += (e - s) / 1e3
        r["host_self_ms"] += (e - s) / 1e3
        if parents[i] is not None:
            row(parents[i])["host_self_ms"] -= (e - s) / 1e3
    dev = unlaunched = 0.0
    for s, e, at in records:
        dev += (e - s) / 1e3
        if at is None:
            unlaunched += (e - s) / 1e3
            continue
        chain = _chain_at(times, chains, at)
        for i in chain:
            row(i)["dev_ms"] += (e - s) / 1e3
        if chain:
            row(chain[-1])["dev_self_ms"] += (e - s) / 1e3
    sync_starts = [s for s, _ in sorted(syncs)]
    reach = []
    for _, e in sorted(syncs):
        reach.append(max(e, reach[-1]) if reach else e)

    def in_sync(t):
        k = bisect.bisect_right(sync_starts, t) - 1
        return k >= 0 and reach[k] >= t

    for s, _ in syncs:
        chain = _chain_at(times, chains, s)
        if chain:
            row(chain[-1])["syncs"] += 1
    totals = {"launch_idle_ms": 0.0, "sync_idle_ms": 0.0, "idle_ms": 0.0,
              "outside_idle_ms": 0.0}
    for g0, g1 in (_gaps(records) if records else []):
        ms = (g1 - g0) / 1e3
        totals["idle_ms"] += ms
        chain = _chain_at(times, chains, g0)
        if not chain:
            totals["outside_idle_ms"] += ms
            continue
        for i in chain:
            row(i)["idle_ms"] += ms
        inner = row(chain[-1])
        inner["idle_self_ms"] += ms
        if in_sync(g0):
            inner["sync_idle_ms"] += ms
            totals["sync_idle_ms"] += ms
        else:
            totals["launch_idle_ms"] += ms
    for r in rows.values():
        for k in r:
            if k not in ("order", "depth"):
                r[k] /= reps
    out = {k: v / reps for k, v in totals.items()}
    out.update(spans=rows, dev_ms=dev / reps, unlaunched_ms=unlaunched / reps)
    return out


def from_events(events):
    """``(spans, records, syncs)`` of `attribute` from a profiler
    session's events."""
    dev = [e for e in events if devtime._is_device(e)]
    host = [e for e in events if not devtime._is_device(e)
            and e.device_type == torch.autograd.DeviceType.CPU]
    # the runtime calls (``cuda*``, ``cu*``), by the correlation id they
    # share with the device record they made; the host's operations have
    # ids of their own, which collide with them (``aten::item`` and a
    # ``cudaLaunchKernel`` both 7 in one session on the H100)
    runtime = {e.id: e for e in host if e.name.startswith("cu")}
    records, dtoh = [], set()
    for e in dev:
        launch = runtime.get(e.id)
        records.append((e.time_range.start, e.time_range.end,
                        None if launch is None
                        else launch.time_range.start))
        if PAGEABLE_DTOH.search(e.name):
            dtoh.add(e.id)
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in host
             if e.name.startswith(SPAN_PREFIX)]
    syncs = [(e.time_range.start, e.time_range.end) for e in host
             if e.name in SYNC_CALLS or e.name == "cudaMemcpy"
             or (e.name in COPY_CALLS and e.id in dtoh)]
    return spans, records, syncs


def _session(fn, reps, launches):
    """The events of ``reps`` profiled calls of ``fn``, held complete as
    `devtime.profile_window` holds its session (one attention kernel
    recorded per counted launch, some device time); None after
    `ATTEMPTS` incomplete sessions raises."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(ATTEMPTS):
        torch.cuda.synchronize()
        before = launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        dev = [e for e in events if devtime._is_device(e)]
        launched = sum(launches().values()) - sum(before.values())
        recorded = sum(1 for e in dev
                       if devtime.ATTENTION_KERNEL.search(e.name))
        if dev and recorded == launched:
            return events
        print(f"spans: the profiler lost device records (attention kernels "
              f"launched {launched}, recorded {recorded}, device records "
              f"{len(dev)}); profiling again", flush=True)
    raise AssertionError(f"no complete profiler session in {ATTEMPTS} "
                         "attempts")


def _has_spans():
    return importlib.util.find_spec(
        "stratified_transformer_torch.utils.trace") is not None


def reading(probe):
    """`attribute`'s result for ``probe.call`` (cached on the probe), or
    None where the program records no spans. Prints the table first."""
    if "span_reading" in vars(probe):
        return probe.span_reading
    out = None
    if _has_spans():
        reps = probe.profile_reps
        spans, records, syncs = from_events(
            _session(probe.call, reps, probe.launches))
        if spans:
            out = attribute(spans, records, syncs, reps)
            for line in table_lines(out, reps, probe.call_ms - probe.busy_ms):
                print(line, flush=True)
        else:
            print("spans: no st. span in the profiled calls", flush=True)
    probe.span_reading = out
    return out


def table_lines(out, reps, unprofiled_idle_ms):
    """The log lines of `attribute`'s result: one row per span, in the
    order of first occurrence and indented by depth, then the coverage."""
    cols = ("calls", "host_ms", "host_self_ms", "dev_ms", "dev_self_ms",
            "idle_ms", "idle_self_ms", "syncs", "sync_idle_ms")
    lines = [f"spans per call ({reps} profiled calls; dev_ms / idle_ms: "
             "launched / begun inside the span, *_self: with it the "
             "innermost)",
             f"{'span':<28}" + "".join(f"{c:>13}" for c in cols)]
    for name, r in sorted(out["spans"].items(),
                          key=lambda kv: kv[1]["order"]):
        label = "  " * r["depth"] + name
        lines.append(f"{label:<28}" + "".join(
            f"{r[c]:>13.3f}" if isinstance(r[c], float) else f"{r[c]:>13}"
            for c in cols))
    attributed = out["launch_idle_ms"] + out["sync_idle_ms"]
    share = 100.0 * attributed / out["idle_ms"] if out["idle_ms"] else 0.0
    lines.append(
        f"span coverage per call: launch idle {out['launch_idle_ms']:.3f} "
        f"ms + sync idle {out['sync_idle_ms']:.3f} ms = {attributed:.3f} ms "
        f"of {out['idle_ms']:.3f} ms profiled idle ({share:.1f}%), "
        f"{out['outside_idle_ms']:.3f} ms begun outside every span; "
        f"unprofiled idle (window call ms - busy ms) "
        f"{unprofiled_idle_ms:.3f} ms; device ms {out['dev_ms']:.3f}, "
        f"{out['unlaunched_ms']:.3f} of it with no launch found")
    return lines


def plan_ms(probe):
    """Device ms per call launched inside the plans' spans."""
    r = reading(probe)
    if r is None:
        return None
    rows = [v for k, v in r["spans"].items() if PLAN_SPAN.match(k)]
    return sum(v["dev_ms"] for v in rows) if rows else None


def span_dev_ms(probe, name):
    """Device ms per call launched inside the span ``name``, the spans
    inside it included."""
    r = reading(probe)
    if r is None or name not in r["spans"]:
        return None
    return r["spans"][name]["dev_ms"]


def idle_ms(probe, key):
    """``launch_idle_ms`` or ``sync_idle_ms`` per call."""
    r = reading(probe)
    return None if r is None else r[key]
