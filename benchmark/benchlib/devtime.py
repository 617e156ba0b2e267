"""Device time on the card (frozen copies of ``chip_smoke.py``'s
``device_busy_ms`` and ``device_kernels``) and the profiler's reading of a
steady window: busy time, the top device operations and the idle gaps by
what the host was doing."""

from __future__ import annotations

import bisect
import re
import time

import torch

# the sleep kernel calls are queued behind, in cycles of the card's clock
# (~50 ms on the H100): longer than the host takes to enqueue the calls
SLEEP_CYCLES = int(1e8)

# the four attention kernels' device names (fp32 and bf16 forms)
ATTENTION_KERNEL = re.compile(r"stratified::\w*attention\w*_kernel")

# device records that are copies or fills, not kernels
MEMORY_OP = re.compile(r"^(Memcpy|Memset|memcpy|memset)")

# the host's calls that launch one kernel each, as the profiler names them
HOST_LAUNCHES = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx"})


def device_busy_ms(fn, reps, cycles=SLEEP_CYCLES):
    """Device time of ``fn()`` per call without the card's idle gaps while
    the host dispatches: ``reps`` calls after one warm-up, queued behind a
    sleep kernel so that the card runs them back to back, timed by CUDA
    events from the sleep's end. ``fn`` must not wait for the card. If the
    host has not enqueued the calls before the sleep ends, the sleep is
    doubled and the calls timed again (up to 4 times); returns None then,
    and a reading that is not positive raises."""
    fn()
    torch.cuda.synchronize()
    for _ in range(4):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            busy = start.elapsed_time(end) / reps
            if not busy > 0:
                raise AssertionError(f"device time {busy} ms of {reps} "
                                     "calls that launch device work")
            return busy
        cycles *= 2
    return None


def _is_device(e):
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def profile_window(fn, reps, launches, same_work=False):
    """``reps`` profiled calls of ``fn`` after a synchronize: a dict of the
    window's wall seconds (``window_s``), the union of device activity
    (``busy_s``), device time by operation name (``ops``: ``{name:
    seconds}``), the idle gaps by the innermost host operation running
    when each began (``gaps``: ``{name: seconds}``), and the kernels
    recorded on the device and launched by the host (``kernels``,
    ``host_launches``).

    On the H100 machine the profiler can lose device records, so a session
    is held complete or raises: ``launches()`` returns the attention
    kernels' launch counts (the program's wrappers count them), and the
    session must hold one record of an attention kernel per counted launch,
    and some device time. With ``same_work`` (every call runs the same
    kernels) it must also hold each device operation a multiple of
    ``reps`` times, and one kernel for each of the host's launch calls
    (the launch calls and the kernels are separate records of the
    profiler; over two calls of the S3DIS and ScanNet eval geometry they
    matched one for one on the H100, 9506 and 12828)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    before = launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev = [e for e in events if _is_device(e)]
    launched = sum(launches().values()) - sum(before.values())
    recorded = sum(1 for e in dev if ATTENTION_KERNEL.search(e.name))
    kernels = sum(1 for e in dev if not MEMORY_OP.search(e.name))
    host_launches = sum(1 for e in events if not _is_device(e)
                        and e.name in HOST_LAUNCHES)
    counts = {}
    for e in dev:
        counts[e.name] = counts.get(e.name, 0) + 1
    uneven = [n for n, k in counts.items() if k % reps] if same_work else []
    if (recorded != launched or not dev or uneven
            or (same_work and kernels != host_launches)):
        raise AssertionError(
            f"the profiler lost device records: attention kernels launched "
            f"{launched}, recorded {recorded}, device records {len(dev)}, "
            f"kernels {kernels} of {host_launches} host launch calls, "
            f"operations not recorded a multiple of {reps} times: "
            f"{uneven[:5]}")
    ops = {}
    spans = []
    for e in dev:
        s, t = e.time_range.start, e.time_range.end
        ops[e.name] = ops.get(e.name, 0.0) + (t - s) / 1e6
        spans.append((s, t))
    spans.sort()
    busy = 0.0
    gaps = []
    cur_s, cur_e = spans[0]
    for s, t in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    busy += cur_e - cur_s
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events if not _is_device(e)
                   and e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda r: r[0])
    by_host = {}
    starts = [h[0] for h in host]
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0)
        name = "host Python (no profiled operation)"
        # the innermost host operation covering the gap's start: the one
        # that started last among those still running
        for j in range(i - 1, max(i - 200, -1), -1):
            _, he, hn = host[j]
            if he >= g0:
                name = hn
                break
        by_host[name] = by_host.get(name, 0.0) + (g1 - g0) / 1e6
    return {"window_s": wall, "busy_s": busy / 1e6, "ops": ops,
            "gaps": by_host, "kernels": kernels,
            "host_launches": host_launches}


def top(d, n=10):
    """The ``n`` largest entries of ``{name: seconds}`` as ``[[name,
    seconds], ...]``."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
