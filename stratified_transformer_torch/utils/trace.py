"""Named spans at the port's layer boundaries.

``with span("st.forward"): ...`` marks a region of host code. A span costs
one check when nothing listens. While a torch profiler runs, it opens a
``torch.profiler.record_function`` of its name, so that it sits in the
profiler's session on the clock of the device kernels it launches, nested
in the spans around it. While a `recorder` is open, it also adds its
duration on the host's ``time.perf_counter`` to the recorder's seconds by
name. There is no switch: tracing is on exactly while a profiler or a
recorder runs.

Every span's name starts with ``st.``. The spans, and what reads each, are
listed in ``PERF.md`` (section 3).
"""

from __future__ import annotations

import contextlib
import time

import torch

_profiling = torch._C._autograd._profiler_enabled

# the open recorders' seconds by span name, innermost last
_recorders: list[dict[str, float]] = []


class _Off:
    """The span when nothing listens: enters and exits doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "record", "t0")

    def __init__(self, name, args, profiling):
        self.name = name
        self.record = (torch.profiler.record_function(
            name, None if args is None else str(args)) if profiling
            else None)

    def __enter__(self):
        if self.record is not None:
            self.record.__enter__()
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.record is not None:
            self.record.__exit__(*exc)
        for seconds in _recorders:
            seconds[self.name] = seconds.get(self.name, 0.0) + dt
        return False


def span(name, args=None):
    """A context manager that marks its block as the span ``name``
    (``st.<layer>``); ``args`` (e.g. a call's index) goes to the profiler's
    record as a string. With no profiler and no recorder running it is one
    shared object that does nothing."""
    profiling = _profiling()
    if not profiling and not _recorders:
        return _OFF
    return _Span(name, args, profiling)


@contextlib.contextmanager
def recorder():
    """Collects the host seconds of every span that ends inside the block,
    summed by name: yields the ``{name: seconds}`` dict it fills."""
    seconds: dict[str, float] = {}
    _recorders.append(seconds)
    try:
        yield seconds
    finally:
        # by identity: another open recorder may hold equal seconds
        del _recorders[next(i for i, s in enumerate(_recorders)
                            if s is seconds)]
