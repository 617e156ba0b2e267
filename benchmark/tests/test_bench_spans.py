"""The attribution of device time and idle gaps to the program's spans
(`benchlib.spans`) on hand-made intervals, in microseconds."""

import types

import pytest
import torch

from benchlib import runner, spans

# st.step [0, 97] > st.forward [10, 60] > st.stage1.plan [20, 40]
SPANS = [(0.0, 97.0, "st.step"), (10.0, 60.0, "st.forward"),
         (20.0, 40.0, "st.stage1.plan")]
# (start, end, host time of the launch)
RECORDS = [(0.0, 5.0, 1.0), (22.0, 30.0, 21.0), (50.0, 72.0, 45.0),
           (95.0, 98.0, 92.0), (110.0, 120.0, None)]
SYNCS = [(70.0, 90.0)]


def test_gaps_by_span_and_sync():
    out = spans.attribute(SPANS, RECORDS, SYNCS, reps=1)
    ms = pytest.approx
    # (5, 22) begins in st.step, no sync: launch idle; (30, 50) in the
    # plan: launch idle; (72, 95) in st.step inside the sync: sync idle;
    # (98, 110) after every span: neither
    assert out["launch_idle_ms"] == ms((17 + 20) / 1e3)
    assert out["sync_idle_ms"] == ms(23 / 1e3)
    assert out["outside_idle_ms"] == ms(12 / 1e3)
    assert out["idle_ms"] == ms(72 / 1e3)
    assert out["dev_ms"] == ms(48 / 1e3)
    assert out["unlaunched_ms"] == ms(10 / 1e3)
    step, fwd, plan = (out["spans"][n] for n in
                       ("st.step", "st.forward", "st.stage1.plan"))
    assert [step["depth"], fwd["depth"], plan["depth"]] == [0, 1, 2]
    assert step["host_ms"] == ms(0.097)
    assert step["host_self_ms"] == ms(0.047)
    assert fwd["host_self_ms"] == ms(0.030)
    assert plan["host_self_ms"] == ms(0.020)
    # device time by the launch's span: the plan's record counts in each
    # span around it, and as its own in the plan alone
    assert (step["dev_ms"], step["dev_self_ms"]) == (ms(0.038), ms(0.008))
    assert (fwd["dev_ms"], fwd["dev_self_ms"]) == (ms(0.030), ms(0.022))
    assert (plan["dev_ms"], plan["dev_self_ms"]) == (ms(0.008), ms(0.008))
    assert (step["idle_ms"], step["idle_self_ms"]) == (ms(0.060), ms(0.040))
    assert (fwd["idle_ms"], fwd["idle_self_ms"]) == (ms(0.020), 0.0)
    assert plan["idle_self_ms"] == ms(0.020)
    assert (step["syncs"], step["sync_idle_ms"]) == (1, ms(0.023))
    assert plan["sync_idle_ms"] == 0.0


def test_per_call_and_repeated_spans():
    """Two calls of the same spans: the table is per call."""
    shift = 200.0
    two = spans.attribute(
        SPANS + [(s + shift, e + shift, n) for s, e, n in SPANS],
        RECORDS + [(s + shift, e + shift, None if a is None else a + shift)
                   for s, e, a in RECORDS],
        SYNCS + [(s + shift, e + shift) for s, e in SYNCS], reps=2)
    one = spans.attribute(SPANS, RECORDS, SYNCS, reps=1)
    assert two["spans"]["st.step"]["calls"] == 1
    assert two["launch_idle_ms"] == pytest.approx(one["launch_idle_ms"])
    assert two["sync_idle_ms"] == pytest.approx(one["sync_idle_ms"])
    # the second call's first gap begins after the first call's spans
    assert two["outside_idle_ms"] > one["outside_idle_ms"]


class Ev:
    def __init__(self, name, eid, start, end, cuda=False, annotation=False):
        self.name, self.id = name, eid
        self.time_range = types.SimpleNamespace(start=start, end=end)
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.is_user_annotation = annotation


def test_from_events_links_by_correlation_and_finds_syncs():
    events = [
        Ev("st.forward", 1, 0.0, 100.0),
        Ev("aten::add", 5, 2.0, 9.0),  # an operation's id, not a launch's
        Ev("cudaLaunchKernel", 5, 3.0, 4.0),
        Ev("kernel", 5, 10.0, 20.0, cuda=True),
        Ev("cudaMemcpyAsync", 6, 30.0, 50.0),
        Ev("Memcpy DtoH (Device -> Pageable)", 6, 31.0, 40.0, cuda=True),
        Ev("cudaMemcpyAsync", 7, 60.0, 61.0),
        Ev("Memcpy HtoD (Pageable -> Device)", 7, 62.0, 63.0, cuda=True),
        Ev("cudaStreamSynchronize", 8, 70.0, 80.0),
        Ev("st.forward", 9, 0.0, 100.0, cuda=True, annotation=True),
        Ev("kernel of no launch", 99, 85.0, 86.0, cuda=True),
    ]
    got_spans, records, syncs = spans.from_events(events)
    assert got_spans == [(0.0, 100.0, "st.forward")]
    assert records == [(10.0, 20.0, 3.0), (31.0, 40.0, 30.0),
                       (62.0, 63.0, 60.0), (85.0, 86.0, None)]
    assert syncs == [(30.0, 50.0), (70.0, 80.0)]


def test_readers_read_the_cached_table():
    row = dict(dev_ms=2.0)
    probe = types.SimpleNamespace(kind="train", span_reading={
        "spans": {"st.stage1.plan": row, "st.stage2.plan": dict(dev_ms=3.0),
                  "st.optimizer": dict(dev_ms=7.0), "st.stage1": row},
        "launch_idle_ms": 11.0, "sync_idle_ms": 13.0})
    got = {n: runner.reader(n)(probe) for n in (
        "plan_ms.train", "plan_ms.eval", "optimizer_ms.train",
        "launch_idle_ms.train", "sync_idle_ms.train", "sync_idle_ms.eval")}
    assert got == {"plan_ms.train": 5.0, "plan_ms.eval": None,
                   "optimizer_ms.train": 7.0, "launch_idle_ms.train": 11.0,
                   "sync_idle_ms.train": 13.0, "sync_idle_ms.eval": None}


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_a_program_without_spans_reads_nothing(monkeypatch, kind):
    """The parent of the spans has no ``utils/trace.py``: every reader
    returns None without profiling."""
    monkeypatch.setattr(spans, "_has_spans", lambda: False)

    def refuse(*a):
        raise AssertionError("profiled a program without spans")
    monkeypatch.setattr(spans, "_session", refuse)
    probe = types.SimpleNamespace(kind=kind)
    for name in ("plan_ms", "launch_idle_ms", "sync_idle_ms",
                 "optimizer_ms"):
        if name == "optimizer_ms" and kind == "eval":
            continue
        assert runner.reader(f"{name}.{kind}")(probe) is None
    assert probe.span_reading is None
