"""PyTorch port, the spans (``utils/trace.py``): a shared no-op when nothing
listens, the nesting of the train step's and the eval call's spans under
the profiler, results bit-identical with tracing on and off, and the
training driver's epoch seconds taken from a recorder; on the CPU at a
narrow width."""

import contextlib
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stratified_transformer_torch.config import StratifiedConfig
from stratified_transformer_torch.data import loader
from stratified_transformer_torch.eval.driver import make_predict_probs
from stratified_transformer_torch.models.stratified import build_model
from stratified_transformer_torch.train import driver, schedulers
from stratified_transformer_torch.train.state import make_optimizer
from stratified_transformer_torch.train.step import make_train_step
from stratified_transformer_torch.utils import trace
from stratified_transformer_torch.utils.config import (
    load_cfg, merge_cfg_from_list)

torch.set_num_threads(1)

NARROW = dict(num_classes=13, in_channels=6, channels=(16, 32, 64, 128),
              num_heads=(1, 2, 4, 8), depths=(1, 1, 2, 1), num_layers=4,
              n_pad=2048, num_scenes=2, tile=128, band=128,
              band_per_stage=(128, 128, 384, 192), sparse_cap=48, s_band=128,
              drop_path_rate=0.3)
SCHEDULE = {"scheduler": "MultiStep", "scheduler_update": "epoch",
            "base_lr": 0.006, "epochs": 100}
STAGES = range(4)
CONFIG = str(pathlib.Path(__file__).resolve().parents[1] / "configs"
             / "s3dis_stratified.yaml")


@pytest.fixture
def recorded_args(monkeypatch):
    """``[(name, args)]`` of every ``record_function`` the spans open."""
    real = torch.profiler.record_function
    seen = []

    def record(name, args=None):
        seen.append((name, args))
        return real(name, args)
    monkeypatch.setattr(torch.profiler, "record_function", record)
    return seen


def st_events(prof):
    return [e for e in prof.events() if e.name.startswith("st.")]


def st_parent(e):
    """The innermost ``st.`` span around ``e`` (by the profiler's tree)."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("st."):
        p = p.cpu_parent
    return None if p is None else p.name


def parents(events):
    """``{name: {parent names}}`` of the ``st.`` spans."""
    out = {}
    for e in events:
        out.setdefault(e.name, set()).add(st_parent(e))
    return out


def test_span_off_is_one_shared_no_op(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function with no profiler running")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = trace.span("st.a"), trace.span("st.b", 3)
    assert a is b
    with a as inside, b:
        assert inside is None


def test_recorder_sums_host_seconds_by_name(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", None)
    with trace.recorder() as outer:
        for _ in range(2):
            with trace.span("st.a"):
                with trace.recorder() as inner, trace.span("st.b"):
                    pass
    assert set(outer) == {"st.a", "st.b"} and set(inner) == {"st.b"}
    assert outer["st.a"] >= outer["st.b"] >= inner["st.b"] >= 0.0
    assert trace.span("st.a") is trace.span("st.b")


def train_run(traced, batch, seed=5):
    """One train step of a fresh narrow model; with ``traced`` under the
    CPU profiler and a recorder. Returns (stats, grads, params,
    profile)."""
    cfg = StratifiedConfig(**NARROW)
    model = build_model(cfg, "cpu", seed=seed, train=True)
    opt = make_optimizer(model, schedulers.from_config(SCHEDULE, 2)[0])
    step = make_train_step(255, cfg.num_classes)
    gen = torch.Generator().manual_seed(11)
    prof = (profile(activities=[ProfilerActivity.CPU]) if traced
            else contextlib.nullcontext())
    with prof, (trace.recorder() if traced else contextlib.nullcontext()):
        stats = step(model, opt, batch, gen)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    params = {n: p.detach().clone() for n, p in model.state_dict().items()}
    return stats, grads, params, prof if traced else None


@pytest.fixture(scope="module")
def train_runs():
    batch = loader.to_device(
        loader.host_batch(StratifiedConfig(**NARROW), seed=0), "cpu")
    return train_run(False, batch), train_run(True, batch)


def test_train_step_spans_nest(train_runs, recorded_args):
    _, (_, _, _, prof) = train_runs
    got = parents(st_events(prof))
    step = {"st.forward", "st.loss", "st.backward", "st.optimizer",
            "st.metrics"}
    model = ({"st.stem", "st.head"} | {f"st.stage{i}" for i in STAGES}
             | {f"st.down{i}" for i in range(3)}
             | {f"st.up{j}" for j in range(3)})
    plans = {f"st.stage{i}.plan" for i in STAGES}
    blocks = {f"st.stage{i}.block{b}" for i in STAGES
              for b in range(NARROW["depths"][i])}
    assert set(got) == {"st.train_step"} | step | model | plans | blocks
    assert got["st.train_step"] == {None}
    for name in step:
        assert got[name] == {"st.train_step"}, name
    for name in model:
        assert got[name] == {"st.forward"}, name
    for name in plans | blocks:
        assert got[name] == {name.rsplit(".", 1)[0]}, name
    # the step's index goes to the profiler's record as its args
    cfg = StratifiedConfig(**NARROW)
    model_ = build_model(cfg, "cpu", seed=1, train=True)
    opt = make_optimizer(model_, schedulers.from_config(SCHEDULE, 2)[0])
    opt.param_groups[0]["t"] = 7
    batch = loader.to_device(loader.host_batch(cfg, seed=0), "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        make_train_step(255, cfg.num_classes)(
            model_, opt, batch, torch.Generator().manual_seed(11))
    assert recorded_args[0] == ("st.train_step", "7")
    assert all(args is None for _, args in recorded_args[1:])


def test_train_step_bit_identical_traced(train_runs):
    (s0, g0, p0, _), (s1, g1, p1, _) = train_runs
    for key in s0:
        assert torch.equal(s0[key], s1[key]), key
    assert set(g0) == set(g1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name


def test_eval_call_spans_and_probabilities(recorded_args):
    """Two ``predict_probs`` calls, the second under the profiler: the
    probabilities bit-identical, the call's spans nested, the on-device
    geometry inside the forward, and the call index as the top span's
    args."""
    cfg = StratifiedConfig(**NARROW)
    model = build_model(cfg, "cpu", seed=3)
    hb = loader.host_batch(cfg, seed=0)
    predict = make_predict_probs(model)
    args = (hb["feats"], hb["xyz"], hb["offsets"])
    want = predict(*args)
    assert recorded_args == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = predict(*args)
    np.testing.assert_array_equal(got, want)
    tree = parents(st_events(prof))
    assert tree["st.predict"] == {None}
    for name in ("st.upload", "st.forward", "st.download"):
        assert tree[name] == {"st.predict"}, name
    for name in ("st.geometry.stem", "st.geometry.pyramid", "st.stem",
                 "st.head", *(f"st.stage{i}" for i in STAGES)):
        assert tree[name] == {"st.forward"}, name
    for i in STAGES:
        assert tree[f"st.stage{i}.plan"] == {f"st.stage{i}"}
        assert tree[f"st.stage{i}.block0"] == {f"st.stage{i}"}
    assert recorded_args[0] == ("st.predict", "1")


def test_driver_epoch_seconds_from_the_recorder(tmp_path, monkeypatch):
    """``train.driver.run``'s ``timing`` seconds are the recorder's
    ``st.loader_wait``, ``st.upload`` and ``st.step_block``."""
    filled = []
    real = trace.recorder

    @contextlib.contextmanager
    def keep():
        with real() as seconds:
            filled.append(seconds)
            yield seconds
    monkeypatch.setattr(trace, "recorder", keep)
    opts = []
    for key, value in dict(NARROW, max_batch_points=2048, batch_size=2,
                           voxel_max=900).items():
        if key in ("channels", "num_heads", "depths", "max_batch_points",
                   "batch_size", "voxel_max"):
            opts += [key, str(list(value) if isinstance(value, tuple)
                              else value).replace(" ", "")]
    cfg = merge_cfg_from_list(load_cfg(CONFIG), opts + [
        "data_name", "synthetic", "synthetic_scenes", "4",
        "synthetic_points", "1500", "epochs", "1", "use_tensorboard",
        "False", "evaluate", "False", "save_path", str(tmp_path)])
    _, summary = driver.run(cfg, "cpu", log=lambda _: None)
    [timing] = summary["timing"]
    [seconds] = filled
    for key, name in (("load_wait_s", "st.loader_wait"),
                      ("upload_s", "st.upload"),
                      ("step_block_s", "st.step_block")):
        assert timing[key] == seconds[name] >= 0.0, key
    assert summary["steps"] == 2
