"""PyTorch port, data-parallel training on the CPU: two gloo ranks (spawned
processes, ``tests/torch_dp_worker.py``) against the JAX package's
``make_dp_train_step`` on two of the eight virtual CPU devices
(``tests/conftest.py``), as ``tests/test_sharding.py`` runs it.

SyncBN alone; one DP step of a tiny S3DIS-style model, of the DCF model
with its offset head and of a Swin3D model, each on distinct batches per
rank; the port's DP step on identical batches against its one-device step;
each rank's loader batches bit-identical to the JAX loader's device shares;
``config.from_cfg`` per rank against ``train.py::build_model_config``; the
training driver on two ranks; and the multi-host rendezvous. Every spawned
rank joins its group with a 60 s timeout, and every spawn is joined within
JOIN_TIMEOUT_S, after which its ranks are killed and the test fails.
"""

import multiprocessing
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import train as jax_train
from stratified_transformer_tpu.models.layers import (
    MaskedBatchNorm as JaxBatchNorm)
from stratified_transformer_tpu.models.stratified import (
    Stratified as JaxStratified, StratifiedConfig as JaxConfig)
from stratified_transformer_tpu.parallel.dp import (
    make_dp_train_step as jax_make_dp_train_step, shard_batch)
from stratified_transformer_tpu.parallel.mesh import make_mesh
from stratified_transformer_tpu.train import schedulers as jax_sched
from stratified_transformer_tpu.train.state import (
    TrainState, make_optimizer as jax_make_optimizer)
from stratified_transformer_torch.config import StratifiedConfig, from_cfg
from stratified_transformer_torch.convert import from_flax
from stratified_transformer_torch.data import datasets, loader
from stratified_transformer_torch.data.collate import collate_scenes
from stratified_transformer_torch.data.prepare import with_xyz_concat
from stratified_transformer_torch.models.stratified import build_model
from stratified_transformer_torch.parallel import mesh
from stratified_transformer_torch.train import checkpoint, driver
from stratified_transformer_torch.train import schedulers as torch_sched
from stratified_transformer_torch.train.state import make_optimizer
from stratified_transformer_torch.train.step import (
    make_train_step, pack_stats)
from stratified_transformer_torch.utils.config import (
    load_cfg, merge_cfg_from_list)
from test_torch_loop import (
    LOOP, NARROW as LOOP_NARROW, assert_batches_equal, write_rooms,
    yaml_cfg)
from test_torch_train import _random_variables, _record_grads

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dp_worker.py")
CONFIGS = os.path.join(ROOT, "configs")
WORLD = 2
JOIN_TIMEOUT_S = 180
# floats against the JAX package, as its own DP test holds them
# (tests/test_sharding.py:69-71)
RTOL, ATOL = 2e-4, 2e-5
# the JAX test suite's tiny model (tests/test_model.py::TINY), drop-path 0
TINY = dict(num_classes=5, in_channels=6, channels=(8, 16), depths=(1, 1),
            num_heads=(2, 4), num_layers=2, n_pad=512, num_scenes=2,
            band=32, tile=32, sparse_cap=16, sampler="grid",
            drop_path_rate=0.0)
CASES = {
    "s3dis": {},
    "dcf": {"with_regressor": True},
    "swin3d": {"use_stratified": False, "rpe_mode": "swin_window"},
}
SCHEDULE_CFG = {"scheduler": "MultiStep", "scheduler_update": "epoch",
                "base_lr": 0.006, "epochs": 100}
BASE_LR = 0.006
OFFSET_WEIGHT = 0.7
# below the averaged gradients' global norm on every case (1.9-2.2), so
# that the clip acts (after the average, as optax's follows the JAX step's
# pmean)
MAX_GRAD_NORM = 1.0


# ---- spawning ranks ---------------------------------------------------------

def start_ranks(job, tmp_path):
    """Start WORLD worker processes on ``job``; returns their handles."""
    path = tmp_path / "job.pt"
    torch.save(job, path)
    port = mesh.free_port()
    procs = []
    for r in range(WORLD):
        with open(tmp_path / f"rank{r}.log", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(path), str(r), str(WORLD),
                 str(port), str(tmp_path)], stdout=out,
                stderr=subprocess.STDOUT, cwd=ROOT))
    return procs


def join_ranks(procs, tmp_path):
    """Wait for the ranks within JOIN_TIMEOUT_S (killing them past it);
    returns each rank's result."""
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pytest.fail(f"ranks still running after {JOIN_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        log = (tmp_path / f"rank{r}.log").read_text()
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def jax_mesh():
    assert len(jax.devices()) >= WORLD
    return make_mesh(WORLD)


# ---- 1. SyncBN -------------------------------------------------------------

def test_sync_batchnorm_matches_jax(tmp_path):
    """Two ranks with different inputs and valid rows: outputs, input and
    parameter gradients per rank (the backward all-reduces the statistics'
    cotangents) and the running buffers, against JAX's
    ``MaskedBatchNorm(axis_name)`` under ``shard_map``."""
    rng = np.random.default_rng(0)
    n, c = 96, 8
    x = np.stack([rng.normal(r, 1 + r, (n, c)) for r in range(WORLD)]
                 ).astype(np.float32)
    valid = np.stack([np.arange(n) < k for k in (70, 41)])
    cot = rng.normal(size=(WORLD, n, c)).astype(np.float32)
    job = {"kind": "bn", "x": x, "valid": valid, "cot": cot,
           "momentum": 0.1,
           "weight": rng.uniform(0.5, 1.5, c).astype(np.float32),
           "bias": rng.normal(0, 0.5, c).astype(np.float32),
           "mean": rng.normal(0, 0.5, c).astype(np.float32),
           "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    procs = start_ranks(job, tmp_path)

    bn = JaxBatchNorm(momentum=0.1, axis_name="data")
    params = {"scale": job["weight"], "bias": job["bias"]}
    stats = {"mean": job["mean"], "var": job["var"]}

    def local(x, valid, cot):
        x, valid, cot = x[0], valid[0], cot[0]

        def loss(x, params):
            y, upd = bn.apply({"params": params, "batch_stats": stats}, x,
                              valid, training=True, mutable=["batch_stats"])
            return jnp.sum(y * cot), (y, upd["batch_stats"])

        (_, (y, upd)), (dx, dp) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(x, params)
        return jax.tree.map(lambda a: a[None], (
            y, dx, dp["scale"], dp["bias"], upd["mean"], upd["var"]))

    want = jax.jit(jax.shard_map(
        local, mesh=jax_mesh(), in_specs=(P("data"),) * 3,
        out_specs=P("data"), check_vma=False))(x, valid, cot)
    got = join_ranks(procs, tmp_path)
    for r in range(WORLD):
        for key, w in zip(("y", "dx", "dweight", "dbias", "mean", "var"),
                          want):
            np.testing.assert_allclose(got[r][key], np.asarray(w[r]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} {key}")
    for key in ("mean", "var"):
        np.testing.assert_array_equal(got[0][key], got[1][key])
    # the statistics are global: the ranks' outputs differ from a
    # per-rank BatchNorm's
    assert not np.allclose(np.asarray(want[0][1]).mean(), 0.0)


# ---- 2, 4, 5. one DP step against JAX's ------------------------------------

def tiny_batch(cfg, seed, with_shift=False):
    """``tests/test_model.py::make_batch``'s rooms with the host tier's
    stem neighbours and pyramid."""
    ds = datasets.SyntheticRooms(
        num_scenes=cfg.num_scenes, points=220, extent=2.0,
        num_classes=cfg.num_classes, voxel_size=0.04,
        voxel_max=cfg.n_pad // cfg.num_scenes, with_shift=with_shift,
        seed=seed)
    scenes = [with_xyz_concat(ds[i]) for i in range(cfg.num_scenes)]
    return loader.finish_batch(
        collate_scenes(scenes, cfg.n_pad, cfg.num_scenes, ignore_label=255),
        cfg)


def jax_state(jmodel, hb, max_grad_norm):
    """Random O(1) variables and AdamW (x0.1 on blocks, the clip first),
    the averaged and clipped gradients recorded in ``opt_state[1]``."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, hb["feats"], hb["xyz"],
        hb["offsets"], training=False, stem_nidx=hb["stem_nidx"],
        stem_nmask=hb["stem_nmask"], pyramid=hb["pyramid"]))
    rng = np.random.default_rng(7)
    params = _random_variables(shapes["params"], rng)
    stats = _random_variables(shapes["batch_stats"], rng)
    schedule, _ = jax_sched.from_config(SCHEDULE_CFG, 2)
    tx = optax.chain(optax.clip_by_global_norm(max_grad_norm),
                     _record_grads(),
                     jax_make_optimizer(params, schedule, 0.01, 0.1))
    return TrainState(step=jnp.zeros((), jnp.int32), params=params,
                      batch_stats=stats, opt_state=tx.init(params), tx=tx,
                      apply_fn=jmodel.apply)


def adam_moments(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return from_flax(adam.mu), from_flax(adam.nu)


def unpack(packed, ncls):
    return {"loss": packed[0], "loss_seg": packed[1],
            "loss_offset": packed[2], "points": packed[3],
            "intersection": packed[4:4 + ncls],
            "union": packed[4 + ncls:4 + 2 * ncls],
            "target": packed[4 + 2 * ncls:]}


def step_job(case, batches, variables, steps=1, max_grad_norm=None):
    return {"kind": "step", "cfg": dict(TINY, **CASES[case],
                                        bn_axis_name="data"),
            "state": from_flax(*variables), "batches": batches,
            "schedule_cfg": SCHEDULE_CFG, "offset_weight": OFFSET_WEIGHT,
            "steps": steps, "max_grad_norm": max_grad_norm}


def zero_grad_biases(case):
    """Parameters whose gradient is 0 in exact arithmetic: a constant
    shift of a head's input is removed by its training-mode BatchNorm, so
    the biases of ``cls_fc1`` (and ``reg_fc1``) and of the last
    ``Upsample`` (``tests/test_torch_train.py::ZERO_GRAD``)."""
    names = {"cls_fc1.bias", "up_0.norm1.bias", "up_0.norm2.bias",
             "up_0.linear1.bias", "up_0.linear2.bias"}
    return names | ({"reg_fc1.bias"} if case == "dcf" else set())


def assert_params_close(got, want, want_grads, zero, label):
    """Parameters after the first AdamW step: each framework's ``zero``
    gradients are fp32 noise (below 1e-7 here), near AdamW's eps of 1e-8,
    so that the first step ``lr * g / (|g| + eps)`` moves those entries by
    noise in either: they are held within 2.02 lr, the others within RTOL /
    ATOL."""
    for name, w in want.items():
        if name in zero:
            assert float(want_grads[name].abs().max()) < 1e-7, name
            np.testing.assert_allclose(got[name], w.numpy(), rtol=0,
                                       atol=2.02 * BASE_LR,
                                       err_msg=f"{label} {name}")
        else:
            np.testing.assert_allclose(got[name], w.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{label} {name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_dp_step_matches_jax(case, tmp_path):
    """One DP step on distinct batches per rank (SyncBN on, the clip at
    MAX_GRAD_NORM, drop-path 0): each rank's averaged and clipped
    gradients, parameters, BatchNorm statistics and AdamW moments, and the
    psum'd statistics, against JAX's 2-device ``make_dp_train_step``."""
    dcf = case == "dcf"
    cfg = StratifiedConfig(**TINY, **CASES[case])
    hbs = []
    for r in range(WORLD):
        hb = tiny_batch(cfg, seed=r, with_shift=dcf)
        if dcf:
            hb["target_shift"] = np.random.default_rng(10 + r).normal(
                0, 0.5, (cfg.n_pad, 3)).astype(np.float32)
        hbs.append(hb)
    jcfg = JaxConfig(**TINY, **CASES[case], bn_axis_name="data",
                     attn_impl="reference", rpe_precision="highest",
                     qk_precision="highest")
    jmodel = JaxStratified(jcfg)
    state = jax_state(jmodel, hbs[0], MAX_GRAD_NORM)
    procs = start_ranks(step_job(case, hbs, (state.params,
                                             state.batch_stats),
                                 max_grad_norm=MAX_GRAD_NORM), tmp_path)

    mesh_ = jax_mesh()
    step = jax_make_dp_train_step(mesh_, 255, cfg.num_classes,
                                  offset_weight=OFFSET_WEIGHT)
    new, jstats = step(state, shard_batch(hbs, mesh_),
                       jax.random.PRNGKey(1))
    got = join_ranks(procs, tmp_path)

    want_grads = from_flax(new.opt_state[1])
    assert set(want_grads) == set(got[0]["grads"])
    # the recorded gradients are clipped to the limit
    np.testing.assert_allclose(np.sqrt(sum(
        float((g * g).sum()) for g in want_grads.values())), MAX_GRAD_NORM,
        rtol=1e-5)
    want_params = from_flax(new.params)
    want_stats = from_flax({}, new.batch_stats)
    mu, nu = adam_moments(new.opt_state)
    bns = {"stem_0.bn", "cls_bn"} | ({"reg_bn"} if dcf else set())
    assert {k.rsplit(".", 1)[0] for k in want_stats} == bns
    for r in range(WORLD):
        res = got[r]
        for name, w in want_grads.items():
            np.testing.assert_allclose(res["grads"][name], w.numpy(),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} grad {name}")
            m, v = res["moments"][name]
            np.testing.assert_allclose(m, mu[name].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"mu {name}")
            np.testing.assert_allclose(v, nu[name].numpy(), rtol=RTOL,
                                       atol=ATOL ** 2, err_msg=f"nu {name}")
        assert_params_close(res["state"], want_params, want_grads,
                            zero_grad_biases(case), f"rank {r}")
        for name, w in want_stats.items():
            np.testing.assert_allclose(res["state"][name], w.numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
        stats = unpack(res["packed"][0], cfg.num_classes)
        for key, w in jstats.items():
            np.testing.assert_allclose(stats[key], np.asarray(w, np.float32),
                                       rtol=RTOL, atol=ATOL, err_msg=key)
    # the ranks stay in step, bit for bit
    for key in ("state", "grads"):
        for name, t in got[0][key].items():
            np.testing.assert_array_equal(got[1][key][name], t, err_msg=name)
    # every rank's points are in the psum'd count
    assert int(got[0]["packed"][0][3]) == sum(int(hb["offsets"][-1])
                                              for hb in hbs)
    if dcf:
        assert float(jstats["loss_offset"]) > 0.05
        for name in ("reg_fc1.weight", "reg_fc2.weight", "reg_bn.weight"):
            assert float(np.abs(got[0]["grads"][name]).max()) > 1e-6, name


# ---- 3. identical batches against the one-device step ----------------------

def test_dp_step_on_identical_batches_equals_one_device_step(tmp_path):
    """Both ranks on the same batch: SyncBN's global statistics are the
    batch's, the averaged gradients the one-device step's, so two DP steps
    give the one-device steps' parameters, moments, BatchNorm means and
    losses (``tests/test_sharding.py::test_dp_grads_match_single_device_
    mean``). The running variances differ by design: their unbiased
    correction ``cnt / (cnt - 1)`` takes the global count, twice the
    batch's, as JAX's (``models/layers.py:76-78``)."""
    cfg = StratifiedConfig(**TINY)
    hb = tiny_batch(cfg, seed=0)
    jmodel = JaxStratified(JaxConfig(**TINY, attn_impl="reference"))
    state = jax_state(jmodel, hb, 1.0)
    variables = (state.params, state.batch_stats)
    procs = start_ranks(step_job("s3dis", [hb, hb], variables, steps=2),
                        tmp_path)
    model = build_model(cfg, "cpu", train=True)
    model.load_state_dict(from_flax(*variables))
    opt = make_optimizer(model, torch_sched.from_config(SCHEDULE_CFG, 2)[0])
    step = make_train_step(255, cfg.num_classes, OFFSET_WEIGHT)
    batch = loader.to_device(hb, "cpu")
    bns = {"stem_0.bn": model.stem_0.bn, "cls_bn": model.cls_bn}
    vars_ = [{k: bn.var.clone() for k, bn in bns.items()}]
    packed = []
    for _ in range(2):
        packed.append(pack_stats(step(model, opt, batch, None)).numpy())
        vars_.append({k: bn.var.clone() for k, bn in bns.items()})
    got = join_ranks(procs, tmp_path)
    n = float(hb["offsets"][-1])
    # the one-device unbiased batch variance u of each step, and the DP
    # buffer it gives with the global count 2n
    want_var = {}
    for key, bn in bns.items():
        m, v = bn.momentum, vars_[0][key]
        for t in (1, 2):
            u = (vars_[t][key] - (1 - m) * vars_[t - 1][key]) / m
            v = (1 - m) * v + m * u * ((n - 1) / n) * (2 * n / (2 * n - 1))
        want_var[f"{key}.var"] = v
    names = {id(p): name for name, p in model.named_parameters()}
    for r in range(WORLD):
        for name, t in model.state_dict().items():
            np.testing.assert_allclose(
                got[r]["state"][name], want_var.get(name, t).numpy(),
                rtol=RTOL, atol=ATOL, err_msg=name)
        for p, s in opt.state.items():
            for m, key in zip(got[r]["moments"][names[id(p)]],
                              ("exp_avg", "exp_avg_sq")):
                np.testing.assert_allclose(m, s[key].numpy(), rtol=RTOL,
                                           atol=ATOL, err_msg=key)
        for dp_p, one in zip(got[r]["packed"], packed):
            # psum'd over two copies of the batch
            np.testing.assert_allclose(dp_p, 2 * one, rtol=RTOL)
    assert not torch.allclose(want_var["cls_bn.var"], model.cls_bn.var,
                              rtol=1e-6, atol=0)


# ---- 6. per-rank loader batches ---------------------------------------------

LOADER_CASES = {
    "s3dis_aug_loop": dict(data_name="s3dis", aug=True, loop=4,
                           batch_size=4, max_batch_points=4096),
    "mix3d": dict(data_name="synthetic", aug=True, mix3d=0.5,
                  synthetic_scenes=12, synthetic_points=800, voxel_max=500,
                  batch_size=4, max_batch_points=4096),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_rank_batches_equal_jax_device_shares(case, tmp_path):
    """Rank r's init batch and batches over two epochs, each rank with
    its own datasets (its own visit counters, as its own process), equal
    bit for bit JAX's ``BatchLoader(n_devices=2)`` device r shares."""
    write_rooms(tmp_path)
    cfg = yaml_cfg(data_root=str(tmp_path), **LOADER_CASES[case])
    mcfg = jax_train.build_model_config(cfg, WORLD)
    jl = jax_train.BatchLoader(
        jax_train.build_dataset(cfg, "train", mcfg), mcfg, cfg, WORLD,
        shuffle=True, seed=123)
    want = [jl._make_batch(list(range(jl.scenes_per_batch)))]
    for _ in range(2):
        want += list(jl)
    pcfg = from_cfg(cfg, WORLD)
    mixed = 0
    for r in range(WORLD):
        bl = loader.BatchLoader(loader.build_dataset(cfg, "train"), pcfg,
                                cfg, shuffle=True, seed=123, rank=r,
                                world=WORLD)
        assert bl.batches_per_epoch == jl.batches_per_epoch >= 2
        got = [bl.init_batch()] + list(bl) + list(bl)
        assert_batches_equal(got, [per_dev[r] for per_dev in want])
        mixed += sum(len(np.unique(b["offsets"])) < pcfg.num_scenes
                     for b in got)
    if case == "mix3d":
        assert 0 < mixed < WORLD * len(want)


# ---- 7. the per-rank configuration ------------------------------------------

@pytest.mark.parametrize("n_devices", [1, 2, 3, 8])
@pytest.mark.parametrize("name,sync", [
    ("s3dis_stratified.yaml", None), ("scannetv2_stratified.yaml", None),
    ("s3dis_stratified.yaml", False)])
def test_per_rank_config_matches_jax_driver(name, sync, n_devices):
    """``from_cfg(cfg, D)`` equals ``build_model_config(cfg, D)`` on the
    per-device ``n_pad`` and ``num_scenes`` and the SyncBN axis (on only
    when D > 1 and ``sync_bn``, default True)."""
    cfg = load_cfg(os.path.join(CONFIGS, name))
    if sync is not None:
        cfg["sync_bn"] = sync
    ours, theirs = from_cfg(cfg, n_devices), jax_train.build_model_config(
        cfg, n_devices)
    for field in ("n_pad", "num_scenes", "bn_axis_name"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert (ours.bn_axis_name is not None) == (
        n_devices > 1 and sync is not False)
    if n_devices == 1:
        assert ours == from_cfg(cfg)


# ---- 8. the training driver on two ranks -----------------------------------

def test_driver_trains_on_two_ranks(tmp_path):
    """``train/driver.py::run`` with ``n_devices 2`` on the CPU: one epoch
    of two steps with validation on rank 0, the ranks bit-identical at the
    end (their state digests), one ``metrics.jsonl`` record, and rank 0's
    checkpoint restoring into a one-device model and optimizer bit for
    bit."""
    opts = []
    for key, value in LOOP_NARROW.items():
        opts += [key, str(value).replace(" ", "")]
    cfg = merge_cfg_from_list(load_cfg(os.path.join(CONFIGS,
                                                    "s3dis_stratified.yaml")),
                              opts + LOOP + [
        "synthetic_scenes", "8", "epochs", "1", "evaluate", "True",
        "n_devices", "2", "batch_size", "4", "max_batch_points", "4096",
        "save_path", str(tmp_path)])
    model, summary = driver.run(cfg, "cpu", log=lambda _: None,
                                timeout_s=60, join_timeout_s=JOIN_TIMEOUT_S)
    assert summary["steps"] == 2 and summary["step"] == 2
    assert summary["val_forwards"] > 0
    assert len(set(summary["state_sha256"])) == 1
    assert len(summary["state_sha256"]) == WORLD
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1 and "val_miou" in lines[0]
    assert all(np.isfinite(r["loss"]) for r in summary["iters"])
    one = build_model(from_cfg(cfg), "cpu", train=True)
    opt = driver.build_optimizer(one, cfg, 1)
    assert checkpoint.restore(str(tmp_path / "ckpt"), one, opt) == (2, 1,
                                                                     0.0)
    for name, t in model.state_dict().items():
        assert torch.equal(one.state_dict()[name], t), name
    assert all(g["t"] == 2 for g in opt.param_groups)
    assert all(int(s["step"]) == 2 for s in opt.state.values())


def test_one_device_checkpoint_resumes_on_two_ranks(tmp_path):
    """A one-device run's checkpoint resumes under data parallelism: every
    rank restores it, and epoch 2 continues the step count."""
    opts = []
    for key, value in LOOP_NARROW.items():
        opts += [key, str(value).replace(" ", "")]
    cfg = merge_cfg_from_list(load_cfg(os.path.join(CONFIGS,
                                                    "s3dis_stratified.yaml")),
                              opts + LOOP + [
        "synthetic_scenes", "8", "batch_size", "4", "max_batch_points",
        "4096", "save_path", str(tmp_path)])
    _, one = driver.run(dict(cfg, epochs=1, n_devices=1), "cpu",
                        log=lambda _: None)
    assert one["step"] == 2
    _, dp = driver.run(dict(cfg, n_devices=2, resume=str(tmp_path / "ckpt")),
                       "cpu", log=lambda _: None, timeout_s=60,
                       join_timeout_s=JOIN_TIMEOUT_S)
    assert [r["epoch"] for r in dp["records"]] == [2]
    assert dp["steps"] == 2 and dp["step"] == 4
    assert checkpoint.epochs(str(tmp_path / "ckpt")) == [1, 2]


# ---- the ranks' failures ----------------------------------------------------

def test_a_failing_rank_ends_the_run():
    """A rank that raises ends the other, which waits for it at a
    barrier, and the error reaches the caller well within the group's 60 s
    timeout."""
    import torch_dp_worker
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails"):
        mesh.spawn(torch_dp_worker.fail_on_rank_one, WORLD,
                   args=(mesh.free_port(),), timeout_s=JOIN_TIMEOUT_S)
    assert time.monotonic() - t0 < 45


def test_ranks_past_the_join_timeout_are_killed():
    import torch_dp_worker
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running after 2 s"):
        mesh.spawn(torch_dp_worker.wait_forever, WORLD, timeout_s=2)
    assert time.monotonic() - t0 < 30
    assert not multiprocessing.active_children()


# ---- 9. the multi-host rendezvous -------------------------------------------

_CHILD = r"""
import sys
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist

from stratified_transformer_torch.parallel.mesh import initialize_multihost

pid = int(sys.argv[1])
initialize_multihost({coord!r}, 2, pid, "cpu", timeout_s=60)
assert dist.get_world_size() == 2 and dist.get_rank() == pid
got = [torch.zeros(1) for _ in range(2)]
dist.all_gather(got, torch.tensor([pid + 1.0]))
assert [float(t) for t in got] == [1.0, 2.0], got
dist.destroy_process_group()
print(f"proc {{pid}} OK", flush=True)
"""


def test_two_process_rendezvous_and_collective(tmp_path):
    """Two processes rendezvous through ``parallel.mesh.
    initialize_multihost`` on a loopback port and all-gather one value
    each (``tests/test_multihost.py``); one process is a no-op."""
    assert mesh.initialize_multihost(None, 1, 0) is None
    assert not torch.distributed.is_initialized()
    child = _CHILD.format(repo=ROOT, coord=f"127.0.0.1:{mesh.free_port()}")
    procs = []
    for pid in range(2):
        with open(tmp_path / f"proc{pid}.log", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", child, str(pid)], stdout=out,
                stderr=subprocess.STDOUT, cwd=ROOT))
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, p in enumerate(procs):
        out = (tmp_path / f"proc{pid}.log").read_text()
        assert p.returncode == 0 and f"proc {pid} OK" in out, out
