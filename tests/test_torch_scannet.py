"""PyTorch port, the ScanNet family (``configs/scannetv2_stratified.yaml``:
``stem_transformer`` False, 5 levels, window 5 x grid 0.02, quant 0.005,
downsample 4, ignore label -100) at a narrow width against the JAX package:
the host pyramid, the eval forward with and without it, one train step and
its loss trajectory, the truncation audit, the ``Scannetv2`` reader and
loader batches over ``.pth`` scenes, and the eval driver's protocol on
them."""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stratified_transformer_tpu.data import datasets as jax_datasets
from stratified_transformer_tpu.data import pyramid as jax_pyramid_mod
from stratified_transformer_tpu.eval import voting as jax_voting
from stratified_transformer_tpu.models.stratified import (
    Stratified as JaxStratified, StratifiedConfig as JaxConfig)
from stratified_transformer_tpu.ops import attention as jax_attention
from stratified_transformer_tpu.ops import sampling as jax_sampling
from stratified_transformer_tpu.train import audit as jax_audit
from stratified_transformer_tpu.train import schedulers as jax_sched
from stratified_transformer_tpu.train.state import (
    TrainState, make_optimizer as jax_make_optimizer)
from stratified_transformer_tpu.train.step import (
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step)
import train as jax_train
from stratified_transformer_torch.config import StratifiedConfig, from_cfg
from stratified_transformer_torch import convert
from stratified_transformer_torch.convert import from_flax, from_flax_state
from stratified_transformer_torch.data import datasets, loader
from stratified_transformer_torch.data import pyramid as torch_pyramid
from stratified_transformer_torch.eval import driver, voting
from stratified_transformer_torch.models.stratified import (
    Stratified, geometry_pyramid)
from stratified_transformer_torch.train import audit
from stratified_transformer_torch.train import schedulers as torch_sched
from stratified_transformer_torch.train.state import make_optimizer
from stratified_transformer_torch.train.step import (
    make_eval_step, make_train_step)
from stratified_transformer_torch.utils.config import (
    load_cfg, merge_cfg_from_list)
from test_torch_host import assert_same_neighbours
from test_torch_loop import assert_batches_equal
from test_torch_model import _random_variables
from test_torch_train import GRAD_FLOOR, GRAD_REL_L2, _record_grads, _rel_l2
from test_torch_whole_scene import PROB_ATOL, jax_pyramid, literal_bins

torch.set_num_threads(1)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
IGNORE, CLASSES = -100, 20
# The ScanNet YAML's geometry and caps at a narrow width: five levels, the
# stem's level a skip level, transformer stages 1-4 (stage 0's depth unused)
NARROW = dict(num_classes=CLASSES, in_channels=6,
              channels=(16, 16, 32, 64, 64), num_heads=(1, 1, 2, 4, 4),
              depths=(1, 1, 1, 2, 1), num_layers=5, window_size=5.0,
              grid_size=0.02, quant_size=0.005, downsample_scale=4,
              stem_transformer=False, n_pad=2048, num_scenes=2, tile=128,
              band=128, band_per_stage=(256, 256, 256, 384, 256),
              sparse_cap=64, s_band=128, drop_path_rate=0.0)
# synthetic rooms voxelized at ScanNet's 0.02 m, small enough that the
# 0.2 m windows of stage 1 hold a few dozen points
ROOMS = dict(voxel_size=0.02, extent=1.0, ignore_label=IGNORE)
# one forward through five attention blocks, two KPConv blocks, a U-Net
# and four BatchNorms: fp32 sums in another order, as test_torch_model's
# comparison (observed <= 1e-5 relative there)
RTOL, ATOL = 1e-3, 1e-4
# the train step: as test_torch_train (grads in relative L2, params after
# one AdamW step, BN statistics, the loss trajectory)
PARAM_REL_L2, STATS_RTOL, STATS_ATOL, LOSS_RTOL = 1e-4, 1e-4, 1e-6, 1e-4
STEPS = 3
# the YAML's schedule, its 3000 warm-up iterations cut to 2 so that the
# three steps move the weights
SCHEDULE_CFG = {"scheduler": "MultiStepWithWarmup", "scheduler_update": "step",
                "warmup": "linear", "warmup_iters": 2,
                "warmup_ratio": 1e-6, "base_lr": 0.006, "epochs": 100}
WEIGHT_DECAY = 0.05


def _host_batch(seed=0):
    """A host batch with the ignore label on the pad rows and on every 7th
    valid point, as ScanNet marks its unlabelled points."""
    hb = loader.host_batch(StratifiedConfig(**NARROW), seed=seed, **ROOMS)
    n_valid = int(hb["offsets"][-1])
    labels = hb["labels"].copy()
    labels[:n_valid:7] = IGNORE
    hb["labels"] = labels
    return hb


def _jax_config(**kw):
    return JaxConfig(**dict(NARROW, **kw), sampler="grid",
                     attn_impl="reference", rpe_precision="highest",
                     qk_precision="highest")


@pytest.fixture(scope="module")
def setup():
    """The narrow model in both packages with the same random weights, on
    one host batch."""
    hb = _host_batch()
    jmodel = JaxStratified(_jax_config())
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, hb["feats"], hb["xyz"],
        hb["offsets"], training=False, stem_nidx=hb["stem_nidx"],
        stem_nmask=hb["stem_nmask"], pyramid=hb["pyramid"]))
    rng = np.random.default_rng(11)
    variables = {"params": _random_variables(shapes["params"], rng),
                 "batch_stats": _random_variables(shapes["batch_stats"], rng)}
    return hb, jmodel, variables


def _torch_model(variables, cfg=None):
    model = Stratified(cfg or StratifiedConfig(**NARROW))
    model.load_state_dict(from_flax(variables["params"],
                                    variables["batch_stats"]), strict=True)
    return model.eval()


# ---- configuration and host pyramid -------------------------------------

def test_scannet_config_matches_jax_driver():
    path = os.path.join(CONFIGS, "scannetv2_stratified.yaml")
    ours = from_cfg(load_cfg(path))
    theirs = jax_train.build_model_config(load_cfg(path), 1)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.stem_transformer is False and ours.layer_start == 1
    assert ours.n_pad == 250112 and ours.num_scenes == 2
    assert ours.channels == (48, 96, 192, 384, 384)
    assert [ours.stage_band(i) for i in range(1, 5)] == [256, 256, 384, 256]
    assert ours.stage_caps() == theirs.stage_caps()
    for name in ("window_sizes", "grid_sizes", "quant_sizes"):
        assert getattr(ours, name)() == getattr(theirs, name)(), name
    # 80 table rows per axis at every stage: window 5 x grid, quant
    nbins = [2 * int((2 * w + 1e-4) // q)
             for w, q in zip(ours.window_sizes(), ours.quant_sizes())]
    assert nbins == [80] * 5


def test_scannet_host_pyramid_equals_jax():
    port = loader.example_batch(NARROW["n_pad"], NARROW["num_scenes"], seed=1,
                                **ROOMS)
    pyr_t = torch_pyramid.build_geometry_pyramid(
        port.xyz, port.offsets, StratifiedConfig(**NARROW))
    pyr_j = jax_pyramid_mod.build_geometry_pyramid(
        port.xyz, port.offsets, _jax_config())
    assert len(pyr_t["down"]) == len(pyr_j["down"]) == 4
    assert len(pyr_t["up"]) == len(pyr_j["up"]) == 4
    assert len(pyr_t["stage_down"]) == len(pyr_j["stage_down"]) == 4
    levels = [port.xyz]
    for a, b in zip(pyr_t["down"], pyr_j["down"]):
        for key in ("idx", "valid", "offsets", "knn_mask"):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        new = levels[-1][a["idx"]]
        assert_same_neighbours(new, levels[-1], a["knn_idx"], b["knn_idx"])
        levels.append(new)
    for j, (a, b) in enumerate(zip(pyr_t["up"], pyr_j["up"])):
        np.testing.assert_array_equal(a["mask"], b["mask"])
        assert_same_neighbours(levels[-2 - j], levels[-1 - j],
                               np.where(a["mask"], a["idx"], -1),
                               np.where(b["mask"], b["idx"], -1))
    # member masks from level 1: the skip level has none
    for r, (a, b) in enumerate(zip(pyr_t["stage_down"], pyr_j["stage_down"])):
        assert a["is_down"].shape == (len(levels[r + 1]),)
        np.testing.assert_array_equal(a["is_down"], b["is_down"])
        assert a["is_down"].any()


def test_scannet_state_dict_names_mirror_flax(setup):
    _, _, variables = setup
    names = set(_torch_model(variables).state_dict())
    assert {"stem_1.unary1.weight", "stem_1.bn1.mean", "stem_1.unary2.weight",
            "stem_1.bn2.var", "stem_1.kpconv.kernel_weights",
            "stem_down.linear.weight", "layer_1.blocks_0.attn.qkv.weight",
            "layer_4.blocks_0.attn.rel_value_table", "down_3.norm.weight",
            "up_3.linear1.bias"} <= names
    assert not any(n.startswith(("layer_0.", "down_0.", "stem_1.shortcut"))
                   for n in names)


# ---- the forward ---------------------------------------------------------

@pytest.fixture(scope="module")
def eval_runs(setup):
    hb, jmodel, variables = setup
    eval_step = jax_make_eval_step(IGNORE, CLASSES)

    @jax.jit
    def run_jax(batch):
        state = types.SimpleNamespace(params=variables["params"],
                                      batch_stats=variables["batch_stats"],
                                      apply_fn=jmodel.apply)
        return eval_step(state, batch)

    j_logits, _, j_stats = run_jax(hb)
    t_logits, _, t_stats = make_eval_step(IGNORE, CLASSES)(
        _torch_model(variables), loader.to_device(hb, "cpu"))
    return np.asarray(j_logits), j_stats, t_logits, t_stats


def test_scannet_eval_forward_matches_jax(setup, eval_runs):
    hb = setup[0]
    j_logits, _, t_logits, _ = eval_runs
    n_valid = int(hb["offsets"][-1])
    assert t_logits.shape == (NARROW["n_pad"], CLASSES)
    np.testing.assert_allclose(t_logits.numpy()[:n_valid], j_logits[:n_valid],
                               rtol=RTOL, atol=ATOL)


def test_scannet_eval_counters_match_jax(setup, eval_runs):
    hb = setup[0]
    _, j_stats, _, t_stats = eval_runs
    np.testing.assert_allclose(float(t_stats["loss"]), float(j_stats["loss"]),
                               rtol=1e-5)
    for key in ("intersection", "union", "target", "points"):
        np.testing.assert_array_equal(t_stats[key].numpy(),
                                      np.asarray(j_stats[key]), err_msg=key)
    # the ignored points count nowhere
    labels = hb["labels"][:int(hb["offsets"][-1])]
    assert int(t_stats["target"].sum()) == int((labels != IGNORE).sum())


def scannet_members_lost(cfg, pyramid, xyz, offsets):
    """Stage members that the JAX package's scatter (``models/stratified.
    py:218``) unmarks on the levels of ``pyramid`` (the port's), where the
    host rule keeps them: stages ``layer_start`` on, at their levels."""
    levels = [(xyz, offsets)]
    for lvl in pyramid["down"]:
        levels.append((levels[-1][0][lvl["idx"].numpy()],
                       lvl["offsets"].numpy()))
    lost = 0
    for r, i in enumerate(range(cfg.layer_start, cfg.num_layers)):
        x, off = levels[i]
        n = len(x)
        off = jnp.asarray(off, jnp.int32)
        counts = off - jnp.concatenate([jnp.zeros((1,), jnp.int32), off[:-1]])
        d_off = jax_sampling.counts_to_offsets(jax_sampling.floor_ratio_counts(
            counts, 1.0 / cfg.downsample_scale))
        d_idx, d_valid = jax_sampling.grid_pool_sampling(
            jnp.asarray(x), off, d_off, n // cfg.downsample_scale
            + cfg.num_scenes,
            cfg.grid_sizes()[i] * float(cfg.downsample_scale) ** 0.5)
        jax_down = np.asarray(jnp.zeros((n,), bool).at[d_idx].set(
            d_valid, mode="drop"))
        lost += int((pyramid["stage_down"][r]["is_down"].numpy()
                     & ~jax_down).sum())
    return lost


def test_scannet_forward_without_pyramid_matches_jax(setup):
    """The model samples and searches neighbours itself (whole-scene
    evaluation's path), stem_down's level included."""
    hb, jmodel, variables = setup
    cfg = StratifiedConfig(**NARROW)
    xyz, off = torch.from_numpy(hb["xyz"]), torch.from_numpy(hb["offsets"])
    pyr = geometry_pyramid(cfg, xyz, off.long())
    assert len(pyr["down"]) == 4 and len(pyr["stage_down"]) == 4
    # the precondition: on this batch JAX's member scatter unmarks no member
    assert scannet_members_lost(cfg, pyr, hb["xyz"], hb["offsets"]) == 0
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_attention, "relative_position_index", literal_bins)
        want = np.asarray(jax.jit(lambda f, x, o: jmodel.apply(
            variables, f, x, o, training=False)[0])(
                hb["feats"], hb["xyz"], hb["offsets"]))
    with torch.no_grad():
        got = _torch_model(variables)(torch.from_numpy(hb["feats"]), xyz,
                                      off.long())[0]
    n_valid = int(hb["offsets"][-1])
    np.testing.assert_allclose(got.numpy()[:n_valid], want[:n_valid],
                               rtol=RTOL, atol=ATOL)


# ---- one train step --------------------------------------------------------

@pytest.fixture(scope="module")
def train_runs(setup):
    hb, jmodel, variables = setup
    params, stats = variables["params"], variables["batch_stats"]
    schedule, _ = jax_sched.from_config(SCHEDULE_CFG, 2)
    tx = optax.chain(_record_grads(),
                     jax_make_optimizer(params, schedule, WEIGHT_DECAY, 0.1))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params), tx=tx,
                       apply_fn=jmodel.apply)
    jstep = jax.jit(jax_make_train_step(IGNORE, CLASSES))
    j_states, j_losses = [], []
    # the literal bin formula, as in the forward without a pyramid: XLA's
    # FMA rewrite of it flips a boundary bin of this batch's 5 mm quanta
    # and moves layer_1's rel_key_table grad by 1.2e-4 relative L2
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_attention, "relative_position_index", literal_bins)
        for _ in range(STEPS):
            state, st = jstep(state, hb, jax.random.PRNGKey(0))
            j_states.append(state)
            j_losses.append(float(st["loss"]))

    model = _torch_model(variables).train()
    opt = make_optimizer(model, torch_sched.from_config(SCHEDULE_CFG, 2)[0],
                         weight_decay=WEIGHT_DECAY)
    tstep = make_train_step(IGNORE, CLASSES)
    batch = loader.to_device(hb, "cpu")
    t_losses, first = [], None
    for i in range(STEPS):
        st = tstep(model, opt, batch, None)
        t_losses.append(float(st["loss"]))
        if i == 0:
            first = ({n: p.grad.clone() for n, p in model.named_parameters()},
                     {k: v.clone() for k, v in model.state_dict().items()})
    return j_states, j_losses, first, t_losses


def test_scannet_train_step_grads_match_jax(train_runs):
    j_states, _, (grads, _), _ = train_runs
    want = from_flax(j_states[0].opt_state[0])
    assert set(want) == set(grads)
    for name, g in grads.items():
        err = np.linalg.norm(g.numpy() - want[name].numpy())
        bound = (GRAD_REL_L2 * np.linalg.norm(want[name].numpy())
                 + GRAD_FLOOR * np.sqrt(g.numel()))
        assert err <= bound, (name, err, bound)
    for name in ("stem_1.unary1.weight", "stem_1.kpconv.kernel_weights",
                 "stem_down.linear.weight",
                 "layer_1.blocks_0.attn.rel_key_table",
                 "layer_4.blocks_0.attn.rel_query_table"):
        assert float(grads[name].abs().max()) > 1e-6, name


def test_scannet_train_step_params_and_stats_match_jax(train_runs):
    j_states, _, (grads, state), _ = train_runs
    want = from_flax(j_states[0].params)
    for name, w in want.items():
        if float(grads[name].abs().max()) < 1e-6:
            # a grad that is 0 in exact arithmetic (a shift the training
            # BatchNorm removes): the first Adam step is about lr * sign of
            # fp32 noise, in either framework
            np.testing.assert_allclose(state[name].numpy(), w.numpy(),
                                       rtol=0, atol=2.02 * 0.006,
                                       err_msg=name)
        else:
            assert _rel_l2(state[name].numpy(), w.numpy()) < PARAM_REL_L2, \
                name
    want = from_flax({}, j_states[0].batch_stats)
    assert {"stem_1.bn1.mean", "stem_1.bn2.var"} <= set(want)
    for name, w in want.items():
        np.testing.assert_allclose(state[name].numpy(), w.numpy(),
                                   rtol=STATS_RTOL, atol=STATS_ATOL,
                                   err_msg=name)


def test_scannet_loss_trajectory_matches_jax(train_runs):
    _, j_losses, _, t_losses = train_runs
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    assert t_losses[-1] < t_losses[0]


def test_scannet_adamw_state_converts_by_name(setup, train_runs):
    """`from_flax_state` carries the JAX state after step 1 across (the
    ``stem_1``/``stem_down`` moments matched by name); the port's step 2
    from it gives JAX's step-2 loss and parameters."""
    from tools import orbax_to_torch
    hb, _, variables = setup
    j_states, j_losses, (grads, _), _ = train_runs
    st = j_states[0]
    model = _torch_model(variables).train()
    opt = make_optimizer(model, torch_sched.from_config(SCHEDULE_CFG, 2)[0],
                         weight_decay=WEIGHT_DECAY)
    payload = from_flax_state(
        orbax_to_torch.plain_tree(st.params),
        orbax_to_torch.plain_tree(st.batch_stats),
        orbax_to_torch.plain_tree(st.opt_state[1]), 1, 0, model=model,
        optimizer=opt)
    model.load_state_dict(payload["model"], strict=True)
    opt.load_state_dict(payload["optimizer"])
    adam, = convert._adam_states(orbax_to_torch.plain_tree(st.opt_state[1]))
    mu = from_flax(adam["mu"])
    for name, p in model.named_parameters():
        assert torch.equal(opt.state[p]["exp_avg"], mu[name]), name
    loss = float(make_train_step(IGNORE, CLASSES)(
        model, opt, loader.to_device(hb, "cpu"), None)["loss"])
    np.testing.assert_allclose(loss, j_losses[1], rtol=LOSS_RTOL)
    want = from_flax(j_states[1].params)
    for name, p in model.named_parameters():
        if float(grads[name].abs().max()) >= 1e-6:
            assert _rel_l2(p.detach().numpy(), want[name].numpy()) < \
                PARAM_REL_L2, name


# ---- the truncation audit ------------------------------------------------

def test_scannet_audit_counters_equal_jax():
    """Caps small enough that the counters of stages 1-4 are non-zero."""
    kw = dict(band=0, band_per_stage=None, s_band=4, sparse_cap=2, tile=32)
    pcfg = StratifiedConfig(**dict(NARROW, **kw))
    hb = loader.host_batch(pcfg, seed=3, **ROOMS)
    want = np.asarray(jax_audit.audit_truncation_packed(
        _jax_config(**kw), {k: hb[k] for k in ("xyz", "offsets", "pyramid")}))
    got = audit.audit_truncation_packed(pcfg, loader.to_device(hb, "cpu"))
    assert got.shape == (4, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[:, 1] > 0).all()
    stats = audit.unpack_truncation(pcfg, got.numpy())
    assert sorted(stats) == ["stage_1", "stage_2", "stage_3", "stage_4"]
    assert stats == jax_audit.unpack_truncation(_jax_config(**kw), want)


# ---- the reader, the loader and the eval driver --------------------------

def _write_scannet(root, seed=0, n=700):
    """``.pth`` scenes as ScanNet ships them: (coords float32, colours in
    [-1, 1] float32, labels with -100 for unlabelled points)."""
    rng = np.random.default_rng(seed)
    names = {"train": ["scene0000_00", "scene0001_00", "scene0002_01"],
             "val": ["scene0011_00", "scene0015_00"]}
    for split, items in names.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for name in items:
            xyz = rng.uniform(0, 1.5, (n, 3)).astype(np.float32)
            rgb = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
            label = rng.integers(0, CLASSES, n).astype(np.float64)
            label[rng.random(n) < 0.15] = IGNORE
            torch.save((xyz, rgb, label),
                       os.path.join(root, split, name + ".pth"))
    return names


def test_scannet_reader_matches_jax(tmp_path):
    _write_scannet(tmp_path)
    for split, count in (("train", 3), ("val", 2), ("trainval", 5)):
        kw = dict(split=split, data_root=str(tmp_path), voxel_size=0.02,
                  voxel_max=400, shuffle_index=True, loop=2, seed=7)
        ours, theirs = datasets.Scannetv2(**kw), jax_datasets.Scannetv2(**kw)
        assert ours.files == theirs.files
        assert len(ours) == len(theirs) == 2 * count
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            for key in ("xyz", "feats", "labels"):
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    item = datasets.Scannetv2("val", str(tmp_path), voxel_max=400)[0]
    assert item["feats"].min() >= -1.0 and (item["labels"] == IGNORE).any()
    scenes = datasets.scannet_scenes(str(tmp_path))
    assert [s[0] for s in scenes] == ["scene0011_00", "scene0015_00"]
    assert scenes[0][3].dtype == np.int64 and (scenes[0][3] == IGNORE).any()


def test_scannet_loader_batches_match_jax(tmp_path):
    """`build_dataset` and the prefetch loader over ``.pth`` scenes against
    the JAX driver's, batch for batch and bit for bit (the pyramid and the
    stem neighbours included), with the YAML's ignore label."""
    _write_scannet(tmp_path)
    yaml_cfg = merge_cfg_from_list(
        load_cfg(os.path.join(CONFIGS, "scannetv2_stratified.yaml")),
        ["data_root", str(tmp_path), "max_batch_points", "1024",
         "voxel_max", "400", "loop", "2", "batch_size", "2",
         "compress_payload", "False"])
    pcfg, mcfg = from_cfg(yaml_cfg), jax_train.build_model_config(yaml_cfg, 1)
    for split, shuffle in (("train", True), ("val", False)):
        got = list(loader.BatchLoader(loader.build_dataset(yaml_cfg, split),
                                      pcfg, yaml_cfg, shuffle=shuffle,
                                      seed=5))
        want = [b[0] for b in jax_train.BatchLoader(
            jax_train.build_dataset(yaml_cfg, split, mcfg), mcfg, yaml_cfg,
            1, shuffle=shuffle, seed=5)]
        assert len(got) == (3 if split == "train" else 1)
        assert_batches_equal(got, want)
        assert all((b["labels"] == IGNORE).any() for b in got)
        assert all(len(b["pyramid"]["stage_down"]) == 4 for b in got)


def test_scannet_eval_driver_matches_jax_protocol(tmp_path, setup):
    """``eval.driver`` on ``.pth`` scenes: five TTA passes (no shifts), the
    colours passed as they are, and the JAX package's `evaluate_scene`
    probabilities from the same weights, its forward fed its own on-device
    pyramid with the host member rule (`jax_pyramid`: the JAX model's
    member scatter drops members, ROADMAP section 3)."""
    _, _, variables = setup
    _write_scannet(tmp_path, seed=3, n=500)
    yaml_cfg = merge_cfg_from_list(
        load_cfg(os.path.join(CONFIGS, "scannetv2_stratified.yaml")),
        ["data_root", str(tmp_path), "voxel_max", "300", "batch_size_test",
         "2", "channels", "[16,16,32,64,64]", "num_heads", "[1,1,2,4,4]",
         "depths", "[1,1,1,2,1]", "band_per_stage", "[256,256,256,384,256]",
         "rpe_precision", "highest", "qk_precision", "highest"])
    cfg = driver.eval_config(yaml_cfg)
    model = _torch_model(variables, cfg)
    assert len(voting.tta_transforms("scannetv2")) == 5
    calls, seen = [], []
    predict = driver.make_predict_probs(model)

    def counted(feats, xyz, offsets):
        calls.append(int(offsets[-1]))
        seen.append(feats[:int(offsets[-1]), :3].copy())
        return predict(feats, xyz, offsets)

    coord, feat, label = datasets.scannet_scenes(str(tmp_path))[0][1:]
    kw = dict(data_name="scannetv2", voxel_size=0.02, voxel_max=300,
              batch_size_test=2, n_pad=cfg.n_pad, num_scenes=2)
    pred, probs = voting.evaluate_scene(counted, coord, feat, CLASSES, **kw)
    # colours in [-1, 1] reach the model as they are
    assert min(float(s.min()) for s in seen) < -0.5
    jcfg = _jax_config(n_pad=cfg.n_pad)
    jmodel = JaxStratified(jcfg)

    @jax.jit
    def jax_probs(feats, xyz, offsets):
        nidx, nmask, pyr = jax_pyramid(jcfg, xyz, offsets)
        return jax.nn.softmax(jmodel.apply(
            variables, feats, xyz, offsets, training=False, stem_nidx=nidx,
            stem_nmask=nmask, pyramid=pyr)[0], -1)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_attention, "relative_position_index", literal_bins)
        want_pred, want_probs = jax_voting.evaluate_scene(
            lambda f, x, o: np.asarray(jax_probs(f, x, o)), coord, feat,
            CLASSES, **kw)
    assert len(calls) >= 5
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=PROB_ATOL)
    top2 = np.sort(want_probs, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    np.testing.assert_array_equal(pred[clear], want_pred[clear])
    # the driver: the same scenes, the ignore label kept out of the counts
    lines = []
    m = driver.run(yaml_cfg, "cpu", log=lines.append)
    assert [s["name"] for s in m["scenes"]] == ["scene0011_00",
                                                "scene0015_00"]
    assert lines[-1].startswith("Val result: mIoU/mAcc/allAcc ")
    assert (label == IGNORE).any()
