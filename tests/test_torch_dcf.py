"""PyTorch port, the DCF family (``configs/dcf_stratified.yaml``: the S3DIS
backbone with the per-point offset head, L1 offset loss, cube-scene reader)
at a narrow width against the JAX package: the configuration, the head's
logits and offsets with and without a host pyramid under both activations,
``l1_offset``, one train step with the offset loss and the AdamW state
carried across, the ``DCF`` reader, synthetic rooms with offset targets,
collate, Mix3D and loader batches, and one epoch of the training driver
from JAX's converted initial state."""

import dataclasses
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
import train as jax_train
from stratified_transformer_tpu.data import collate as jax_collate
from stratified_transformer_tpu.data import datasets as jax_datasets
from stratified_transformer_tpu.models.stratified import (
    Stratified as JaxStratified, StratifiedConfig as JaxConfig)
from stratified_transformer_tpu.ops import attention as jax_attention
from stratified_transformer_tpu.train import losses as jax_losses
from stratified_transformer_tpu.train import schedulers as jax_sched
from stratified_transformer_tpu.train.state import (
    TrainState, create_train_state, make_optimizer as jax_make_optimizer)
from stratified_transformer_tpu.train.step import (
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step)
from stratified_transformer_torch import convert
from stratified_transformer_torch.config import StratifiedConfig, from_cfg
from stratified_transformer_torch.convert import from_flax, from_flax_state
from stratified_transformer_torch.data import collate, datasets, loader
from stratified_transformer_torch.models.stratified import (
    Stratified, geometry_pyramid)
from stratified_transformer_torch.train import checkpoint, driver, losses
from stratified_transformer_torch.train import schedulers as torch_sched
from stratified_transformer_torch.train.state import make_optimizer
from stratified_transformer_torch.train.step import (
    make_eval_step, make_train_step)
from stratified_transformer_torch.utils.config import (
    load_cfg, merge_cfg_from_list)
from test_torch_loop import assert_batches_equal
from test_torch_model import _random_variables
from test_torch_train import GRAD_FLOOR, GRAD_REL_L2, _record_grads, _rel_l2
from test_torch_whole_scene import jax_members_lost, literal_bins
from tools import orbax_to_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "dcf_stratified.yaml")
CLASSES = 18
NARROW = dict(num_classes=CLASSES, in_channels=6, channels=(16, 32, 64, 128),
              num_heads=(1, 2, 4, 8), depths=(1, 1, 2, 1), num_layers=4,
              n_pad=2048, num_scenes=2, tile=128, band=128,
              band_per_stage=(128, 128, 384, 192), sparse_cap=48, s_band=128,
              drop_path_rate=0.0, with_regressor=True)
# logits and offsets after five attention blocks, a U-Net and a BatchNorm
# per head: fp32 sums in another order, as test_torch_model's comparison
# (observed <= 1e-5 relative there)
RTOL, ATOL = 1e-3, 1e-4
# the train step, as test_torch_train: losses and parameters after one
# AdamW step within 1e-4
LOSS_RTOL, PARAM_REL_L2, BASE_LR = 1e-4, 1e-4, 0.006
SCHEDULE_CFG = {"scheduler": "MultiStep", "scheduler_update": "epoch",
                "base_lr": BASE_LR, "epochs": 100}
# fabricated cube scenes (the fork's cube files are not in the repository)
CUBES = dict(cubes=3, points_per_cube=500, extent=2.0)


def _jax_config(**kw):
    return JaxConfig(**dict(NARROW, **kw), sampler="grid",
                     attn_impl="reference", rpe_precision="highest",
                     qk_precision="highest")


def _host_batch(seed=0):
    """A narrow host batch with offset targets on its valid rows (zero on
    the pad rows, as collate writes them)."""
    hb = loader.host_batch(StratifiedConfig(**NARROW), seed=seed)
    n_valid = int(hb["offsets"][-1])
    shift = np.zeros((NARROW["n_pad"], 3), np.float32)
    shift[:n_valid] = np.random.default_rng(seed).normal(
        0, 0.1, (n_valid, 3)).astype(np.float32)
    hb["target_shift"] = shift
    return hb


def _variables(hb, activation):
    jmodel = JaxStratified(_jax_config(activation=activation))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, hb["feats"], hb["xyz"],
        hb["offsets"], training=False, stem_nidx=hb["stem_nidx"],
        stem_nmask=hb["stem_nmask"], pyramid=hb["pyramid"]))
    rng = np.random.default_rng(11)
    return jmodel, {
        "params": _random_variables(shapes["params"], rng),
        "batch_stats": _random_variables(shapes["batch_stats"], rng)}


def _torch_model(variables, activation="Relu"):
    model = Stratified(StratifiedConfig(**NARROW, activation=activation))
    model.load_state_dict(from_flax(variables["params"],
                                    variables["batch_stats"]), strict=True)
    return model.eval()


# ---- configuration -------------------------------------------------------

def test_dcf_config_matches_jax_driver():
    ours = from_cfg(load_cfg(CONFIG))
    theirs = jax_train.build_model_config(load_cfg(CONFIG), 1)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.with_regressor and ours.activation == "Relu"
    assert ours.num_classes == 18 and ours.n_pad == 140032
    assert ours.channels == (48, 96, 192, 384)
    # the S3DIS backbone's tables: 64 bins per axis at every stage
    assert [2 * int((2 * w + 1e-4) // q) for w, q in zip(
        ours.window_sizes(), ours.quant_sizes())] == [64] * 4


def test_head_names_mirror_flax():
    hb = _host_batch()
    _, variables = _variables(hb, "Relu")
    names = set(_torch_model(variables).state_dict())
    assert {"reg_fc1.weight", "reg_fc1.bias", "reg_bn.weight", "reg_bn.mean",
            "reg_bn.var", "reg_fc2.weight", "reg_fc2.bias"} <= names
    assert "reg_fc1" not in "".join(Stratified(StratifiedConfig(**dict(
        NARROW, with_regressor=False))).state_dict())


# ---- the forward -----------------------------------------------------------

@pytest.fixture(scope="module", params=["Relu", "Tanh"])
def head(request):
    hb = _host_batch()
    jmodel, variables = _variables(hb, request.param)
    return request.param, hb, jmodel, variables


def test_head_with_host_pyramid_matches_jax(head):
    activation, hb, jmodel, variables = head
    eval_step = jax_make_eval_step(255, CLASSES)

    @jax.jit
    def run_jax(batch):
        state = types.SimpleNamespace(params=variables["params"],
                                      batch_stats=variables["batch_stats"],
                                      apply_fn=jmodel.apply)
        return eval_step(state, batch)[:2]

    j_logits, j_shift = run_jax({k: v for k, v in hb.items()
                                 if k != "target_shift"})
    t_logits, t_shift, _ = make_eval_step(255, CLASSES)(
        _torch_model(variables, activation), loader.to_device(hb, "cpu"))
    n_valid = int(hb["offsets"][-1])
    assert t_shift.shape == (NARROW["n_pad"], 3)
    np.testing.assert_allclose(t_logits.numpy()[:n_valid],
                               np.asarray(j_logits)[:n_valid], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(t_shift.numpy()[:n_valid],
                               np.asarray(j_shift)[:n_valid], rtol=RTOL,
                               atol=ATOL)
    if activation == "Tanh":
        # tanh in place of relu: negative pre-activations reach reg_fc2
        assert float(t_shift.abs().max()) > 0.1


def test_head_without_pyramid_matches_jax(head):
    """The model samples and searches neighbours itself, as `iou_driver`
    runs it."""
    activation, hb, jmodel, variables = head
    cfg = StratifiedConfig(**NARROW)
    xyz, off = torch.from_numpy(hb["xyz"]), torch.from_numpy(hb["offsets"])
    assert jax_members_lost(cfg, geometry_pyramid(cfg, xyz, off.long()),
                            hb["xyz"], hb["offsets"]) == 0
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_attention, "relative_position_index", literal_bins)
        want = jax.jit(lambda f, x, o: jmodel.apply(
            variables, f, x, o, training=False))(
                hb["feats"], hb["xyz"], hb["offsets"])
    with torch.no_grad():
        got = _torch_model(variables, activation)(
            torch.from_numpy(hb["feats"]), xyz, off.long())
    n_valid = int(hb["offsets"][-1])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[:n_valid],
                                   np.asarray(w)[:n_valid], rtol=RTOL,
                                   atol=ATOL)


def test_unknown_activation_is_refused():
    with pytest.raises(ValueError, match="activation"):
        StratifiedConfig(**NARROW, activation="Gelu")


# ---- the offset loss and the train step ----------------------------------

@pytest.mark.parametrize("valid_rows", [0, 1, 37, 64])
def test_l1_offset_matches_jax(valid_rows):
    rng = np.random.default_rng(valid_rows)
    pred = rng.normal(size=(64, 3)).astype(np.float32)
    target = rng.normal(size=(64, 3)).astype(np.float32)
    valid = np.arange(64) < valid_rows
    got = losses.l1_offset(torch.from_numpy(pred), torch.from_numpy(target),
                           torch.from_numpy(valid))
    want = jax_losses.l1_offset(pred, target, valid)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-6)
    if valid_rows == 0:
        assert float(got) == 0.0


@pytest.fixture(scope="module")
def train_runs():
    """Two steps of each package from the same weights on a batch with
    offset targets, ``offset_weight`` 1.0 (Relu head)."""
    hb = _host_batch(seed=2)
    jmodel, variables = _variables(hb, "Relu")
    params, stats = variables["params"], variables["batch_stats"]
    schedule, _ = jax_sched.from_config(SCHEDULE_CFG, 2)
    tx = optax.chain(_record_grads(),
                     jax_make_optimizer(params, schedule, 0.01, 0.1))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params), tx=tx,
                       apply_fn=jmodel.apply)
    jstep = jax.jit(jax_make_train_step(255, CLASSES, offset_weight=1.0))
    j_states, j_stats = [], []
    for _ in range(2):
        state, st = jstep(state, hb, jax.random.PRNGKey(0))
        j_states.append(state)
        j_stats.append({k: float(st[k]) for k in
                        ("loss", "loss_seg", "loss_offset")})
    model = _torch_model(variables).train()
    opt = make_optimizer(model, torch_sched.from_config(SCHEDULE_CFG, 2)[0])
    st = make_train_step(255, CLASSES, offset_weight=1.0)(
        model, opt, loader.to_device(hb, "cpu"), None)
    return (hb, variables, j_states, j_stats,
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()},
            {k: float(st[k]) for k in ("loss", "loss_seg", "loss_offset")})


def test_train_step_losses_match_jax(train_runs):
    _, _, _, j_stats, _, _, t_stats = train_runs
    for key in ("loss", "loss_seg", "loss_offset"):
        np.testing.assert_allclose(t_stats[key], j_stats[0][key],
                                   rtol=LOSS_RTOL, err_msg=key)
    assert t_stats["loss_offset"] > 0.05
    np.testing.assert_allclose(t_stats["loss"], t_stats["loss_seg"]
                               + t_stats["loss_offset"], rtol=1e-6)


def test_train_step_grads_and_params_match_jax(train_runs):
    _, _, j_states, _, grads, state, _ = train_runs
    want_g = from_flax(j_states[0].opt_state[0])
    assert set(want_g) == set(grads)
    for name, g in grads.items():
        err = np.linalg.norm(g.numpy() - want_g[name].numpy())
        bound = (GRAD_REL_L2 * np.linalg.norm(want_g[name].numpy())
                 + GRAD_FLOOR * np.sqrt(g.numel()))
        assert err <= bound, (name, err, bound)
    for name in ("reg_fc1.weight", "reg_fc2.weight", "reg_fc2.bias",
                 "reg_bn.weight"):
        assert float(grads[name].abs().max()) > 1e-6, name
    want = from_flax(j_states[0].params)
    for name, w in want.items():
        # entries whose grad is 0 in exact arithmetic (a shift the training
        # BatchNorm removes; an L1 offset grad whose signs balance, as
        # reg_fc2.bias[0]'s on this batch): the first Adam step is about lr
        # * sign of fp32 noise there, in either framework
        noise = (want_g[name].abs() < 1e-6).numpy()
        got, w = state[name].numpy(), w.numpy()
        np.testing.assert_allclose(got[noise], w[noise], rtol=0,
                                   atol=2.02 * BASE_LR, err_msg=name)
        if not noise.all():
            assert _rel_l2(got[~noise], w[~noise]) < PARAM_REL_L2, name
    want = from_flax({}, j_states[0].batch_stats)
    assert {"reg_bn.mean", "reg_bn.var"} <= set(want)
    for name, w in want.items():
        np.testing.assert_allclose(state[name].numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_adamw_state_with_the_head_converts(train_runs):
    """`from_flax_state` carries JAX's state after step 1 across, the
    head's moments and ``reg_bn`` statistics included; the port's step 2
    from it gives JAX's step-2 losses."""
    hb, variables, j_states, j_stats, grads, _, _ = train_runs
    st = j_states[0]
    model = _torch_model(variables).train()
    opt = make_optimizer(model, torch_sched.from_config(SCHEDULE_CFG, 2)[0])
    payload = from_flax_state(
        orbax_to_torch.plain_tree(st.params),
        orbax_to_torch.plain_tree(st.batch_stats),
        orbax_to_torch.plain_tree(st.opt_state[1]), 1, 0, model=model,
        optimizer=opt)
    model.load_state_dict(payload["model"], strict=True)
    opt.load_state_dict(payload["optimizer"])
    adam, = convert._adam_states(orbax_to_torch.plain_tree(st.opt_state[1]))
    mu, nu = from_flax(adam["mu"]), from_flax(adam["nu"])
    for name, p in model.named_parameters():
        assert torch.equal(opt.state[p]["exp_avg"], mu[name]), name
        assert torch.equal(opt.state[p]["exp_avg_sq"], nu[name]), name
    assert float(mu["reg_fc2.weight"].abs().max()) > 0
    assert torch.equal(model.reg_bn.var, torch.from_numpy(np.asarray(
        st.batch_stats["reg_bn"]["var"])))
    got = make_train_step(255, CLASSES, offset_weight=1.0)(
        model, opt, loader.to_device(hb, "cpu"), None)
    for key in ("loss", "loss_seg", "loss_offset"):
        np.testing.assert_allclose(float(got[key]), j_stats[1][key],
                                   rtol=LOSS_RTOL, err_msg=key)


def test_train_step_without_targets_has_no_offset_loss(train_runs):
    hb, variables = train_runs[:2]
    model = _torch_model(variables).train()
    opt = make_optimizer(model, torch_sched.from_config(SCHEDULE_CFG, 2)[0])
    batch = loader.to_device({k: v for k, v in hb.items()
                              if k != "target_shift"}, "cpu")
    st = make_train_step(255, CLASSES)(model, opt, batch, None)
    assert float(st["loss_offset"]) == 0.0
    assert float(st["loss"]) == float(st["loss_seg"])


# ---- the reader, synthetic rooms, collate and the loader ------------------

def write_cubes(root, scenes=3, seed=0):
    """Fabricated cube files under ``<root>/train`` and ``<root>/test``."""
    for split, n in (("train", scenes), ("test", 2)):
        chip_smoke.write_cube_files(root, split, n, seed + len(split),
                                    **CUBES)
    return root


@pytest.mark.parametrize("split", ["train", "test"])
def test_dcf_reader_matches_jax(tmp_path, split):
    write_cubes(str(tmp_path / "a"))
    write_cubes(str(tmp_path / "b"), scenes=1, seed=5)
    roots = [str(tmp_path / "a"), str(tmp_path / "b")]
    kw = dict(split=split, data_root=roots, voxel_size=0.04, sigma=0.02,
              voxel_max=900, shuffle_index=True, seed=7)
    ours, theirs = datasets.DCF(**kw), jax_datasets.DCF(**kw)
    assert ours.files == theirs.files
    assert len(ours) == 4
    for i in list(range(len(ours))) + [0]:     # item 0 visited twice
        a, b = ours[i], theirs[i]
        assert set(a) == set(b) == {"xyz", "feats", "labels", "target_shift"}
        for key in b:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    a = ours.load_item(ours.files[0])
    b = theirs.load_item(theirs.files[0])
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a[0].dtype == np.float64 and a[4].shape == (CUBES["cubes"], 6)


def test_synthetic_rooms_with_shift_match_jax():
    kw = dict(num_scenes=3, points=1500, voxel_size=0.04, voxel_max=900,
              seed=4, num_classes=CLASSES)
    ours = datasets.SyntheticRooms(with_shift=True, **kw)
    theirs = jax_datasets.SyntheticRooms(with_shift=True, **kw)
    for i in range(3):
        for x, y in zip(ours.raw_scene(i), theirs.raw_scene(i)):
            np.testing.assert_array_equal(x, y)
        a, b = ours[i], theirs[i]
        assert set(a) == set(b) and "target_shift" in a
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    # the offset draw comes after every other draw of the scene
    plain = datasets.SyntheticRooms(**kw)
    assert plain.raw_scene(0)[3] is None
    np.testing.assert_array_equal(plain[0]["xyz"], ours[0]["xyz"])


def test_collate_and_mix3d_with_targets_match_jax():
    rng = np.random.default_rng(0)

    def scene(n, shift=True):
        s = {"xyz": rng.normal(size=(n, 3)).astype(np.float32),
             "feats": rng.normal(size=(n, 6)).astype(np.float32),
             "labels": rng.integers(0, CLASSES, n).astype(np.int32)}
        if shift:
            s["target_shift"] = rng.normal(size=(n, 3)).astype(np.float32)
        return s

    scenes = [scene(5), scene(7), scene(3), scene(4, shift=False), scene(6)]
    for got, want in ((collate.mix3d_pairs(scenes),
                       jax_collate.mix3d_pairs(scenes)),
                      (collate.mix3d_pairs(scenes[:3]),
                       jax_collate.mix3d_pairs(scenes[:3]))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key])
    # a pair with one scene lacking targets has none
    assert "target_shift" not in collate.mix3d_pairs(scenes)[1]
    got = collate.collate_scenes(scenes[:3], 32, 4)
    want = jax_collate.collate_scenes(scenes[:3], 32, 4)
    for key in ("xyz", "feats", "labels", "offsets", "target_shift"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    assert got.target_shift.dtype == np.float32
    assert not got.target_shift[15:].any()
    assert collate.collate_scenes(scenes[3:4], 32, 4).target_shift is None


LOADER_CASES = {
    "dcf": dict(data_name="dcf", prefetch_workers=2),
    "dcf_mix3d": dict(data_name="dcf", mix3d=1.0, batch_size=4,
                      max_batch_points=4096),
    "synthetic": dict(data_name="synthetic", synthetic_scenes=4,
                      synthetic_points=1500),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_batches_match_jax(case, tmp_path):
    """`build_dataset` and the prefetch loader against the JAX driver's,
    batch for batch and bit for bit, ``target_shift`` included."""
    root = write_cubes(str(tmp_path), scenes=4)
    yaml_cfg = merge_cfg_from_list(load_cfg(CONFIG), [
        "data_root", str([root]), "channels", "[16,32,64,128]", "num_heads",
        "[1,2,4,8]", "depths", "[1,1,2,1]", "max_batch_points", "2048",
        "batch_size", "2", "voxel_max", "900", "compress_payload", "False"])
    for key, value in LOADER_CASES[case].items():
        yaml_cfg[key] = value
    pcfg, mcfg = from_cfg(yaml_cfg), jax_train.build_model_config(yaml_cfg, 1)
    for split, shuffle in (("train", True), ("val", False)):
        got = list(loader.BatchLoader(loader.build_dataset(yaml_cfg, split),
                                      pcfg, yaml_cfg, shuffle=shuffle,
                                      seed=5))
        want = [b[0] for b in jax_train.BatchLoader(
            jax_train.build_dataset(yaml_cfg, split, mcfg), mcfg, yaml_cfg,
            1, shuffle=shuffle, seed=5)]
        assert_batches_equal(got, want)
        assert all("target_shift" in b for b in got)
        n = int(got[0]["offsets"][-1])
        assert got[0]["target_shift"][:n].any()
        assert not got[0]["target_shift"][n:].any()


# ---- one epoch of the training driver --------------------------------------

# JAX's train.main trains one epoch on the cube files (jnp attention,
# drop-path off, validation on the test cubes); the port's driver trains
# the same epoch from JAX's initial state, converted. (A resumed epoch 2
# would not do: the cube reader draws its noise per item visit, and a
# resumed run's visits start again.) The milestones are given so that the
# schedule does not depend on ``epochs``.
EPOCH = ["channels", "[16,32,64,128]", "num_heads", "[1,2,4,8]", "depths",
         "[1,1,2,1]", "max_batch_points", "2048", "batch_size", "2",
         "voxel_max", "900", "attn_impl", "reference", "drop_path_rate",
         "0.0", "evaluate", "True", "n_devices", "1", "print_freq", "1",
         "rpe_precision", "highest", "qk_precision", "highest",
         "use_tensorboard", "False", "truncation_audit", "False",
         "compress_payload", "False", "epochs", "1", "milestones", "[1]"]
# the epoch's records, port against JAX: two AdamW steps from the same state
# on the same batches (the train loss: fp32 sums in another order through
# the model, 1e-5; an IoU moves when a point's predicted class flips).
# Validation runs in eval mode after the steps, where the biases whose grad
# is 0 in exact arithmetic (cls_fc1's, reg_fc1's, up_2's: a shift the
# training BatchNorm removes) have taken sign-like Adam steps of up to lr =
# 0.006 from fp32 noise in either framework, which the running statistics
# do not remove: the two validations differ by ~1e-4 in the loss and, at
# these near-uniform random-init logits, by many argmax flips. So the
# port's validation is compared on JAX's own epoch-1 weights instead, and
# its own validation loss only to 1e-3.
EPOCH_LOSS_RTOL, EPOCH_IOU_ATOL, OWN_VAL_RTOL = 1e-5, 1e-3, 1e-3


def jax_initial_state(yaml_cfg):
    """The train state ``train.main`` starts from (``train.py:405-445``):
    its model initialised from ``manual_seed`` on its loader's first batch,
    its optimizer over that epoch's iterations."""
    mcfg = jax_train.build_model_config(yaml_cfg, 1)
    seed = int(yaml_cfg["manual_seed"])
    jl = jax_train.BatchLoader(jax_train.build_dataset(yaml_cfg, "train",
                                                       mcfg),
                               mcfg, yaml_cfg, 1, shuffle=True, seed=seed)
    example = jl._make_batch(list(range(jl.scenes_per_batch)))[0]
    schedule, _ = jax_sched.from_config(yaml_cfg, jl.batches_per_epoch)
    return create_train_state(
        JaxStratified(mcfg), jax.random.PRNGKey(seed),
        (example["feats"], example["xyz"], example["offsets"]), schedule,
        weight_decay=float(yaml_cfg["weight_decay"]),
        transformer_lr_scale=float(yaml_cfg["transformer_lr_scale"]),
        optimizer=str(yaml_cfg["optimizer"])), jl.batches_per_epoch


def test_driver_epoch_matches_jax(tmp_path, monkeypatch):
    """The port's epoch from JAX's converted initial state against JAX's
    epoch, and the port's validation of JAX's epoch-1 weights against
    JAX's; the port's records hold the offset loss."""
    root = write_cubes(str(tmp_path / "cubes"), scenes=4)
    opts = EPOCH + ["data_root", str([root])]
    jax_save, port_save = str(tmp_path / "jax"), str(tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["train.py", "--config", CONFIG] + opts
                        + ["save_path", jax_save])
    jax_train.main()
    yaml_cfg = merge_cfg_from_list(load_cfg(CONFIG), opts + [
        "save_path", port_save])
    state, iters = jax_initial_state(yaml_cfg)
    cfg = from_cfg(yaml_cfg)
    model = Stratified(cfg)
    payload = from_flax_state(
        orbax_to_torch.plain_tree(state.params),
        orbax_to_torch.plain_tree(state.batch_stats),
        orbax_to_torch.plain_tree(state.opt_state), 0, 0, model=model,
        optimizer=driver.build_optimizer(model, yaml_cfg, iters))
    start = os.path.join(str(tmp_path), "start.pt")
    checkpoint.write(start, payload)
    _, summary = driver.run(dict(yaml_cfg, resume=start), "cpu",
                            log=lambda _: None)
    with open(os.path.join(jax_save, "metrics.jsonl")) as f:
        [want] = [json.loads(line) for line in f]
    [got] = summary["records"]
    assert got["epoch"] == want["epoch"] == 1 and summary["step"] == 2
    np.testing.assert_allclose(got["loss"], want["loss"],
                               rtol=EPOCH_LOSS_RTOL)
    for key in ("miou", "macc", "all_acc"):
        np.testing.assert_allclose(got[key], want[key], atol=EPOCH_IOU_ATOL,
                                   err_msg=key)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"],
                               rtol=OWN_VAL_RTOL)
    assert 0.0 < got["loss_offset"] < got["loss"]
    with open(os.path.join(port_save, "metrics.jsonl")) as f:
        assert "loss_offset" in json.loads(f.read().splitlines()[-1])
    assert all("loss_offset" in r for r in summary["iters"])

    # JAX's epoch-1 weights, validated by the port
    converted = os.path.join(str(tmp_path), "jax_1.pt")
    assert orbax_to_torch.main([
        "--config", CONFIG, "--ckpt", os.path.join(jax_save, "ckpt"),
        "--out", converted] + opts) == 0
    jax_weights = Stratified(cfg)
    checkpoint.restore(converted, jax_weights)
    vloss, vm, forwards = driver.validate(
        jax_weights, loader.BatchLoader(loader.build_dataset(yaml_cfg, "val"),
                                        cfg, yaml_cfg, shuffle=False, seed=0),
        make_eval_step(255, CLASSES), "cpu")
    assert forwards == 1
    np.testing.assert_allclose(vloss.avg, want["val_loss"],
                               rtol=EPOCH_LOSS_RTOL)
    np.testing.assert_allclose(vm["miou"], want["val_miou"],
                               atol=EPOCH_IOU_ATOL)
