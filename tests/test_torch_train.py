"""PyTorch port, training: one train step of a narrow 4-stage model against
the JAX package's ``make_train_step`` (attention through the jnp reference,
drop-path off) on the same weights and host batch — per-parameter grads,
parameters after the AdamW step, BatchNorm statistics, then a 5-step loss
trajectory; the schedules, drop-path, the augmentations and checkpoints."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stratified_transformer_tpu.data import transforms as jax_tf
from stratified_transformer_tpu.models.stratified import (
    Stratified as JaxStratified, StratifiedConfig as JaxConfig)
from stratified_transformer_tpu.train import schedulers as jax_sched
from stratified_transformer_tpu.train.state import (
    TrainState, make_optimizer as jax_make_optimizer)
from stratified_transformer_tpu.train.step import (
    make_train_step as jax_make_train_step)
from stratified_transformer_torch.config import StratifiedConfig
from stratified_transformer_torch.convert import from_flax
from stratified_transformer_torch.data import loader
from stratified_transformer_torch.data import transforms as torch_tf
from stratified_transformer_torch.models.layers import drop_path
from stratified_transformer_torch.models.stratified import (
    Stratified, build_model)
from stratified_transformer_torch.train import checkpoint
from stratified_transformer_torch.train import schedulers as torch_sched
from stratified_transformer_torch.train.state import (
    make_optimizer, optimizer_step)
from stratified_transformer_torch.train.step import make_train_step

torch.set_num_threads(1)

NARROW = dict(num_classes=13, in_channels=6, channels=(16, 32, 64, 128),
              num_heads=(1, 2, 4, 8), depths=(1, 1, 2, 1), num_layers=4,
              n_pad=2048, num_scenes=2, tile=128, band=128,
              band_per_stage=(128, 128, 384, 192), sparse_cap=48, s_band=128,
              drop_path_rate=0.0)
SCHEDULE_CFG = {"scheduler": "MultiStep", "scheduler_update": "epoch",
                "base_lr": 0.006, "epochs": 100}
STEPS = 5
CONFIG = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
    "s3dis_stratified.yaml"
# Gradients: one forward and backward through five attention blocks, a
# U-Net and two BatchNorms in training mode, fp32 sums in another order
# (explicit vs autodiff backward, per-tile partials, bin masses); each
# parameter's grad within 1e-4 of JAX's in relative L2 norm over the
# tensor, plus an fp32 noise floor of 1e-7 per entry. Measured: <= 4e-6.
GRAD_REL_L2, GRAD_FLOOR = 1e-4, 1e-7
# Five parameters get a gradient that is 0 in exact arithmetic: a constant
# shift of the head's input (the biases of up_2 and cls_fc1) is removed by
# the training-mode BatchNorm's mean. Both frameworks return fp32 noise of
# ~1e-8 there.
ZERO_GRAD = {"up_2.norm1.bias", "up_2.norm2.bias", "up_2.linear1.bias",
             "up_2.linear2.bias", "cls_fc1.bias"}
# Parameters after one AdamW step at lr 0.006 (x0.1 on blocks): the other
# parameters within 1e-4 relative L2 (measured <= 3e-6). The first Adam
# update is lr * g / (|g| + eps), about a sign, so on the ZERO_GRAD
# parameters the noise moves each entry by up to lr in either framework:
# those are held to that bound instead.
PARAM_REL_L2 = 1e-4
BASE_LR = 0.006
# BatchNorm running statistics: batch means and variances of the same
# activations, updated with momentum 0.02 / 0.1
STATS_RTOL, STATS_ATOL = 1e-4, 1e-6
# Loss after up to 4 updates: the sign-like Adam steps amplify the fp32
# noise of the grads step by step
LOSS_RTOL = 1e-4


def _random_variables(shapes, rng):
    """Random flax variables of the given shapes: O(1) activations through
    every layer, BatchNorm statistics away from (0, 1)."""
    def fill(path, x):
        name, shape = path[-1].key, x.shape
        if name in ("kernel", "kernel_weights"):
            fan_in = int(np.prod(shape[:-1]))
            w = rng.normal(0, fan_in ** -0.5, shape)
        elif name.endswith("_table"):
            w = rng.normal(0, 0.05, shape)
        elif name == "scale":
            w = rng.uniform(0.8, 1.2, shape)
        elif name in ("bias", "mean"):
            w = rng.normal(0, 0.1, shape)
        elif name == "var":
            w = rng.uniform(0.5, 1.5, shape)
        else:
            raise KeyError(name)
        return w.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _record_grads():
    """An optax stage that keeps the gradients it is given in its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def runs():
    cfg = StratifiedConfig(**NARROW)
    hb = loader.host_batch(cfg, seed=0)
    jcfg = JaxConfig(**NARROW, sampler="grid", attn_impl="reference",
                     rpe_precision="highest", qk_precision="highest")
    jmodel = JaxStratified(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0)}, hb["feats"], hb["xyz"],
            hb["offsets"], training=False, stem_nidx=hb["stem_nidx"],
            stem_nmask=hb["stem_nmask"], pyramid=hb["pyramid"]))
    rng = np.random.default_rng(7)
    params = _random_variables(shapes["params"], rng)
    stats = _random_variables(shapes["batch_stats"], rng)

    schedule, _ = jax_sched.from_config(SCHEDULE_CFG, 2)
    tx = optax.chain(_record_grads(),
                     jax_make_optimizer(params, schedule, 0.01, 0.1))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params), tx=tx,
                       apply_fn=jmodel.apply)
    jstep = jax.jit(jax_make_train_step(255, 13))
    key = jax.random.PRNGKey(0)
    j_states, j_losses = [], []
    for _ in range(STEPS):
        state, st = jstep(state, hb, key)
        j_states.append(state)
        j_losses.append(float(st["loss"]))

    model = Stratified(cfg)
    model.load_state_dict(from_flax(params, stats), strict=True)
    model.train()
    opt = make_optimizer(model, torch_sched.from_config(SCHEDULE_CFG, 2)[0])
    tstep = make_train_step(255, 13)
    batch = loader.to_device(hb, "cpu")
    t_losses, first = [], None
    for i in range(STEPS):
        st = tstep(model, opt, batch, None)
        t_losses.append(float(st["loss"]))
        if i == 0:
            first = ({n: p.grad.clone() for n, p in model.named_parameters()},
                     {k: v.clone() for k, v in model.state_dict().items()},
                     st)
    return j_states, j_losses, first, t_losses


def test_grads_match_jax(runs):
    j_states, _, (grads, _, _), _ = runs
    want = from_flax(j_states[0].opt_state[0])
    assert set(want) == set(grads)
    for name, g in grads.items():
        err = np.linalg.norm(g.numpy() - want[name].numpy())
        bound = (GRAD_REL_L2 * np.linalg.norm(want[name].numpy())
                 + GRAD_FLOOR * np.sqrt(g.numel()))
        assert err <= bound, (name, err, bound)
    tiny = {n for n, w in want.items() if float(w.abs().max()) < 1e-6}
    assert tiny == ZERO_GRAD
    # the attention blocks' tables and projections receive gradient
    assert float(grads["layer_2.blocks_1.attn.rel_key_table"].abs().max()
                 ) > 1e-6


def test_params_after_adamw_match_jax(runs):
    j_states, _, (_, state, _), _ = runs
    want = from_flax(j_states[0].params)
    for name, w in want.items():
        if name in ZERO_GRAD:
            np.testing.assert_allclose(state[name].numpy(), w.numpy(),
                                       rtol=0, atol=2.02 * BASE_LR,
                                       err_msg=name)
        else:
            assert _rel_l2(state[name].numpy(), w.numpy()) < PARAM_REL_L2, \
                name


def test_batch_stats_match_jax(runs):
    j_states, _, (_, state, _), _ = runs
    want = from_flax({}, j_states[0].batch_stats)
    assert set(want) == {"stem_0.bn.mean", "stem_0.bn.var", "cls_bn.mean",
                         "cls_bn.var"}
    for name, w in want.items():
        np.testing.assert_allclose(state[name].numpy(), w.numpy(),
                                   rtol=STATS_RTOL, atol=STATS_ATOL,
                                   err_msg=name)


def test_loss_trajectory_matches_jax(runs):
    _, j_losses, (_, _, st), t_losses = runs
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    assert t_losses[-1] < t_losses[0]            # the steps train
    assert set(st) == {"loss", "loss_seg", "loss_offset", "intersection",
                       "union", "target", "points"}


@pytest.mark.parametrize("cfg", [
    SCHEDULE_CFG,
    dict(SCHEDULE_CFG, milestones="3,7", gamma=0.5),
    dict(SCHEDULE_CFG, scheduler="MultiStepWithWarmup", epochs=10,
         warmup_iters=12, warmup_ratio=1e-3),
    dict(SCHEDULE_CFG, scheduler="Poly", epochs=10),
    dict(SCHEDULE_CFG, scheduler="Poly", scheduler_update="step", epochs=10,
         power=0.8)])
def test_schedules_match_jax(cfg):
    want, w_gran = jax_sched.from_config(cfg, 4)
    got, g_gran = torch_sched.from_config(cfg, 4)
    assert g_gran == w_gran
    # every step of the run (a poly schedule is undefined past its end)
    steps = [s for s in list(range(0, 45)) + [199, 240, 320, 399]
             if s < cfg["epochs"] * 4]
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(s)) for s in steps], rtol=1e-6)


def test_drop_path_mask_per_point_and_seeded():
    x = torch.randn(4096, 8)
    out = drop_path(x, 0.3, torch.Generator().manual_seed(5))
    kept = (out != 0).all(1)
    dropped = (out == 0).all(1)
    assert bool((kept | dropped).all())          # whole rows, per point
    torch.testing.assert_close(out[kept], x[kept] / 0.7)
    assert abs(float(kept.float().mean()) - 0.7) < 0.03
    again = drop_path(x, 0.3, torch.Generator().manual_seed(5))
    torch.testing.assert_close(out, again, rtol=0, atol=0)
    assert drop_path(x, 0.0, None) is x


def test_drop_path_schedule_matches_jax():
    got = StratifiedConfig(drop_path_rate=0.3).drop_path_schedule()
    want = JaxConfig(drop_path_rate=0.3).drop_path_schedule()
    np.testing.assert_array_equal(got, want)
    assert len(got) == 12 and got[0] == 0.0 and got[-1] == 0.3


def test_transforms_bit_equal_to_jax():
    rng0 = np.random.default_rng(3)
    points = rng0.uniform(0, 4, (500, 3)).astype(np.float32)
    color = rng0.uniform(0, 255, (500, 3)).astype(np.float32)
    want_t = jax_tf.Compose([
        jax_tf.RandomRotate(along_z=True), jax_tf.RandomScale(0.8, 1.2),
        jax_tf.RandomJitter(0.005, 0.02),
        jax_tf.RandomDropColor(color_augment=0.0)])
    got_t = torch_tf.train_transform({})
    for seed in range(6):                 # some draws drop the colors
        wp, wc = want_t(points, color, np.random.default_rng(seed))
        gp, gc = got_t(points, color, np.random.default_rng(seed))
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gc, wc)


def test_train_batch_deterministic_and_augmented():
    cfg = StratifiedConfig(**NARROW)
    a = loader.host_batch(cfg, seed=1, train=True,
                          rng=np.random.default_rng(9))
    b = loader.host_batch(cfg, seed=1, train=True,
                          rng=np.random.default_rng(9))
    plain = loader.host_batch(cfg, seed=1)
    for key in ("feats", "xyz", "offsets", "labels", "stem_nidx"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert not np.array_equal(a["xyz"], plain["xyz"])
    with pytest.raises(ValueError):
        loader.host_batch(cfg, seed=1, train=True)


def test_checkpoint_round_trip(tmp_path):
    cfg = StratifiedConfig(**NARROW)
    model = build_model(cfg, "cpu", seed=0, train=True)
    opt = make_optimizer(model, torch_sched.from_config(SCHEDULE_CFG, 2)[0])
    batch = loader.to_device(loader.host_batch(cfg, seed=0), "cpu")
    make_train_step(255, 13)(model, opt, batch, None)
    path = checkpoint.save(str(tmp_path / "ckpt"), model, opt, step=1,
                           epoch=3, best_iou=0.25)
    assert path == str(tmp_path / "ckpt" / "3.pt")

    for source in (path, str(tmp_path / "ckpt")):   # the file, the latest
        model2 = build_model(cfg, "cpu", seed=1, train=True)
        opt2 = make_optimizer(model2,
                              torch_sched.from_config(SCHEDULE_CFG, 2)[0])
        assert checkpoint.restore(source, model2, opt2) == (1, 3, 0.25)
        for (name, a), b in zip(model.state_dict().items(),
                                model2.state_dict().values()):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
        assert opt2.param_groups[0]["t"] == 1
        s1, s2 = opt.state_dict()["state"], opt2.state_dict()["state"]
        for i in s1:
            torch.testing.assert_close(s1[i]["exp_avg"], s2[i]["exp_avg"],
                                       rtol=0, atol=0)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    from stratified_transformer_tpu.train import losses as jax_losses
    from stratified_transformer_torch.train import losses as torch_losses
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(300, 13)).astype(np.float32)
    labels = rng.integers(0, 13, 300).astype(np.int32)
    labels[::7] = 255
    valid = np.arange(300) < 280
    want = jax_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    255, jnp.asarray(valid), smoothing)
    got = torch_losses.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels), 255,
                                     torch.from_numpy(valid), smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_masked_batchnorm_training_matches_jax():
    """Batch statistics over valid rows, torch-style running update with the
    unbiased variance, momentum 0.02 (the stem's)."""
    from stratified_transformer_tpu.models.layers import (
        MaskedBatchNorm as JaxBN)
    from stratified_transformer_torch.models.layers import MaskedBatchNorm
    rng = np.random.default_rng(12)
    x = rng.normal(1.0, 2.0, (200, 8)).astype(np.float32)
    valid = np.arange(200) < 150
    jbn = JaxBN(momentum=0.02)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(valid), training=False)
    want, updated = jbn.apply(variables, jnp.asarray(x), jnp.asarray(valid),
                              training=True, mutable=["batch_stats"])
    bn = MaskedBatchNorm(8, momentum=0.02).train()
    got = bn(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for key in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(bn, key).numpy(),
            np.asarray(updated["batch_stats"][key]), rtol=1e-6, atol=1e-7,
            err_msg=key)


def test_driver_trains_and_saves(tmp_path):
    """The training entry point on the CPU at a narrow width: one epoch of
    two augmented synthetic batches from the S3DIS YAML with overrides,
    validation, metrics.jsonl and the epoch's checkpoint."""
    from stratified_transformer_torch.train import driver
    save = tmp_path / "run"
    assert driver.main([
        "--config", str(CONFIG), "--device", "cpu", "data_name",
        "synthetic", "synthetic_scenes", "4", "synthetic_points", "1500",
        "voxel_max", "900", "max_batch_points", "2048", "batch_size", "2",
        "channels", "[16,32,64,128]", "num_heads", "[1,2,4,8]", "depths",
        "[1,1,2,1]", "epochs", "1", "use_tensorboard", "False",
        "save_path", str(save)]) == 0
    [record] = [json.loads(line) for line in
                (save / "metrics.jsonl").read_text().splitlines()]
    assert record["epoch"] == 1 and np.isfinite(record["val_loss"])
    assert "Train epoch [1/1]: mIoU" in (save / "log.txt").read_text()
    model = build_model(StratifiedConfig(**dict(NARROW, drop_path_rate=0.3)),
                        "cpu", seed=5, train=True)
    step, epoch, _ = checkpoint.restore(str(save / "ckpt"), model)
    assert (step, epoch) == (2, 1)


@pytest.mark.parametrize("clips", [True, False])
def test_grad_clip_matches_optax(runs, clips):
    """Two AdamW steps under ``max_grad_norm`` against the JAX package's
    optax chain on random parameters and gradients of the narrow model's
    shapes: the clipped gradients within 1e-6 relative L2, the parameters
    after each step within PARAM_REL_L2. The first gradients' norm is above
    the limit when ``clips``; the second's is below it, so the second Adam
    update sees the first's scale."""
    cfg = StratifiedConfig(**NARROW)
    shapes = runs[0][0].params
    rng = np.random.default_rng(21)
    params = _random_variables(shapes, rng)
    grads = [jax.tree.map(lambda x, s=s: (s * rng.normal(size=x.shape)
                                          ).astype(np.float32), shapes)
             for s in (1.0, 0.01)]
    norm = float(np.sqrt(sum(np.sum(np.square(g))
                             for g in jax.tree.leaves(grads[0]))))
    max_norm = 0.5 * norm if clips else 2.0 * norm
    schedule, _ = jax_sched.from_config(SCHEDULE_CFG, 2)
    tx = jax_make_optimizer(params, schedule, 0.01, 0.1, grad_clip=max_norm)
    clip = optax.clip_by_global_norm(max_norm)

    model = Stratified(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(from_flax(params)[name])
    opt = make_optimizer(model, torch_sched.from_config(SCHEDULE_CFG, 2)[0],
                         max_grad_norm=max_norm)
    state, jparams = tx.init(params), params
    for step, g in enumerate(grads):
        want_g = from_flax(jax.jit(clip.update)(g, clip.init(params))[0])
        updates, state = jax.jit(tx.update)(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        got_g = from_flax(g)
        for name, p in model.named_parameters():
            p.grad = got_g[name].clone()
        optimizer_step(opt)
        want_p = from_flax(jparams)
        for name, p in model.named_parameters():
            assert _rel_l2(p.grad.numpy(), want_g[name].numpy()) < 1e-6, name
            assert _rel_l2(p.detach().numpy(), want_p[name].numpy()) < \
                PARAM_REL_L2, name
        if step == 0:       # the clipped gradients' norm is the limit
            got = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                       for p in model.parameters())))
            np.testing.assert_allclose(got, max_norm if clips else norm,
                                       rtol=1e-5)
