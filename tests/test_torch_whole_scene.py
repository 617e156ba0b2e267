"""PyTorch port, whole-scene evaluation (the JAX package's ``test.py``
path): the host protocol (voxelize mode 1, vote chunks, sphere crops, TTA
transforms) bit-identical to the JAX package's; a narrow model run without
a pyramid, so that sampling and neighbour search run on the device, against
``model.apply`` without one; `evaluate_scene` against the JAX package's; the
S3DIS reader; the eval driver on the CPU and its refusals."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratified_transformer_tpu.data import datasets as jax_datasets
from stratified_transformer_tpu.data import transforms as jax_transforms
from stratified_transformer_tpu.data.voxelize import voxelize as jax_voxelize
from stratified_transformer_tpu.eval import voting as jax_voting
from stratified_transformer_tpu.models.stratified import (
    Stratified as JaxStratified, StratifiedConfig as JaxConfig)
from stratified_transformer_tpu.ops import attention as jax_attention
from stratified_transformer_tpu.ops import neighbors as jax_nb
from stratified_transformer_tpu.ops import sampling as jax_sampling
from stratified_transformer_tpu.train import metrics as jax_metrics
from stratified_transformer_torch.config import StratifiedConfig
from stratified_transformer_torch.convert import from_flax
from stratified_transformer_torch.data import datasets, loader
from stratified_transformer_torch.data.voxelize import voxelize
from stratified_transformer_torch.eval import driver, voting
from stratified_transformer_torch.models.stratified import (
    Stratified, build_model, geometry_pyramid)
from stratified_transformer_torch.train.metrics import iou_from_counts
from stratified_transformer_torch.utils.config import (
    load_cfg, merge_cfg_from_list)
from test_torch_model import NARROW, _random_variables

torch.set_num_threads(1)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
# one forward: the no-pyramid logits compound the per-layer reorderings of
# test_torch_model's comparison with the cell-list distances' (XLA may fuse
# the squared sums); observed ~3e-6
RTOL, ATOL = 2e-4, 2e-5
# the accumulated probabilities: per-point sums of softmaxes over its vote
# chunks and TTA passes, each normalised, so of the softmaxes' own error
PROB_ATOL, MARGIN = 1e-5, 1e-4
# a small room for the protocol at a quarter of its flat capacity: crops of
# VOXEL_MAX points (the sphere cover runs on every vote chunk), batches of
# BATCH_TEST crops, some with an empty last scene; three TTA passes (none, a
# rotation, a shift) of the seven keep the JAX side's time down
SCENE = dict(points=900, extent=1.5)
VOXEL_MAX, BATCH_TEST, SCENE_N_PAD = 500, 2, 1024
TTA = (0, 2, 6)


def _scene():
    """(coord, feat, label) of the scene; it has no offset targets."""
    return datasets.SyntheticRooms(num_scenes=1, seed=999,
                                   **SCENE).raw_scene(0)[:3]


# ---- the host protocol -------------------------------------------------

def test_voxelize_mode1_and_vote_chunks_match_jax():
    coord = _scene()[0]
    coord = coord - coord.min(0)
    got, want = voxelize(coord, 0.04, mode=1), jax_voxelize(coord, 0.04,
                                                            mode=1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    got, want = voting.vote_chunks(coord, 0.04), jax_voting.vote_chunks(
        coord, 0.04)
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_sphere_cover_crops_match_jax():
    coord = _scene()[0]
    for voxel_max in (700, 1500, 10000):
        got = voting.sphere_cover_crops(coord, voxel_max,
                                        np.random.default_rng(3))
        want = jax_voting.sphere_cover_crops(coord, voxel_max,
                                             np.random.default_rng(3))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert len(np.unique(np.concatenate(got))) == len(coord)


def test_tta_transforms_match_jax():
    coord, feat, _ = _scene()
    for name in ("s3dis", "synthetic"):
        got, want = (voting.tta_transforms(name),
                     jax_voting.tta_transforms(name))
        assert len(got) == len(want) == (7 if name == "s3dis" else 5)
        for a, b in zip(got, want):
            if a is None:
                assert b is None
                continue
            pa, ca = a(coord, feat, np.random.default_rng(0))
            pb, cb = b(coord, feat, np.random.default_rng(0))
            np.testing.assert_array_equal(pa, pb)
            np.testing.assert_array_equal(ca, cb)
    shift = jax_transforms.FixedShift(-0.2)(coord, feat)[0]
    from stratified_transformer_torch.data.transforms import FixedShift
    np.testing.assert_array_equal(FixedShift(-0.2)(coord, feat)[0], shift)


def test_iou_from_counts_matches_jax():
    rng = np.random.default_rng(0)
    inter = rng.integers(0, 50, 13)
    union = inter + rng.integers(0, 50, 13)
    target = inter + rng.integers(0, 20, 13)
    got = iou_from_counts(inter, union, target)
    want = jax_metrics.iou_from_counts(inter, union, target)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


# ---- the model without a pyramid ---------------------------------------

def jax_members_lost(cfg, pyramid, xyz, offsets):
    """Stage members that the JAX package's scatter (``models/stratified.
    py:218``) unmarks on the levels of ``pyramid`` (the port's), where the
    host rule keeps them."""
    lost = 0
    levels = [(xyz, offsets)]
    for lvl in pyramid["down"]:
        levels.append((levels[-1][0][lvl["idx"].numpy()],
                       lvl["offsets"].numpy()))
    for i, (x, off) in enumerate(levels):
        n = len(x)
        counts = jnp.asarray(off) - jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.asarray(off, jnp.int32)[:-1]])
        d_off = jax_sampling.counts_to_offsets(jax_sampling.floor_ratio_counts(
            counts, 1.0 / cfg.downsample_scale))
        d_idx, d_valid = jax_sampling.grid_pool_sampling(
            jnp.asarray(x), jnp.asarray(off, jnp.int32), d_off,
            n // cfg.downsample_scale + cfg.num_scenes,
            cfg.grid_sizes()[i] * float(cfg.downsample_scale) ** 0.5)
        jax_down = np.asarray(jnp.zeros((n,), bool).at[d_idx].set(
            d_valid, mode="drop"))
        lost += int((pyramid["stage_down"][i]["is_down"].numpy()
                     & ~jax_down).sum())
    return lost


def jax_pyramid(jcfg, xyz, offsets):
    """The JAX package's on-device stem neighbours and geometry pyramid
    (``models/stratified.py:298-307``, ``models/layers.py:163-208, 237-
    247`` with the model's knobs; member masks from ``layer_start``, as the
    ScanNet family's stem level has none), but with the host pyramid's
    member rule
    (``is_down[d_idx[d_valid]] = True``) in place of the scatter that drops
    members (``models/stratified.py:218``)."""
    n = xyz.shape[0]
    batch = jax_sampling.offsets_to_batch(offsets, n)
    valid = jax_sampling.offsets_to_valid(offsets, n)
    nidx, nmask = jax_nb.radius_neighbors(
        xyz, batch, xyz, batch, valid, 2.5 * jcfg.grid_size * jcfg.sigma,
        jcfg.max_num_neighbors, chunk=jcfg.knn_chunk, method="grid",
        cap=jcfg.neighbor_cap, grid_chunk=jcfg.grid_knn_chunk)
    levels, down, stage_down = [(xyz, offsets)], [], []
    for i in range(jcfg.num_layers):
        x, off = levels[-1]
        m = x.shape[0]
        counts = off - jnp.concatenate([jnp.zeros((1,), off.dtype), off[:-1]])
        d_off = jax_sampling.counts_to_offsets(jax_sampling.floor_ratio_counts(
            counts, 1.0 / jcfg.downsample_scale))
        d_idx, d_valid = jax_sampling.grid_pool_sampling(
            x, off, d_off, m // jcfg.downsample_scale + jcfg.num_scenes,
            jcfg.grid_sizes()[i] * float(jcfg.downsample_scale) ** 0.5)
        if i >= jcfg.layer_start:
            stage_down.append({"is_down": jnp.zeros((m + 1,), bool).at[
                jnp.where(d_valid, d_idx, m)].set(True)[:m]})
        if i == jcfg.num_layers - 1:
            break
        out_pad = -(-(int(m * jcfg.ratio) + jcfg.num_scenes) // jcfg.tile
                    ) * jcfg.tile
        new_off = jax_sampling.counts_to_offsets(
            jax_sampling.floor_ratio_counts(counts, jcfg.ratio))
        idx, ok = jax_sampling.grid_pool_sampling(
            x, off, new_off, out_pad, jcfg.grid_sizes()[i] * 2.0)
        knn_idx, _, knn_mask = jax_nb.grid_knn(
            x[idx], jax_sampling.offsets_to_batch(new_off, out_pad), x,
            jax_sampling.offsets_to_batch(off, m),
            jax_sampling.offsets_to_valid(off, m), jcfg.k,
            cell=jcfg.grid_sizes()[i] * 3.0, cap=jcfg.neighbor_cap,
            query_valid=ok, chunk=jcfg.grid_knn_chunk)
        down.append({"idx": idx, "valid": ok, "offsets": new_off,
                     "knn_idx": knn_idx, "knn_mask": knn_mask})
        levels.append((x[idx], new_off))
    up = []
    for j in range(jcfg.num_layers - 1, 0, -1):
        (fx, foff), (cx, coff) = levels[j - 1], levels[j]
        nf, nc = fx.shape[0], cx.shape[0]
        idx, _, mask = jax_nb.grid_knn(
            fx, jax_sampling.offsets_to_batch(foff, nf), cx,
            jax_sampling.offsets_to_batch(coff, nc),
            jax_sampling.offsets_to_valid(coff, nc), 3,
            cell=jcfg.grid_sizes()[j - 1] * 6.0, cap=jcfg.neighbor_cap,
            query_valid=jax_sampling.offsets_to_valid(foff, nf),
            chunk=jcfg.grid_knn_chunk)
        up.append({"idx": idx, "mask": mask})
    return nidx, nmask, {"down": down, "up": up, "stage_down": stage_down}


def literal_bins(rel, window_size, quant_size, num_bins):
    """The JAX package's cRPE bin formula (``ops/attention.py:40-56``)
    evaluated as written: XLA on the CPU contracts its multiply and add into
    one fused multiply-add and so flips bins that land on a quantization
    boundary (the port's bins are the literal ones, as the kernels' on the
    card; ``tests/test_torch_probes.py`` pins the same rewrite of the probe's
    formula). Each rounded step passes an integer xor with a zero the
    compiler cannot see, so nothing is fused across it."""
    rel = rel.astype(jnp.float32)
    zero = jnp.isnan(rel).any().astype(jnp.int32)

    def rounded(v):
        return jax.lax.bitcast_convert_type(
            jax.lax.bitcast_convert_type(v, jnp.int32) ^ zero, jnp.float32)

    r = rounded(jnp.round(rel * 1e5) * jnp.float32(1e-5))
    r = rounded(r + jnp.float32(2.0 * window_size - 1e-4))
    ridx = jnp.floor(r * jnp.float32(1.0 / float(quant_size)))
    return jnp.clip(ridx, 0, num_bins - 1).astype(jnp.int32)


@pytest.fixture(scope="module")
def models():
    """The narrow model in both packages with the same random weights, and
    a jitted JAX forward without a pyramid and one over `jax_pyramid`, both
    with `literal_bins`. XLA's bin rewrite flipped some bin in 19 of the 65
    forwards of a 2500-point room's `evaluate_scene`, each moving a point's
    probabilities by up to ~3e-3."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_attention, "relative_position_index",
                      literal_bins)
        yield _models()


def _models():
    cfg = StratifiedConfig(**NARROW)
    scene_cfg = StratifiedConfig(**dict(NARROW, n_pad=SCENE_N_PAD))
    jcfg = JaxConfig(**NARROW, sampler="grid", attn_impl="reference")
    jmodel = JaxStratified(jcfg)
    jscene_cfg = JaxConfig(**dict(NARROW, n_pad=SCENE_N_PAD),
                           sampler="grid", attn_impl="reference")
    jscene = JaxStratified(jscene_cfg)
    hb = loader.host_batch(cfg, seed=0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, hb["feats"], hb["xyz"],
        hb["offsets"], training=False))
    rng = np.random.default_rng(5)
    variables = {"params": _random_variables(shapes["params"], rng),
                 "batch_stats": _random_variables(shapes["batch_stats"], rng)}

    @jax.jit
    def jax_logits(feats, xyz, offsets):
        return jmodel.apply(variables, feats, xyz, offsets, training=False)[0]

    @jax.jit
    def jax_probs_host_rule(feats, xyz, offsets):
        nidx, nmask, pyr = jax_pyramid(jscene_cfg, xyz, offsets)
        logits = jscene.apply(variables, feats, xyz, offsets, training=False,
                              stem_nidx=nidx, stem_nmask=nmask,
                              pyramid=pyr)[0]
        return jax.nn.softmax(logits, -1)

    state = from_flax(variables["params"], variables["batch_stats"])
    model, scene_model = Stratified(cfg), Stratified(scene_cfg)
    for m in (model, scene_model):
        m.load_state_dict(state, strict=True)
        m.eval()
    return (cfg, hb, model, jax_logits), (scene_model, jax_probs_host_rule)


def test_forward_without_pyramid_matches_jax(models):
    cfg, hb, model, jax_logits = models[0]
    xyz, off = torch.from_numpy(hb["xyz"]), torch.from_numpy(hb["offsets"])
    # the precondition: on this batch JAX's member scatter unmarks no member
    assert jax_members_lost(cfg, geometry_pyramid(cfg, xyz, off.long()),
                            hb["xyz"], hb["offsets"]) == 0
    with torch.no_grad():
        got = model(torch.from_numpy(hb["feats"]), xyz, off.long())[0]
    want = np.asarray(jax_logits(hb["feats"], hb["xyz"], hb["offsets"]))
    n_valid = int(hb["offsets"][-1])
    np.testing.assert_allclose(got.numpy()[:n_valid], want[:n_valid],
                               rtol=RTOL, atol=ATOL)


def test_evaluate_scene_matches_jax(models):
    model, jax_probs = models[1]
    coord, feat, _ = _scene()
    transforms = [voting.tta_transforms("s3dis")[i] for i in TTA]
    jax_tfms = [jax_voting.tta_transforms("s3dis")[i] for i in TTA]
    kw = dict(data_name="s3dis", voxel_size=0.04, voxel_max=VOXEL_MAX,
              batch_size_test=BATCH_TEST, n_pad=SCENE_N_PAD,
              num_scenes=BATCH_TEST)
    calls = []
    predict = driver.make_predict_probs(model)

    def counted(feats, xyz, offsets):
        calls.append([int(o) for o in offsets])
        return predict(feats, xyz, offsets)

    pred, probs = voting.evaluate_scene(counted, coord, feat, 13,
                                        transforms=transforms, **kw)
    want_pred, want_probs = jax_voting.evaluate_scene(
        lambda f, x, o: np.asarray(jax_probs(f, x, o)), coord, feat, 13,
        transforms=jax_tfms, **kw)
    # the sphere cover ran, and some batch had an empty last scene
    assert len(calls) > len(TTA) and max(o[0] for o in calls) == VOXEL_MAX
    assert any(o[0] == o[-1] for o in calls)
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=PROB_ATOL)
    top2 = np.sort(want_probs, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > MARGIN
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(pred[clear], want_pred[clear])


# ---- the S3DIS reader and the driver -----------------------------------

def _write_rooms(root, n=600, seed=0):
    """Rooms of ``n`` random points (xyz, rgb 0-255, label columns)."""
    rng = np.random.default_rng(seed)
    names = ["Area_1_office_1", "Area_5_office_2", "Area_5_hallway_1",
             "Area_5_office_10"]
    for name in names:
        room = np.concatenate([
            rng.uniform(0, 3, (n, 3)), rng.uniform(0, 255, (n, 3)),
            rng.integers(0, 13, (n, 1))], 1).astype(np.float32)
        np.save(os.path.join(root, name + ".npy"), room)
    return names


def test_s3dis_reader_matches_jax(tmp_path):
    _write_rooms(tmp_path)
    for split in ("train", "val"):
        kw = dict(split=split, data_root=str(tmp_path), test_area=5,
                  voxel_size=0.04, voxel_max=300, shuffle_index=True, loop=2,
                  seed=7)
        ours, theirs = datasets.S3DIS(**kw), jax_datasets.S3DIS(**kw)
        assert ours.data_list == theirs.data_list
        assert len(ours) == len(theirs) == 2 * (1 if split == "train" else 3)
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            for key in ("xyz", "feats", "labels"):
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    scenes = datasets.s3dis_scenes(str(tmp_path), 5)
    assert [s[0] for s in scenes] == ["Area_5_hallway_1", "Area_5_office_10",
                                      "Area_5_office_2"]
    assert scenes[0][3].dtype == np.int64 and scenes[0][1].shape == (600, 3)
    assert scenes[0][2].shape == (600, 3)


NARROW_ARGS = ["channels", "[16,32,64,128]", "num_heads", "[1,2,4,8]",
               "depths", "[1,1,2,1]", "voxel_max", "400", "batch_size_test",
               "2"]


def test_driver_runs_on_the_cpu_and_prints_the_iou_table(capsys):
    rc = driver.main(["--config", os.path.join(CONFIGS,
                                               "s3dis_stratified.yaml"),
                      "--device", "cpu", "data_name", "synthetic",
                      "synthetic_points", "400", "synthetic_eval_scenes",
                      "1"] + NARROW_ARGS)
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("WARNING: no model_path given")
    assert out[1].startswith("Scene [1/1] synthetic_0: acc ")
    assert [line.split()[0] for line in out[2:15]] == [
        f"Class_{c:02d}" for c in range(13)]
    assert out[15].startswith("Val result: mIoU/mAcc/allAcc ")


def test_driver_reads_s3dis_rooms_and_a_checkpoint(tmp_path):
    from stratified_transformer_torch.train import checkpoint
    root = tmp_path / "rooms"
    root.mkdir()
    _write_rooms(root, n=300)
    yaml_cfg = merge_cfg_from_list(
        load_cfg(os.path.join(CONFIGS, "s3dis_stratified.yaml")),
        NARROW_ARGS + ["data_root", str(root)])
    model = build_model(driver.eval_config(yaml_cfg), "cpu", seed=3)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    path = checkpoint.save(str(tmp_path / "ckpt"), model, opt, 5, 2)
    yaml_cfg["model_path"] = path
    lines = []
    m = driver.run(yaml_cfg, "cpu", log=lines.append)
    assert lines[0] == f"loaded checkpoint from {path} (epoch 2)"
    assert [s["name"] for s in m["scenes"]] == [
        "Area_5_hallway_1", "Area_5_office_10", "Area_5_office_2"]
    assert 0.0 <= m["miou"] <= 1.0 and 0.0 <= m["all_acc"] <= 1.0
    assert lines[-1].startswith("Val result: mIoU/mAcc/allAcc ")


def test_driver_refuses_a_missing_checkpoint(tmp_path):
    """A mistyped ``model_path`` raises instead of evaluating random
    weights."""
    yaml_cfg = merge_cfg_from_list(
        load_cfg(os.path.join(CONFIGS, "s3dis_stratified.yaml")),
        NARROW_ARGS + ["data_name", "synthetic", "model_path",
                       str(tmp_path / "ckpt")])
    lines = []
    with pytest.raises(FileNotFoundError, match="ckpt"):
        driver.run(yaml_cfg, "cpu", log=lines.append)
    assert lines == []


def test_driver_refuses_what_the_port_does_not_run(monkeypatch):
    """A missing data_root is refused; sharded inference, once refused,
    runs (here on one CPU rank; ``test_torch_halo*.py`` hold it against
    JAX); DCF, once refused, is taken as ``test.py`` takes it: its YAML's
    model (with the offset head) and, for any data_name but s3dis and
    scannetv2, synthetic rooms of seed 999."""
    yaml_cfg = load_cfg(os.path.join(CONFIGS, "s3dis_stratified.yaml"))
    lines = []
    m = driver.run(merge_cfg_from_list(yaml_cfg, NARROW_ARGS + [
        "data_name", "synthetic", "synthetic_points", "300",
        "synthetic_eval_scenes", "1", "sharded", "True",
        "sharded_block_points", "512"]), "cpu", log=lines.append)
    assert lines[0].startswith("sharded eval: 1 devices, block_pad 512, ")
    assert m["sharded_stats"]["collective_chunks"] > 0
    assert lines[-1].startswith("Val result: mIoU/mAcc/allAcc ")
    dcf = driver.eval_config(load_cfg(os.path.join(
        CONFIGS, "dcf_stratified.yaml")))
    assert dcf.with_regressor and dcf.n_pad == 400000 and dcf.num_scenes == 5
    scenes = driver.scenes_of(dict(yaml_cfg, data_name="dcf",
                                   synthetic_points=500), 18)
    want = jax_datasets.SyntheticRooms(num_scenes=2, points=500,
                                       num_classes=18, seed=999)
    assert [s[0] for s in scenes] == ["synthetic_0", "synthetic_1"]
    for (_, c, f, l), i in zip(scenes, range(2)):
        wc, wf, wl, _ = want.raw_scene(i)
        np.testing.assert_array_equal(c, wc)
        np.testing.assert_array_equal(f, wf)
        np.testing.assert_array_equal(l, wl.astype(np.int64))
    for name in ("s3dis", "scannetv2"):
        with pytest.raises(ValueError, match=f"{name} needs data_root"):
            driver.scenes_of(dict(yaml_cfg, data_name=name), 13)
    # without --device cpu it needs the card: no fallback to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for sharded in (False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            driver.run(dict(yaml_cfg, data_name="synthetic",
                            sharded=sharded))
