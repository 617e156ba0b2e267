"""PyTorch port, the DCF family's evaluation against the JAX package and
scikit-learn: the port's DBSCAN against ``sklearn.cluster.DBSCAN``'s labels
(seeded cases and hypothesis), cuboid instantiation and merging, box mAP,
custom-scene preparation and the PLY helpers on fabricated cube scenes,
``test_iou.py``'s ``predict_scene`` with converted weights, and the
``iou_driver`` / ``layoutrm_driver`` entry points on the CPU."""

import os

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from scipy.spatial import distance
from sklearn.cluster import DBSCAN

import chip_smoke
import test_iou as jax_test_iou
from stratified_transformer_tpu.data import ply as jax_ply
from stratified_transformer_tpu.eval import box_map as jax_box_map
from stratified_transformer_tpu.eval import instantiation as jax_inst
from stratified_transformer_tpu.eval import scene_prep as jax_scene_prep
from stratified_transformer_tpu.models.stratified import (
    Stratified as JaxStratified, StratifiedConfig as JaxConfig)
from stratified_transformer_tpu.ops import attention as jax_attention
from stratified_transformer_torch.convert import from_flax
from stratified_transformer_torch.data import ply
from stratified_transformer_torch.data.datasets import DCF
from stratified_transformer_torch.eval import (
    box_map, instantiation, iou_driver, layoutrm_driver, scene_prep)
from stratified_transformer_torch.eval.dbscan import dbscan_labels
from stratified_transformer_torch.models.stratified import Stratified
from stratified_transformer_torch.utils.config import (
    load_cfg, merge_cfg_from_list)
from test_torch_model import _random_variables
from test_torch_whole_scene import jax_pyramid, literal_bins

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "dcf_stratified.yaml")


def sk_labels(x, eps, min_samples):
    return DBSCAN(eps=eps, min_samples=min_samples).fit(x).labels_


# ---- DBSCAN

def _border_between_two():
    """Two clusters of five points 0.3 apart and a border point 0.08 from
    one core point of each, listed between them: it joins the lower
    cluster, the one whose first core point comes first."""
    a = np.array([[0.0, 0, 0], [0.05, 0, 0], [0.0, 0.05, 0], [0.05, 0.05, 0],
                  [0.12, 0, 0]])
    b = a * [-1, 1, 1] + [0.4, 0, 0]
    return np.concatenate([b, [[0.2, 0, 0]], a]), 0.1, 4


def _exact_eps(side=4):
    """A dyadic lattice: distances of exactly eps, on both sides of every
    core decision, exact in sklearn's k-d tree (from 12 points) and in its
    brute-force form (fewer) alike."""
    g = np.stack(np.meshgrid(*[np.arange(side) * 0.25] * 3),
                 -1).reshape(-1, 3)[:max(side ** 3 - 56, side ** 3 // 2)]
    return g[np.random.default_rng(0).permutation(len(g))], 0.25, 3


DBSCAN_CASES = {
    "border_between_two_clusters": _border_between_two,
    "exactly_eps": _exact_eps,
    "exactly_eps_brute": lambda: _exact_eps(2),
    "noise_only": lambda: (np.random.default_rng(1).uniform(0, 10, (40, 3)),
                           0.1, 3),
    "fewer_than_min_samples": lambda: (np.zeros((3, 3)) + [[0], [0.01],
                                                           [0.02]], 0.1, 5),
    "duplicates": lambda: (np.repeat(np.random.default_rng(2).uniform(
        0, 1, (6, 3)), 4, axis=0), 0.05, 4),
    "one_point": lambda: (np.ones((1, 3)), 0.1, 1),
    "dense_room": lambda: (np.random.default_rng(3).uniform(0, 3, (5000, 3)),
                           0.2, 10),
}


@pytest.mark.parametrize("case", sorted(DBSCAN_CASES))
def test_dbscan_equals_sklearn(case):
    x, eps, min_samples = DBSCAN_CASES[case]()
    got = dbscan_labels(x, eps, min_samples)
    np.testing.assert_array_equal(got, sk_labels(x, eps, min_samples))
    if case == "border_between_two_clusters":
        assert got[5] == 0 and got.max() == 1
    if case in ("noise_only", "fewer_than_min_samples"):
        assert (got == -1).all()


def test_dbscan_of_nothing_is_empty():
    assert dbscan_labels(np.zeros((0, 3)), 0.1, 5).shape == (0,)


@settings(max_examples=150, deadline=None, database=None)
@given(n=st.integers(1, 60), grid=st.booleans(),
       eps_steps=st.integers(1, 6), min_samples=st.integers(1, 8),
       seed=st.integers(0, 2 ** 31 - 1))
def test_dbscan_equals_sklearn_by_hypothesis(n, grid, eps_steps, min_samples,
                                             seed):
    """Random clouds, half of them on a dyadic lattice whose distances hit
    eps exactly."""
    rng = np.random.default_rng(seed)
    if grid:
        x = rng.integers(0, 6, (n, 3)) * 0.125
        eps = eps_steps * 0.125
    else:
        x = rng.uniform(0, 1, (n, 3))
        eps = eps_steps * 0.07
    np.testing.assert_array_equal(dbscan_labels(x, eps, min_samples),
                                  sk_labels(x, eps, min_samples))


# ---- instantiation

def cube_prediction(seed, cubes=6, points=1500, extent=3.0, flip=0.02):
    """A fabricated cube scene (``chip_smoke.cube_scene``) and a stand-in
    prediction: offsets 0.8 of the targets plus 5 mm noise, a share
    ``flip`` of labels changed. Returns ``(coord, offsets, labels, boxes as
    corners)``."""
    rng = np.random.default_rng(seed)
    cubes = chip_smoke.cube_scene(rng, cubes, points, extent)
    coord = np.concatenate([np.vstack((c["f_samples"], c["e_samples"]))
                            for c in cubes])
    labels = np.concatenate([np.concatenate((c["f_labels"], c["e_labels"]))
                             for c in cubes])
    target = np.concatenate([np.vstack((c["f_offsets"], c["e_offsets"]))
                             for c in cubes])
    offsets = 0.8 * target + rng.normal(0, 0.005, target.shape)
    flipped = rng.random(len(labels)) < flip
    labels = np.where(flipped, rng.integers(0, 18, len(labels)), labels)
    boxes = np.stack([np.concatenate([c["centroid"] - c["lengths"] / 2,
                                      c["centroid"] + c["lengths"] / 2])
                      for c in cubes])
    return coord, offsets, labels, boxes


def assert_same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_instantiation_steps_equal_jax(seed):
    coord, off, lab, _ = cube_prediction(seed)
    cls_t, ids_t = instantiation.cluster_instances(coord, off, lab)
    cls_j, ids_j = jax_inst.cluster_instances(coord, off, lab)
    assert ids_t == ids_j and sum(map(len, ids_t)) > 6
    for a, b in zip(cls_t, cls_j):
        assert_same_arrays(a, b)
    pairs = instantiation.pair_edges_to_faces(cls_t, ids_t)
    assert pairs == jax_inst.pair_edges_to_faces(cls_j, ids_j) and pairs
    groups = instantiation.merge_pairs(pairs)
    assert groups == jax_inst.merge_pairs(pairs)
    objs = instantiation.instantiate(coord, off, lab)
    assert_same_arrays(objs, jax_inst.instantiate(coord, off, lab))
    assert len(objs) >= 3
    merged = instantiation.merge_instances(objs)
    assert_same_arrays(merged, jax_inst.merge_instances(objs))
    for o in merged:
        np.testing.assert_array_equal(instantiation.support_to_box(o),
                                      jax_inst.support_to_box(o))


def test_merge_instances_merges_as_jax():
    """Overlapping, touching supports: some merge, some do not."""
    rng = np.random.default_rng(4)
    base = rng.uniform(0, 1, (300, 3))
    parts = [base, base[:150] + [0.05, 0, 0], base + [3, 0, 0],
             base[:40] * 0.3 + [0.2, 0.2, 0.2], rng.uniform(5, 6, (30, 3))]
    got = instantiation.merge_instances(parts)
    want = jax_inst.merge_instances(parts)
    assert_same_arrays(got, want)
    assert len(got) < len(parts)


@pytest.mark.parametrize("seed", [0, 5])
def test_instance_eval_pseudo_equals_jax(seed):
    coord, off, lab, _ = cube_prediction(seed, cubes=3, points=600,
                                         flip=0.2)
    conf = np.random.default_rng(seed).random(len(lab))
    for got, want in zip(instantiation.instance_eval_pseudo(coord, off, lab,
                                                            conf),
                         jax_inst.instance_eval_pseudo(coord, off, lab,
                                                       conf)):
        np.testing.assert_array_equal(got, want)


def test_partial_iou_equals_jax():
    rng = np.random.default_rng(6)
    for _ in range(200):
        a = np.concatenate([rng.uniform(0, 2, 3), rng.uniform(0.1, 1, 3)])
        b = np.concatenate([rng.uniform(0, 2, 3), rng.uniform(0.1, 1, 3)])
        assert instantiation.compute_partial_iou(a, b) == \
            jax_inst.compute_partial_iou(a, b)


def test_thresholds_equal_cdist():
    """`nearest_below` and the outlier filter decide as JAX's ``cdist``
    comparisons do, at distances of exactly the threshold and at random
    ones."""
    rng = np.random.default_rng(7)
    lattice = rng.integers(0, 8, (400, 3)) * 0.04
    for q, r, radius in ((rng.uniform(0, 1, (500, 3)),
                          rng.uniform(0, 1, (700, 3)), 0.03),
                         (lattice[:200], lattice[200:] + 0.04, 0.08),
                         (lattice[:200] * 0.5, lattice[200:], 0.2)):
        want = np.min(distance.cdist(q, r), axis=1) < radius
        np.testing.assert_array_equal(
            instantiation.nearest_below(q, r, radius), want)
        got = instantiation._radius_outlier_filter(r, 3, radius)
        np.testing.assert_array_equal(
            got, jax_inst._radius_outlier_filter(r, 3, radius))


# ---- box mAP

def test_box_map_equals_jax():
    rng = np.random.default_rng(8)
    ours = box_map.DetectionMAP(0.5)
    theirs = jax_box_map.DetectionMAP(0.5)
    for scene in range(6):
        lo = rng.uniform(0, 3, (rng.integers(0, 6), 3))
        gt = np.concatenate([lo, lo + rng.uniform(0.2, 1, lo.shape)], 1)
        jitter = rng.normal(0, 0.1, gt.shape)
        pred = np.concatenate([gt + jitter, np.sort(rng.uniform(
            0, 3, (rng.integers(0, 3), 2, 3)), 1).reshape(-1, 6)])
        pred = pred[rng.permutation(len(pred))]
        iou = box_map.box_iou(pred, gt)
        np.testing.assert_array_equal(iou, jax_box_map.box_iou(pred, gt))
        assert box_map.match_boxes(iou, 0.25) == \
            jax_box_map.match_boxes(iou, 0.25)
        assert ours.evaluate(pred, gt) == theirs.evaluate(pred, gt)
    assert ours.pr_curve() == theirs.pr_curve()
    assert ours.ap() == theirs.ap() and ours.summary() == theirs.summary()
    assert 0 < ours.summary()["tp"] and 0 < ours.summary()["fp"]


# ---- custom scenes and PLY

def test_scene_prep_equals_jax(tmp_path):
    """A rotated 2 m room and a far cloud of 20 points that DBSCAN drops."""
    rng = np.random.default_rng(9)
    room = np.concatenate([rng.uniform(0, 2, (8000, 3)) @ np.array(
        [[0.8, 0.6, 0], [-0.6, 0.8, 0], [0, 0, 1]]),
        rng.uniform(20, 21, (20, 3))]).astype(np.float32)
    for got, want in zip(scene_prep.prepare_custom_scene(room),
                         jax_scene_prep.prepare_custom_scene(room)):
        np.testing.assert_array_equal(got, want)
    assert scene_prep.prepare_custom_scene(room)[2].sum() == 8000
    for got, want in zip(scene_prep.remove_outliers(room, 0.05, 10),
                         jax_scene_prep.remove_outliers(room, 0.05, 10)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(scene_prep.horizontal_obb_align(room),
                         jax_scene_prep.horizontal_obb_align(room)):
        np.testing.assert_array_equal(got, want)
    path = str(tmp_path / "room.obj")
    jax_ply.save_obj(path, room)
    for got, want in zip(scene_prep.prepare_custom_scene(path),
                         jax_scene_prep.prepare_custom_scene(path)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("binary", [True, False])
def test_ply_equals_jax(tmp_path, binary):
    rng = np.random.default_rng(10)
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    ply.write_ply_points(tmp_path / "a.ply", xyz, rgb, binary=binary)
    jax_ply.write_ply_points(tmp_path / "b.ply", xyz, rgb, binary=binary)
    assert (tmp_path / "a.ply").read_bytes() == \
        (tmp_path / "b.ply").read_bytes()
    got, want = ply.read_ply(tmp_path / "a.ply"), jax_ply.read_ply(
        tmp_path / "b.ply")
    np.testing.assert_array_equal(got["vertex"], want["vertex"])
    labels = rng.integers(0, 40, 50)
    ply.save_colored_by_label(tmp_path / "c.ply", xyz, labels)
    jax_ply.save_colored_by_label(tmp_path / "d.ply", xyz, labels)
    assert (tmp_path / "c.ply").read_bytes() == \
        (tmp_path / "d.ply").read_bytes()
    jax_ply.save_obj(tmp_path / "e.obj", xyz)
    np.testing.assert_array_equal(ply.load_obj_vertices(tmp_path / "e.obj"),
                                  jax_ply.load_obj_vertices(
                                      tmp_path / "e.obj"))


# ---- test_iou.py's prediction and the drivers

NARROW = ["channels", "[16,32,64,128]", "num_heads", "[1,2,4,8]", "depths",
          "[1,1,2,1]", "voxel_max", "500", "batch_size_test", "2",
          "rpe_precision", "highest", "qk_precision", "highest"]
# per-point means of logits and offsets over a point's crops, each crop's
# forward as test_torch_dcf's comparison (1e-3 / 1e-4); labels equal where
# the mean logits' top two differ by more than 1e-3
RTOL, ATOL, MARGIN = 1e-3, 1e-4, 1e-3


def test_predict_scene_equals_jax():
    """`iou_driver.predict_scene` with the port's model against
    ``test_iou.predict_scene`` with JAX's, the same random weights: JAX's
    forward fed its own on-device pyramid with the host member rule and the
    literal bin formula (`jax_pyramid`, `literal_bins`: test_torch_whole_
    scene's reasons)."""
    yaml_cfg = merge_cfg_from_list(load_cfg(CONFIG), NARROW)
    cfg = iou_driver.offset_config(yaml_cfg)
    assert cfg.n_pad == 1024 and cfg.num_scenes == 2 and cfg.with_regressor
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in (
        "num_classes", "in_channels", "channels", "depths", "num_heads",
        "num_layers", "n_pad", "num_scenes", "tile", "band", "band_per_stage",
        "sparse_cap", "s_band", "with_regressor")}, sampler="grid",
        attn_impl="reference", rpe_precision="highest", qk_precision="highest")
    jmodel = JaxStratified(jcfg)
    zeros = (np.zeros((cfg.n_pad, 6), np.float32),
             np.zeros((cfg.n_pad, 3), np.float32),
             np.array([1, 1], np.int32))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, *zeros, training=False))
    rng = np.random.default_rng(12)
    variables = {"params": _random_variables(shapes["params"], rng),
                 "batch_stats": _random_variables(shapes["batch_stats"], rng)}
    model = Stratified(cfg)
    model.load_state_dict(from_flax(variables["params"],
                                    variables["batch_stats"]), strict=True)
    model.eval()

    @jax.jit
    def jax_predict(feats, xyz, offsets):
        nidx, nmask, pyr = jax_pyramid(jcfg, xyz, offsets)
        return jmodel.apply(variables, feats, xyz, offsets, training=False,
                            stem_nidx=nidx, stem_nmask=nmask, pyramid=pyr)

    coord, _, _, _ = cube_prediction(3, cubes=2, points=700, extent=1.5)
    coord = coord.astype(np.float32)
    feat = np.ones((len(coord), 3), np.float32)
    predict = iou_driver.make_predict(model)
    got_calls, want_calls = [], []

    def recorded(fn, calls):
        def run(feats, xyz, offsets):
            out = tuple(np.asarray(t) for t in fn(feats, xyz, offsets))
            calls.append((int(offsets[-1]), out))
            return out
        return run

    args = (coord, feat, cfg.n_pad, 500, True, 2)
    labels, shift = iou_driver.predict_scene(recorded(predict, got_calls),
                                             *args)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_attention, "relative_position_index", literal_bins)
        want_labels, want_shift = jax_test_iou.predict_scene(
            recorded(jax_predict, want_calls), *args)
    # sphere crops, two per forward
    assert len(got_calls) == len(want_calls) >= 2
    assert max(n for n, _ in got_calls) > 500
    for (n, got), (_, want) in zip(got_calls, want_calls):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[:n], w[:n], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(shift, want_shift, rtol=RTOL, atol=ATOL)
    # labels equal wherever JAX's mean logits are not within MARGIN of a tie
    mean = np.zeros((len(coord), 18))
    count = np.zeros(len(coord))
    crops = iou_driver.sphere_cover_crops(coord, 500)
    for b, (_, (logits, _)) in enumerate(want_calls):
        pos = 0
        for idx in crops[2 * b:2 * b + 2]:
            mean[idx] += logits[pos:pos + len(idx)]
            count[idx] += 1
            pos += len(idx)
    top2 = np.sort(mean / count[:, None], -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > MARGIN
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(labels[clear], want_labels[clear])


def _write_test_cubes(root):
    return chip_smoke.write_cube_files(root, "test", 2, 0, cubes=2,
                                       points_per_cube=600, extent=1.5)


def test_iou_driver_scores_cube_files(tmp_path):
    """The driver on DCF test cubes at a narrow width: one record per file,
    boxes from their parameters, every forward's crops scored; a smoke
    run under another data_name draws test_iou.py's scenes."""
    paths = _write_test_cubes(str(tmp_path))
    yaml_cfg = merge_cfg_from_list(load_cfg(CONFIG), NARROW + [
        "data_root", str([str(tmp_path)])])
    lines = []
    summary = iou_driver.run(yaml_cfg, "cpu", log=lines.append)
    assert [r["name"] for r in summary["scenes"]] == paths
    assert summary["fn"] + summary["tp"] == 4        # two cubes per file
    assert lines[-1].startswith("Detection: ")
    scenes = list(iou_driver.iou_scenes(yaml_cfg))
    _, _, _, _, params = DCF.load_item(paths[0])
    c, size = params[:, :3], params[:, 3:]
    np.testing.assert_array_equal(scenes[0][3], np.concatenate(
        [c - size / 2, c + size / 2], 1))
    smoke = list(iou_driver.iou_scenes(dict(yaml_cfg, data_name="synthetic")))
    rng = np.random.default_rng(0)
    for name, coord, feat, boxes in smoke:
        np.testing.assert_array_equal(coord, rng.uniform(0, 4, (20000, 3)))
        rng.integers(0, 18, 20000)
        rng.normal(0, 0.05, (20000, 3))
        np.testing.assert_array_equal(boxes, np.sort(rng.uniform(
            0, 4, (3, 2, 3)), axis=1).reshape(3, 6))
    assert len(smoke) == 2


def test_iou_driver_refuses_a_dcf_run_without_data(tmp_path):
    with pytest.raises(ValueError, match="needs data_root"):
        list(iou_driver.iou_scenes(load_cfg(CONFIG)))


def test_layoutrm_driver_writes_both_clouds(tmp_path):
    """The smoke scene, cleaned and aligned, predicted: both ``.ply``
    files read back with the prepared scene's point count; ``.obj``
    scenes are read from ``custom_data_root``."""
    yaml_cfg = merge_cfg_from_list(load_cfg(CONFIG), NARROW + [
        "voxel_max", "8000", "result_path", str(tmp_path / "out")])
    [rec] = layoutrm_driver.run(yaml_cfg, "cpu", log=lambda _: None)
    prepared = scene_prep.prepare_custom_scene(np.random.default_rng(
        0).uniform(0, 3, (20000, 3)).astype(np.float32))[0]
    assert rec["points"] == len(prepared)
    for key in ("sem", "shift"):
        assert len(ply.read_ply(rec[key])["vertex"]) == rec["points"]
    sem = ply.read_ply(rec["sem"])["vertex"]
    np.testing.assert_array_equal(np.stack([sem["x"], sem["y"], sem["z"]],
                                           1), prepared)
    os.makedirs(tmp_path / "objs")
    jax_ply.save_obj(tmp_path / "objs" / "room_a.obj", prepared[:3000])
    names = [n for n, _ in layoutrm_driver.custom_scenes(
        dict(yaml_cfg, custom_data_root=str(tmp_path / "objs")))]
    assert names == ["room_a"]
