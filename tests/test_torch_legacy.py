"""The port's dense-batch compatibility ops (``ops/legacy.py``) and the
point-transformer ops ``subtraction`` / ``aggregation`` (``ops/
neighbors.py``) against the JAX package's, on the CPU at small sizes.

Integer outputs must equal JAX's except in a query row where the float64
distances leave room for rounding: a reference within 4 float32 ulps of
``radius**2``, or two distinct candidates within 4 ulps of each other
among the nearest ones (XLA on the CPU may contract the squared-distance
sum into an FMA). Each test reports the rows it excused and allows few.
Float outputs: rtol 1e-6 (``aggregation``'s sums also atol 1e-6);
gradients against ``jax.vjp``: rtol 1e-5 / atol 1e-6 (the scatter sums
run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratified_transformer_torch.ops import legacy
from stratified_transformer_torch.ops import neighbors
from stratified_transformer_tpu.ops import legacy as jax_legacy
from stratified_transformer_tpu.ops import neighbors as jax_neighbors

ULPS = 4
# the share of query rows a test may excuse
MAX_EXCUSED = 0.05
RADII = (0.2, 0.35)


def clouds(b=2, n=300, m=64, seed=0):
    """``new_xyz [b, m, 3]``, ``xyz [b, n, 3]`` in the unit cube; a few
    references repeat others (equal distances) and the first query of
    each scene is a reference (distance 0)."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    xyz[:, 10] = xyz[:, 20]
    xyz[:, 50] = xyz[:, 7]
    new_xyz = rng.uniform(0, 1, (b, m, 3)).astype(np.float32)
    new_xyz[:, 0] = xyz[:, 3]
    return new_xyz, xyz


def t(x):
    return torch.from_numpy(np.asarray(x))


def sqdist64(new_xyz, xyz):
    return ((new_xyz[:, :, None].astype(np.float64)
             - xyz[:, None].astype(np.float64)) ** 2).sum(-1)


def near_radius(new_xyz, xyz, radius):
    """``[b, m]``: a reference's distance within ULPS of the comparand."""
    r2 = np.float32(radius * radius)
    d = sqdist64(new_xyz, xyz)
    return (np.abs(d - r2) <= ULPS * np.spacing(r2)).any(-1)


def near_tie(new_xyz, xyz, k):
    """``[b, m]``: two distinct references among the ``k + 1`` nearest
    within ULPS of each other (identical points tie in every
    implementation, and the lower index must win)."""
    d = sqdist64(new_xyz, xyz)
    order = np.argsort(d, -1, kind="stable")[..., :k + 1]
    ds = np.take_along_axis(d, order, -1)
    pts = np.take_along_axis(xyz[:, None], order[..., None], 2)
    close = (ds[..., 1:] - ds[..., :-1]
             <= ULPS * np.spacing(ds[..., 1:].astype(np.float32)))
    distinct = (pts[..., 1:, :] != pts[..., :-1, :]).any(-1)
    return (close & distinct).any(-1)


def assert_rows_equal(label, got, want, excused):
    """``got`` equals ``want`` in every ``[b, m]`` row not ``excused``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        label, got.shape, want.shape, got.dtype, want.dtype)
    axes = tuple(range(2, got.ndim))
    differ = (got != want).any(axes) if axes else got != want
    bad = differ & ~excused
    assert not bad.any(), (
        f"{label}: {int(bad.sum())} rows differ from JAX "
        f"(first {np.argwhere(bad)[:3].tolist()})")
    assert excused.mean() <= MAX_EXCUSED, (label, excused.mean())
    print(f"{label}: {int(excused.sum())} of {excused.size} rows excused, "
          f"{int(differ.sum())} differ")


@pytest.mark.parametrize("radius", RADII)
def test_ball_query_dense_matches_jax(radius):
    new_xyz, xyz = clouds()
    want = jax_legacy.ball_query_dense(new_xyz, xyz, radius, 16)
    got = legacy.ball_query_dense(t(new_xyz), t(xyz), radius, 16)
    excused = near_radius(new_xyz, xyz, radius)
    assert_rows_equal("idx", got[0].numpy(), want[0], excused)
    assert_rows_equal("cnt", got[1].numpy(), want[1], excused)
    assert (got[1].numpy() == 16).any() and (got[1].numpy() < 16).any()


def test_ball_query_compares_with_the_square_of_the_python_radius():
    """A point at float32 0.35 along x lies at float32(0.35) ** 2 =
    0.122499995, below float32(0.35 * 0.35) = 0.1225: the JAX op (and
    the port) count it; float32(radius) squared in float32 would not."""
    q = np.zeros((1, 1, 3), np.float32)
    xyz = np.array([[[0.35, 0, 0], [0.5, 0, 0]]], np.float32)
    want = jax_legacy.ball_query_dense(q, xyz, 0.35, 2)
    got = legacy.ball_query_dense(t(q), t(xyz), 0.35, 2)
    assert np.asarray(want[1]).tolist() == [[1]]
    assert got[1].tolist() == [[1]] and got[0].tolist() == [[[0, 0]]]


def test_no_hit_rows_are_zero():
    q = np.full((1, 2, 3), 5.0, np.float32)
    q[0, 1] = 0.0
    xyz = np.zeros((1, 4, 3), np.float32)
    xyz[0, :2] = 9.0
    idx, cnt = legacy.ball_query_dense(t(q), t(xyz), 0.1, 3)
    assert idx.tolist() == [[[0, 0, 0], [2, 3, 2]]]
    assert cnt.tolist() == [[0, 2]]


@pytest.mark.parametrize("radius", RADII)
def test_labelstat_ops_match_jax(radius):
    new_xyz, xyz = clouds(seed=2)
    rng = np.random.default_rng(3)
    stat = rng.integers(0, 3, xyz.shape[:2] + (13,)).astype(np.int32)
    excused = near_radius(new_xyz, xyz, radius)

    want = jax_legacy.labelstat_ballrange(new_xyz, xyz, stat, radius)
    got = legacy.labelstat_ballrange(t(new_xyz), t(xyz), t(stat), radius)
    assert_rows_equal("ballrange", got.numpy(), want, excused)

    w_idx, w_stat = jax_legacy.labelstat_and_ballquery(
        new_xyz, xyz, stat, radius, 8)
    g_idx, g_stat = legacy.labelstat_and_ballquery(
        t(new_xyz), t(xyz), t(stat), radius, 8)
    assert_rows_equal("and_ballquery idx", g_idx.numpy(), w_idx, excused)
    assert_rows_equal("and_ballquery stat", g_stat.numpy(), w_stat,
                      excused)

    idx = rng.integers(0, xyz.shape[1], (2, 64, 5)).astype(np.int32)
    idx[:, :, 1] = idx[:, :, 0]                 # duplicates count twice
    np.testing.assert_array_equal(
        legacy.labelstat_idx(t(stat), t(idx)).numpy(),
        np.asarray(jax_legacy.labelstat_idx(stat, idx)))


def test_feature_distribute_matches_jax():
    new_xyz, xyz = clouds(seed=4)
    want = jax_legacy.feature_distribute(xyz, new_xyz)
    got = legacy.feature_distribute(t(xyz), t(new_xyz))
    assert got.dtype == torch.int32
    assert_rows_equal("distribute", got.numpy(), want,
                      near_tie(new_xyz, xyz, 1))


@pytest.mark.parametrize("k", [1, 16])
def test_knn_dense_matches_jax(k):
    new_xyz, xyz = clouds(seed=5)
    new_xyz[:, 1] = (xyz[:, 10] + xyz[:, 20]) / 2   # equidistant duplicates
    w_idx, w_d = jax_legacy.knn_dense(new_xyz, xyz, k)
    g_idx, g_d = legacy.knn_dense(t(new_xyz), t(xyz), k)
    excused = near_tie(new_xyz, xyz, k)
    assert_rows_equal("knn idx", g_idx.numpy(), w_idx, excused)
    np.testing.assert_allclose(g_d.numpy(), np.asarray(w_d), rtol=1e-6)
    assert g_idx[:, 0, 0].tolist() == [3, 3]    # the query's own point


def test_dense_ops_do_not_depend_on_the_slicing(monkeypatch):
    new_xyz, xyz = clouds(seed=6)
    stat = np.random.default_rng(0).integers(
        0, 3, xyz.shape[:2] + (13,)).astype(np.int32)
    args = (t(new_xyz), t(xyz))

    def run():
        return [*legacy.ball_query_dense(*args, 0.2, 16),
                legacy.labelstat_ballrange(*args, t(stat), 0.2),
                legacy.feature_distribute(args[1], args[0]),
                *legacy.knn_dense(*args, 8)]

    whole = run()
    monkeypatch.setattr(legacy, "CHUNK_ELEMENTS", 2 * 300 * 7)
    assert len(legacy._row_slices(64, 2, 300)) == 10
    for a, b in zip(run(), whole):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [np.float32, np.int64])
def test_gathering_and_grouping_match_jax(dtype):
    """int64 features stay int64 (``grouping_int``); JAX without x64 holds
    them as int32."""
    rng = np.random.default_rng(7)
    feats = (rng.standard_normal((2, 12, 50)) * 10).astype(dtype)
    idx = rng.integers(0, 50, (2, 9, 4)).astype(np.int32)
    got = legacy.grouping_dense(t(feats), t(idx))
    want = np.asarray(jax_legacy.grouping_dense(feats, idx))
    assert got.numpy().dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        legacy.gathering(t(feats), t(idx[:, :, 0])).numpy(),
        np.asarray(jax_legacy.gathering(feats, idx[:, :, 0])))


def test_feature_gather_and_its_gradient_match_jax():
    rng = np.random.default_rng(8)
    feat = rng.standard_normal((2, 12, 20)).astype(np.float32)
    idx = rng.integers(0, 20, (2, 70)).astype(np.int32)
    g = rng.standard_normal((2, 12, 70)).astype(np.float32)
    want, vjp = jax.vjp(lambda f: jax_legacy.feature_gather(f, idx), feat)
    x = t(feat).requires_grad_()
    got = legacy.feature_gather(x, t(idx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6)
    (grad,) = torch.autograd.grad(got, x, t(g))
    np.testing.assert_allclose(grad.numpy(), np.asarray(vjp(g)[0]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scale", [None, 8])
def test_divide2patch_matches_jax(scale):
    rng = np.random.default_rng(9)
    xyz = rng.uniform(0, 2, (640, 3)).astype(np.float32)
    offsets = np.array([260, 600], np.int32)    # 40 padding rows
    want = jax_legacy.divide2patch(16, jnp.asarray(xyz),
                                   jnp.asarray(offsets), 128,
                                   anchor_scale=scale, return_offset=True)
    got = legacy.divide2patch(16, t(xyz), t(offsets), 128,
                              anchor_scale=scale, return_offset=True)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    two = legacy.divide2patch(16, t(xyz), t(offsets), 128,
                              anchor_scale=scale)
    assert len(two) == 2 and torch.equal(two[0], got[0])


def point_transformer_inputs(masked, seed=10, n=90, k=8, c=12, w_c=3):
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal((n, c)).astype(np.float32)
    x2 = rng.standard_normal((n, c)).astype(np.float32)
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    idx[:, 1] = idx[:, 0]                       # repeated neighbours
    pos = rng.standard_normal((n, k, c)).astype(np.float32)
    w = rng.standard_normal((n, k, w_c)).astype(np.float32)
    mask = rng.uniform(size=(n, k)) < 0.8 if masked else None
    return x1, x2, idx, pos, w, mask


@pytest.mark.parametrize("masked", [False, True])
def test_subtraction_matches_jax(masked):
    x1, x2, idx, _, _, mask = point_transformer_inputs(masked)
    tm = None if mask is None else t(mask)
    want, vjp = jax.vjp(
        lambda a, b: jax_neighbors.subtraction(a, b, idx, mask), x1, x2)
    a, b = t(x1).requires_grad_(), t(x2).requires_grad_()
    got = neighbors.subtraction(a, b, t(idx), tm)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6)
    g = np.random.default_rng(11).standard_normal(got.shape).astype(
        np.float32)
    for gt, wt in zip(torch.autograd.grad(got, (a, b), t(g)), vjp(g)):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_aggregation_matches_jax(masked):
    x1, _, idx, pos, w, mask = point_transformer_inputs(masked)
    tm = None if mask is None else t(mask)
    want, vjp = jax.vjp(
        lambda f, p, ww: jax_neighbors.aggregation(f, p, ww, idx, mask),
        x1, pos, w)
    ins = [t(v).requires_grad_() for v in (x1, pos, w)]
    got = neighbors.aggregation(*ins, t(idx), tm)
    # a sum over k products, which XLA fuses into its reduction: within
    # 1e-6 absolute (about 2 ulps at |x| ~ 5) where the sum cancels
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    g = np.random.default_rng(12).standard_normal(got.shape).astype(
        np.float32)
    for gt, wt in zip(torch.autograd.grad(got, ins, t(g)), vjp(g)):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-5,
                                   atol=1e-6)


def test_aggregation_weight_channel_groups():
    """Weight channel ``c % w_c`` scales feature channel ``c``."""
    feats = torch.ones(1, 6)
    pos = torch.zeros(1, 1, 6)
    w = torch.tensor([[[1.0, 2.0, 3.0]]])
    out = neighbors.aggregation(feats, pos, w, torch.zeros(1, 1,
                                                           dtype=torch.int32))
    assert out.tolist() == [[1.0, 2.0, 3.0, 1.0, 2.0, 3.0]]
    with pytest.raises(ValueError):
        neighbors.aggregation(feats, pos, torch.ones(1, 1, 4),
                              torch.zeros(1, 1, dtype=torch.int32))
