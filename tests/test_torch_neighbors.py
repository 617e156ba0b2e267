"""PyTorch port, on-device neighbour search: brute `knn`, the `grid_knn`
cell list (chunked and whole, with query masks, capped cells, a radius),
`radius_neighbors` and the interpolations against the JAX package on the
same numpy inputs. Index lists and masks are bit-identical; distances and
interpolated features agree within rtol 2e-4 / atol 2e-5 (the JAX suite's
tolerance between its own paths, ``tests/test_pallas_attention.py:63-64``:
XLA may contract the squared sums into fused multiply-adds)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratified_transformer_tpu.ops import neighbors as jax_nb
from stratified_transformer_torch.ops import neighbors

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


def _scene(seed, m=300, n=700, scenes=2, extent=2.0):
    """Queries and refs of ``scenes`` scenes; refs past 90% are padding."""
    rng = np.random.default_rng(seed)
    qxyz = rng.uniform(0, extent, (m, 3)).astype(np.float32)
    rxyz = rng.uniform(0, extent, (n, 3)).astype(np.float32)
    qb = np.sort(rng.integers(0, scenes, m)).astype(np.int32)
    rb = np.sort(rng.integers(0, scenes, n)).astype(np.int32)
    rvalid = np.arange(n) < int(n * 0.9)
    qvalid = rng.random(m) < 0.85
    return qxyz, qb, rxyz, rb, rvalid, qvalid


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def assert_same_knn(want, got):
    idx, dist, mask = (np.asarray(a) for a in want)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool
    np.testing.assert_array_equal(got[0].numpy(), idx)
    np.testing.assert_array_equal(got[2].numpy(), mask)
    np.testing.assert_allclose(got[1].numpy(), dist, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("chunk", [64, 512])
def test_knn_matches_jax(chunk):
    q, qb, r, rb, rv, qv = _scene(0)
    want = jax_nb.knn(*_j(q, qb, r, rb, rv), 8, query_valid=jnp.asarray(qv),
                      chunk=chunk)
    got = neighbors.knn(_t(q), _t(qb), _t(r), _t(rb), _t(rv), 8,
                        query_valid=_t(qv), chunk=chunk)
    assert_same_knn(want, got)


@pytest.mark.parametrize("k, cap, cell, radius", [
    (8, 16, 0.3, None), (16, 4, 0.25, None), (12, 32, 0.2, 0.2),
    (30, 1, 0.3, None)])             # 27 cells x cap 1 < k: padded slots
def test_grid_knn_matches_jax_chunked_and_whole(k, cap, cell, radius):
    q, qb, r, rb, rv, qv = _scene(1)
    kw = dict(cell=cell, cap=cap, radius=radius)
    outs = []
    for chunk in (None, 128):
        want = jax_nb.grid_knn(*_j(q, qb, r, rb, rv), k,
                               query_valid=jnp.asarray(qv), chunk=chunk, **kw)
        got = neighbors.grid_knn(_t(q), _t(qb), _t(r), _t(rb), _t(rv), k,
                                 query_valid=_t(qv), chunk=chunk, **kw)
        assert_same_knn(want, got)
        outs.append(got)
    # the port's slices do not change a bit of the result
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_grid_knn_refuses_the_approximate_selector():
    q, qb, r, rb, rv, _ = _scene(2, m=10, n=20)
    with pytest.raises(ValueError, match="approx"):
        neighbors.grid_knn(_t(q), _t(qb), _t(r), _t(rb), _t(rv), 4, cell=0.3,
                           selector="approx")


@pytest.mark.parametrize("method", ["grid", "brute"])
def test_radius_neighbors_match_jax(method):
    _, _, r, rb, rv, _ = _scene(3, n=800)
    kw = dict(method=method, chunk=256, grid_chunk=256)
    want = jax_nb.radius_neighbors(*_j(r, rb, r, rb, rv), 0.15, 10, **kw)
    got = neighbors.radius_neighbors(_t(r), _t(rb), _t(r), _t(rb), _t(rv),
                                     0.15, 10, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert 0 < int(got[1].sum()) < got[1].numel()    # the radius cuts


@pytest.mark.parametrize("method", ["grid", "brute"])
def test_three_nn_interpolate_matches_jax(method):
    q, qb, r, rb, rv, qv = _scene(4)
    feats = np.random.default_rng(4).normal(size=(len(r), 5)).astype(
        np.float32)
    kw = dict(method=method, cell=0.4, cap=16, grid_chunk=100)
    want = jax_nb.three_nn_interpolate(*_j(q, qb, r, rb, rv, feats),
                                       query_valid=jnp.asarray(qv), **kw)
    got = neighbors.three_nn_interpolate(
        _t(q), _t(qb), _t(r), _t(rb), _t(rv), _t(feats), query_valid=_t(qv),
        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_interpolate_from_idx_and_gather_group_match_jax():
    q, qb, r, rb, rv, qv = _scene(5)
    feats = np.random.default_rng(5).normal(size=(len(r), 4)).astype(
        np.float32)
    idx, _, mask = jax_nb.knn(*_j(q, qb, r, rb, rv), 3,
                              query_valid=jnp.asarray(qv))
    idx, mask = np.asarray(idx), np.asarray(mask)
    want = jax_nb.interpolate_from_idx(*_j(q, r, feats, idx, mask))
    got = neighbors.interpolate_from_idx(_t(q), _t(r), _t(feats),
                                         _t(idx).long(), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    want = jax_nb.gather_group(*_j(feats, idx, mask), fill=-jnp.inf)
    got = neighbors.gather_group(_t(feats), _t(idx).long(), _t(mask),
                                 fill=-float("inf"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_smallest_k_sends_ties_to_the_lower_position():
    d = torch.tensor([[2.0, 1.0, 1.0, 0.0, 1.0, 0.0],
                      [1e10, 1e10, 3.0, 1e10, 3.0, 1e10]])
    pos, val = neighbors._smallest_k(d, 4)
    assert pos.tolist() == [[3, 5, 1, 2], [2, 4, 0, 1]]
    assert val.tolist() == [[0.0, 0.0, 1.0, 1.0], [3.0, 3.0, 1e10, 1e10]]
