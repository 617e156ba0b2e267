"""PyTorch port, on-device samplers: farthest-point sampling, grid pooling
(with and without per-scene quotas) and blocked FPS against the JAX
package on the same numpy inputs, index outputs bit-identical; the segment
reductions and the sparse key table they rest on; and the stratified member
mask, which follows the host pyramid where the JAX package's scatter drops a
member."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratified_transformer_tpu.ops import sampling as jax_sampling
from stratified_transformer_tpu.ops import windows as jax_windows
from stratified_transformer_torch.config import StratifiedConfig
from stratified_transformer_torch.models.stratified import geometry_pyramid
from stratified_transformer_torch.ops import sampling, windows

torch.set_num_threads(1)


def _batch(seed, sizes, n_pad, extent=2.0):
    """Random points of scenes with ``sizes`` points each in ``n_pad``
    slots; their offsets and per-scene 1/4 targets."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, extent, (n_pad, 3)).astype(np.float32)
    offsets = np.cumsum(sizes).astype(np.int32)
    counts = np.asarray(sizes)
    new_offsets = np.cumsum(np.floor(counts * np.float32(0.25)).astype(
        np.int32) + 1).astype(np.int32)
    return xyz, offsets, new_offsets


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(jax_out, torch_out):
    for a, b in zip(jax_out, torch_out):
        a = np.asarray(a)
        assert b.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(bool): torch.bool}[a.dtype]
        np.testing.assert_array_equal(b.numpy(), a)


# the second case has an empty last scene, as the last batch of a scene's
# crops has when fewer than batch_size_test remain
CASES = [(0, (300, 200), 640), (1, (450, 0), 512), (2, (100, 260, 90), 512)]


@pytest.mark.parametrize("seed, sizes, n_pad", CASES)
def test_farthest_point_sampling_matches_jax(seed, sizes, n_pad):
    xyz, off, new_off = _batch(seed, sizes, n_pad)
    want = jax_sampling.farthest_point_sampling(
        jnp.asarray(xyz), jnp.asarray(off), jnp.asarray(new_off), 192)
    _same(want, sampling.farthest_point_sampling(_t(xyz), _t(off),
                                                 _t(new_off), 192))


@pytest.mark.parametrize("seed, sizes, n_pad", CASES)
def test_grid_pool_sampling_matches_jax(seed, sizes, n_pad):
    xyz, off, new_off = _batch(seed, sizes, n_pad)
    for cell in (0.15, 0.4):            # quota binds / cells run out
        want = jax_sampling.grid_pool_sampling(
            jnp.asarray(xyz), jnp.asarray(off), jnp.asarray(new_off), 192,
            cell)
        _same(want, sampling.grid_pool_sampling(_t(xyz), _t(off),
                                                _t(new_off), 192, cell))


@pytest.mark.parametrize("seed, sizes, n_pad", CASES)
def test_grid_pool_sampling_all_matches_jax(seed, sizes, n_pad):
    xyz, off, _ = _batch(seed, sizes, n_pad)
    for out_pad in (128, 512):          # capacity binds / every cell kept
        want = jax_sampling.grid_pool_sampling_all(
            jnp.asarray(xyz), jnp.asarray(off), out_pad, 0.3)
        _same(want, sampling.grid_pool_sampling_all(_t(xyz), _t(off),
                                                    out_pad, 0.3))


@pytest.mark.parametrize("seed, sizes, n_pad", CASES)
def test_blocked_fps_matches_jax(seed, sizes, n_pad):
    xyz, off, new_off = _batch(seed, sizes, n_pad)
    want = jax_sampling.blocked_fps(
        jnp.asarray(xyz), jnp.asarray(off), jnp.asarray(new_off), 192, 0.7,
        block_cap=32)
    _same(want, sampling.blocked_fps(_t(xyz), _t(off), _t(new_off), 192,
                                     0.7, block_cap=32))


@pytest.mark.parametrize("reduce, jax_fn", [
    ("sum", "segment_sum"), ("amin", "segment_min"), ("amax", "segment_max")])
def test_segment_reduce_matches_jax_segment_ops(reduce, jax_fn):
    import jax
    rng = np.random.default_rng(4)
    ids = rng.integers(-1, 7, 50).astype(np.int32)      # 5 segments: 5, 6
    ints = rng.integers(-9, 9, 50).astype(np.int32)     # and -1 dropped,
    floats = rng.normal(size=50).astype(np.float32)     # 4 left empty
    ids[ids == 4] = 3
    for vals in (ints, floats):
        want = getattr(jax.ops, jax_fn)(jnp.asarray(vals), jnp.asarray(ids),
                                        num_segments=5)
        got = sampling.segment_reduce(_t(vals), _t(ids), 5, reduce)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sparse_key_table_and_lookup_match_jax():
    rng = np.random.default_rng(6)
    key = rng.integers(0, 40, 300).astype(np.int32)
    member = rng.random(300) < 0.6
    want = jax_windows.sparse_key_table(jnp.asarray(key),
                                        jnp.asarray(member), 5)
    got = windows.sparse_key_table(_t(key), _t(member), 5)
    _same(want, got)
    query = rng.integers(-2, 45, 100).astype(np.int32)
    np.testing.assert_array_equal(
        windows.lookup_rows(got[1], _t(query)).numpy(),
        np.asarray(jax_windows.lookup_rows(want[1], jnp.asarray(query))))


def test_members_follow_the_host_pyramid_where_jax_drops_one():
    """The JAX package marks stage members by ``zeros.at[d_idx].set(
    d_valid)`` (``models/stratified.py:218``); its padding slots alias
    their scene's first point with False, and on the CPU the last write
    wins. A batch whose last scene starts at a cell centre: that point is
    a kept representative, JAX's scatter unmarks it, the port keeps it,
    as the host pyramid does (``is_down[d_idx[d_valid]] = True``)."""
    cfg = StratifiedConfig(n_pad=1024, num_scenes=2,
                           band_per_stage=(128, 128, 384, 192))
    xyz, off, _ = _batch(9, (400, 300), cfg.n_pad)
    xyz[1] = 0.0                        # the batch min: the grid's origin
    cell = np.float32(cfg.grid_sizes()[0] * float(cfg.downsample_scale)
                      ** 0.5)
    first = int(off[0])                 # the last scene's first point
    xyz[first] = (np.array([0, 5, 7], np.float32) + np.float32(0.5)) * cell

    n = cfg.n_pad
    counts = jnp.asarray(off) - jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.asarray(off)[:-1]])
    d_off = jax_sampling.counts_to_offsets(jax_sampling.floor_ratio_counts(
        counts, 1.0 / cfg.downsample_scale))
    d_idx, d_valid = jax_sampling.grid_pool_sampling(
        jnp.asarray(xyz), jnp.asarray(off), d_off,
        n // cfg.downsample_scale + cfg.num_scenes, float(cell))
    d_idx, d_valid = np.asarray(d_idx), np.asarray(d_valid)
    jax_is_down = np.asarray(
        jnp.zeros((n,), bool).at[d_idx].set(d_valid, mode="drop"))
    host_is_down = np.zeros(n, bool)
    host_is_down[d_idx[d_valid]] = True

    got = geometry_pyramid(cfg, _t(xyz), _t(off).long())
    is_down = got["stage_down"][0]["is_down"].numpy()
    np.testing.assert_array_equal(is_down, host_is_down)
    assert first in d_idx[d_valid] and is_down[first]
    assert not jax_is_down[first]
    # the only divergence: every other member agrees
    diff = np.flatnonzero(jax_is_down != is_down)
    np.testing.assert_array_equal(diff, [first])


def test_geometry_pyramid_samplers_follow_the_config():
    cfg = StratifiedConfig(n_pad=1024, num_scenes=2, depths=(1, 1, 1, 1),
                           band_per_stage=(128, 128, 384, 192))
    xyz, off, _ = _batch(3, (500, 400), cfg.n_pad, extent=4.0)
    base = geometry_pyramid(cfg, _t(xyz), _t(off).long())
    for sampler, quota in (("fps", "scene"), ("blocked_fps", "scene"),
                           ("grid", "cells")):
        other = geometry_pyramid(
            dataclasses.replace(cfg, sampler=sampler, down_quota=quota),
            _t(xyz), _t(off).long())
        lvl, ref = other["down"][0], base["down"][0]
        assert lvl["idx"].shape == ref["idx"].shape
        assert not torch.equal(lvl["idx"], ref["idx"])
        # every valid sample is a valid point of its own scene
        idx = lvl["idx"][lvl["valid"]]
        assert bool((idx < int(off[-1])).all())
        assert len(set(idx.tolist())) == len(idx)
