"""PyTorch port, sharded whole-scene inference (the JAX package's
``parallel/halo.py``, ``eval/voting.py::evaluate_scene_sharded`` and
``test.py``'s ``sharded*`` keys) against the JAX package on the CPU: the
partition (`receptive_halo`, `slab_edges`, `partition_scene`) and the keys'
rounding on the same numpy inputs; the truncation audit's counters on an
anchored batch; two of the three JAX behaviours the port does not mirror
(the empty slab's placeholder core point, the fallback on any ValueError),
each beside JAX's; and the eval driver on two gloo ranks.
``test_torch_halo_model.py`` holds the model's grid anchor and
`evaluate_scene_sharded` (with the third, the halo-cap overflow), and
``test_torch_halo_paths.py`` the sharded paths on the corridor of
``tests/test_halo.py``; both use this file's helpers.

Ranks are spawned processes (``tests/torch_halo_worker.py``), each spawn
joined within JOIN_TIMEOUT_S. JAX's forward runs with the host pyramid's
member rule and anchored samplers (`jax_pyramid_anchored`): its on-device
member scatter drops members (ROADMAP §3), which the port does not mirror.
Its cRPE bins are the literal formula (`literal_bins`), as in
``test_torch_whole_scene.py``.
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train as jax_train
from stratified_transformer_tpu.eval import voting as jax_voting
from stratified_transformer_tpu.models.stratified import (
    Stratified as JaxStratified, StratifiedConfig as JaxConfig)
from stratified_transformer_tpu.ops import attention as jax_attention
from stratified_transformer_tpu.ops import neighbors as jax_nb
from stratified_transformer_tpu.ops import sampling as jax_sampling
from stratified_transformer_tpu.ops.plan import (
    build_attention_plan as jax_plan)
from stratified_transformer_tpu.parallel import halo as jax_halo
from stratified_transformer_tpu.parallel.mesh import make_mesh
from stratified_transformer_tpu.train import audit as jax_audit
from stratified_transformer_torch.config import (
    StratifiedConfig, from_cfg, sharded_from_cfg)
from stratified_transformer_torch.convert import from_flax
from stratified_transformer_torch.data import loader
from stratified_transformer_torch.eval import driver, voting
from stratified_transformer_torch.models.stratified import geometry_pyramid
from stratified_transformer_torch.parallel import halo, mesh
from stratified_transformer_torch.train import audit
from stratified_transformer_torch.utils.config import (
    load_cfg, merge_cfg_from_list)
from test_torch_model import NARROW, _random_variables
from test_torch_scannet import NARROW as SCANNET_NARROW, ROOMS
from test_torch_whole_scene import literal_bins

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_halo_worker.py")
CONFIGS = os.path.join(ROOT, "configs")
JOIN_TIMEOUT_S = 300
# floats against the JAX package (one forward, fp32 sums in another
# order, as test_torch_whole_scene's no-pyramid comparison)
RTOL, ATOL = 2e-4, 2e-5
# a block's forward against the whole scene's, where the halo covers the
# receptive field: fp32 reassociation across pad shapes, the JAX test's
# bound (tests/test_halo.py:178,231,266)
EXACT = 5e-7
# the port's stand-in and JAX's: a mean over a grid cell, sums in another
# order
STANDIN_ATOL = 1e-6
ANCHORS = {"zero": None, "offset": (0.137, 0.291, 0.073)}


# ---- spawned ranks ----------------------------------------------------------

def run_ranks(job, world, tmp_path):
    """Run ``job`` on ``world`` worker ranks; returns rank 0's records after
    checking that every rank's are the same."""
    path = tmp_path / "job.pt"
    torch.save(job, path)
    port = mesh.free_port()
    procs = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.log", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(path), str(r), str(world),
                 str(port), str(tmp_path)], stdout=out,
                stderr=subprocess.STDOUT, cwd=ROOT))
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
        assert p.returncode == 0, (f"rank {r} failed:\n"
                                   + (tmp_path / f"rank{r}.log").read_text())
    results = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
               for r in range(world)]
    for r, res in enumerate(results[1:], 1):
        for a, b in zip(results[0], res):
            assert a.keys() == b.keys()
            for key in a:
                if isinstance(a[key], np.ndarray):
                    np.testing.assert_array_equal(a[key], b[key])
                elif key != "log":          # only rank 0 logs
                    assert a[key] == b[key], (r, key)
    return results[0]


# ---- the partition and the keys ---------------------------------------------

@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(CONFIGS) if f.endswith(".yaml")))
def test_receptive_halo_matches_jax(name):
    cfg = load_cfg(os.path.join(CONFIGS, name))
    got = halo.receptive_halo(from_cfg(cfg))
    assert got == jax_halo.receptive_halo(jax_train.build_model_config(cfg,
                                                                       1))
    assert got > 0


def _scenes():
    rng = np.random.default_rng(7)
    uniform = rng.uniform(0, [8, 3, 2], (3000, 3)).astype(np.float32)
    # half the points on one plane x = 5: quantile edges coincide and a
    # slab is empty; duplicate points too
    dup = uniform.copy()
    dup[: 1500, 0] = 5.0
    dup[1500:1600] = dup[1400:1500]
    return {"uniform": uniform, "duplicates": dup}


@pytest.mark.parametrize("scene", ["uniform", "duplicates"])
def test_partition_matches_jax(scene):
    coord = _scenes()[scene]
    empty = 0
    for n_blocks in (1, 2, 3, 4, 7):
        axis, qs = halo.slab_edges(coord, n_blocks)
        want_axis, want_qs = jax_halo.slab_edges(coord, n_blocks)
        assert axis == want_axis
        np.testing.assert_array_equal(qs, want_qs)
        assert halo.exchange_mode(qs, 0.5) == (
            "ppermute" if n_blocks <= 2 or 0.5 <= np.diff(qs)[1:-1].min()
            else "allgather")
        for h in (0.0, 0.3, 2.5, 1e9):
            got = halo.partition_scene(coord, n_blocks, h)
            want = jax_halo.partition_scene(coord, n_blocks, h)
            assert len(got) == len(want) == n_blocks
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for key in w:
                    assert g[key].dtype == w[key].dtype
                    np.testing.assert_array_equal(g[key], w[key])
            empty += sum(not b["core"].any() for b in got)
    assert (empty > 0) == (scene == "duplicates")


def _test_py_keys(cfg, tile):
    """``test.py:92-157``'s arithmetic, copied: (block_pad, core_pad,
    halo_cap), the last two 0 without the exchange."""
    voxel_max = cfg.get("voxel_max", 80000)
    block_pad = int(cfg.get("sharded_block_points", voxel_max or 80000))
    block_pad = (block_pad + tile - 1) // tile * tile
    core_pad = halo_cap = 0
    if bool(cfg.get("sharded_collective", True)):
        core_pad = int(cfg.get("sharded_core_points", block_pad))
        core_pad = (core_pad + tile - 1) // tile * tile
        halo_cap = int(cfg.get("sharded_halo_points", core_pad // 2))
        halo_cap = max((halo_cap + tile - 1) // tile * tile, tile)
    return block_pad, core_pad, halo_cap


@pytest.mark.parametrize("keys", [
    {}, {"voxel_max": None}, {"voxel_max": 300001},
    {"sharded_block_points": 1000, "sharded_core_points": 129},
    {"sharded_core_points": 70, "sharded_halo_points": 1},
    {"sharded_halo_points": 0, "sharded_devices": 3, "sharded_halo": 2.5},
    {"sharded_collective": False, "sharded_down_quota": "scene"}])
def test_sharded_keys_round_as_test_py(keys):
    base = load_cfg(os.path.join(CONFIGS, "s3dis_stratified.yaml"))
    cfg = dict(base, **keys)
    for tile in (128, 96):
        s = sharded_from_cfg(cfg, tile)
        assert (s.block_pad, s.core_pad, s.halo_cap) == _test_py_keys(cfg,
                                                                      tile)
        assert s.devices == int(cfg.get("sharded_devices", 0))
        assert s.halo == float(cfg.get("sharded_halo", 0.0))
        assert s.down_quota == str(cfg.get("sharded_down_quota", "cells"))
        assert s.collective == bool(cfg.get("sharded_collective", True))
    bcfg, s, width = driver.sharded_config(cfg)
    assert (bcfg.n_pad, bcfg.num_scenes, bcfg.down_quota) == (
        s.block_pad, 1, s.down_quota)
    assert width == (s.halo or halo.receptive_halo(bcfg))


# ---- the model's grid anchor ------------------------------------------------

def jax_pyramid_anchored(jcfg, xyz, offsets, anchor):
    """The JAX package's on-device stem neighbours and geometry pyramid
    with every sampler and cell list anchored at ``anchor``
    (``models/stratified.py:298-307``, ``models/layers.py:163-247`` with
    ``origin=anchor``; the grid sampler with the config's quota), but the
    host pyramid's member rule (``is_down[d_idx[d_valid]] = True``) in
    place of the scatter that drops members (``models/stratified.py:
    218``)."""
    n = xyz.shape[0]
    batch = jax_sampling.offsets_to_batch(offsets, n)
    valid = jax_sampling.offsets_to_valid(offsets, n)
    nidx, nmask = jax_nb.radius_neighbors(
        xyz, batch, xyz, batch, valid, 2.5 * jcfg.grid_size * jcfg.sigma,
        jcfg.max_num_neighbors, chunk=jcfg.knn_chunk, method="grid",
        cap=jcfg.neighbor_cap, grid_chunk=jcfg.grid_knn_chunk, origin=anchor)

    def sample(x, off, new_off, out_pad, cell):
        if jcfg.down_quota == "cells":
            return jax_sampling.grid_pool_sampling_all(x, off, out_pad, cell,
                                                       origin=anchor)
        idx, ok = jax_sampling.grid_pool_sampling(x, off, new_off, out_pad,
                                                  cell, origin=anchor)
        return idx, ok, new_off

    gs = jcfg.grid_sizes()
    levels, down, stage_down = [(xyz, offsets)], [], []
    for i in range(jcfg.num_layers):
        x, off = levels[-1]
        m = x.shape[0]
        counts = off - jnp.concatenate([jnp.zeros((1,), off.dtype), off[:-1]])
        if i >= jcfg.layer_start and jcfg.use_stratified:
            d_off = jax_sampling.counts_to_offsets(
                jax_sampling.floor_ratio_counts(
                    counts, 1.0 / jcfg.downsample_scale))
            d_idx, d_valid, _ = sample(
                x, off, d_off, m // jcfg.downsample_scale + jcfg.num_scenes,
                gs[i] * float(jcfg.downsample_scale) ** 0.5)
            stage_down.append({"is_down": jnp.zeros((m + 1,), bool).at[
                jnp.where(d_valid, d_idx, m)].set(True)[:m]})
        if i == jcfg.num_layers - 1:
            break
        out_pad = -(-(int(m * jcfg.ratio) + jcfg.num_scenes) // jcfg.tile
                    ) * jcfg.tile
        new_off = jax_sampling.counts_to_offsets(
            jax_sampling.floor_ratio_counts(counts, jcfg.ratio))
        idx, ok, new_off = sample(x, off, new_off, out_pad, gs[i] * 2.0)
        knn_idx, _, knn_mask = jax_nb.grid_knn(
            x[idx], jax_sampling.offsets_to_batch(new_off, out_pad), x,
            jax_sampling.offsets_to_batch(off, m),
            jax_sampling.offsets_to_valid(off, m), jcfg.k,
            cell=gs[i] * 3.0, cap=jcfg.neighbor_cap, query_valid=ok,
            chunk=jcfg.grid_knn_chunk, origin=anchor)
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
            cell=gs[j - 1] * 6.0, cap=jcfg.neighbor_cap,
            query_valid=jax_sampling.offsets_to_valid(foff, nf),
            chunk=jcfg.grid_knn_chunk, origin=anchor)
        up.append({"idx": idx, "mask": mask})
    return nidx, nmask, {"down": down, "up": up, "stage_down": stage_down}


def jax_probs_fn(jcfg, variables):
    """``(feats, xyz, offsets) -> softmax`` of the JAX model anchored at
    the origin, over `jax_pyramid_anchored`: `parallel.halo`'s block
    forward in JAX."""
    model = JaxStratified(jcfg)

    def probs(feats, xyz, offsets):
        anchor = jnp.zeros((3,), jnp.float32)
        nidx, nmask, pyr = jax_pyramid_anchored(jcfg, xyz, offsets, anchor)
        logits = model.apply(variables, feats, xyz, offsets, training=False,
                             stem_nidx=nidx, stem_nmask=nmask, pyramid=pyr,
                             anchor=anchor)[0]
        return jax.nn.softmax(logits, -1)
    return probs


@pytest.fixture(autouse=True)
def _literal_bins(monkeypatch):
    monkeypatch.setattr(jax_attention, "relative_position_index",
                        literal_bins)


# each family's narrow configuration and its host batch's rooms
FAMILIES = {
    "s3dis": (dict(NARROW, drop_path_rate=0.0), {}),
    "scannet": (SCANNET_NARROW, ROOMS),
    "swin3d": (dict(NARROW, drop_path_rate=0.0, use_stratified=False,
                    rpe_mode="swin_window"), {}),
}


def _narrow(family, **kw):
    fields = dict(FAMILIES[family][0], **kw)
    jfields = dict(fields, sampler="grid", attn_impl="reference")
    return StratifiedConfig(**fields), JaxConfig(**jfields)


def _weights(jcfg, hb, seed=5):
    shapes = jax.eval_shape(lambda: JaxStratified(jcfg).init(
        {"params": jax.random.PRNGKey(0)}, hb["feats"], hb["xyz"],
        hb["offsets"], training=False))
    rng = np.random.default_rng(seed)
    variables = {"params": _random_variables(shapes["params"], rng),
                 "batch_stats": _random_variables(shapes["batch_stats"], rng)}
    return variables, from_flax(variables["params"],
                                variables["batch_stats"])


def _anchor(name, xyz, offsets):
    """The zero anchor, or one below the batch's min by uneven steps (a
    grid the batch-min anchor does not give)."""
    if ANCHORS[name] is None:
        return np.zeros(3, np.float32)
    lo = xyz[:int(offsets[-1])].min(0)
    return (lo - np.float32(ANCHORS[name])).astype(np.float32)


def _assert_tree_equal(got, want, label):
    if isinstance(want, dict):
        for key in want:
            _assert_tree_equal(got[key], want[key], f"{label}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), label
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{label}[{i}]")
    else:
        g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        w = np.asarray(want)
        assert g.shape == w.shape, label
        np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=label)


def test_audit_with_anchor_matches_jax():
    """The truncation counters of an anchored batch (pyramid and plans on
    the anchor's grid) equal the JAX audit's band / sband / cap arithmetic
    on JAX's anchored plans; small capacities (no dense band beyond the
    query tile) make every counter count."""
    cfg, jcfg = _narrow("s3dis", down_quota="cells", band=0,
                        band_per_stage=None, s_band=16, sparse_cap=4)
    hb = loader.host_batch(cfg, seed=1)
    xyz, off = torch.from_numpy(hb["xyz"]), torch.from_numpy(
        hb["offsets"]).long()
    a = _anchor("offset", hb["xyz"], hb["offsets"])
    pyr = geometry_pyramid(cfg, xyz, off, torch.from_numpy(a))
    got = audit.audit_truncation_packed(
        cfg, {"xyz": xyz, "offsets": off, "pyramid": pyr},
        anchor=torch.from_numpy(a)).numpy()
    levels = [(hb["xyz"], hb["offsets"])]
    for lvl in pyr["down"]:
        levels.append((levels[-1][0][lvl["idx"].numpy()],
                       lvl["offsets"].numpy()))
    for r, i in enumerate(range(cfg.num_layers)):
        lx, loff = levels[i]
        m = len(lx)
        batch = jax_sampling.offsets_to_batch(jnp.asarray(loff, jnp.int32), m)
        valid = jax_sampling.offsets_to_valid(jnp.asarray(loff, jnp.int32), m)
        is_down = jnp.asarray(pyr["stage_down"][r]["is_down"].numpy())
        d_pad = m // cfg.downsample_scale + cfg.num_scenes
        want = np.zeros(6, np.int64)
        for parity in (False, True):
            plan = jax_plan(lx, batch, valid, cfg.window_sizes()[i],
                            shifted=parity, is_down=is_down,
                            sparse_cap=cfg.sparse_cap,
                            aux_pad=((d_pad + 127) // 128) * 128, anchor=a)
            want[0:2] += np.asarray(jax_audit._dense_band_drops(
                plan, cfg.stage_band(i), cfg.tile))
            want[2:4] += np.asarray(jax_audit._sparse_band_drops(
                plan, cfg.s_band, cfg.tile))
            want[4] -= int(plan.sparse_band.sb_valid.sum())
        want[5] = 2 * int((is_down & valid).sum())
        want[4] += want[5]
        np.testing.assert_array_equal(got[r], want, err_msg=f"stage {i}")
    assert (got[:, [0, 2, 4]] > 0).any(0).all()


# ---- the two other divergences ----------------------------------------------

STANDIN_WS = 0.4


def _jax_window_mean(feats_b, xyz_b, offsets_b):
    """``tests/test_halo.py``'s stand-in model over blocks."""
    def one(feats, xyz, off):
        m = jnp.arange(xyz.shape[0]) < off[0]
        cells = jnp.floor(xyz / STANDIN_WS).astype(jnp.int32)
        keyv = (cells[:, 0] + 10000) * 100000 + (
            cells[:, 1] + 10000) * 100 + cells[:, 2]
        keyv = jnp.where(m, keyv, jnp.iinfo(jnp.int32).max)
        same = (keyv[:, None] == keyv[None, :]) & m[None, :] & m[:, None]
        cnt = jnp.maximum(same.sum(-1, keepdims=True), 1)
        return (same.astype(jnp.float32) @ feats[:, :3]) / cnt
    return jax.vmap(one)(feats_b, xyz_b, offsets_b)


def test_empty_slab_ships_no_core_point(tmp_path):
    """Divergence (ii): a scene whose quantile edges coincide has an empty
    slab. JAX's exchange gives that device `partition_scene`'s
    placeholder, point 0, as a core point, so point 0 is the core of two
    devices; the port ships no core point for it, every point is the core
    of one rank, and its probabilities equal its host replication's and
    the stand-in's whole-scene result, where JAX's do not."""
    coord = _scenes()["duplicates"]
    feat = np.random.default_rng(8).normal(size=(len(coord), 3)).astype(
        np.float32)
    coord0 = coord - coord.min(0)
    cores = [b["idx"][b["core"]] for b in
             halo.partition_scene(coord0, 4, halo=0.0)]
    jax_cores = [b["idx"] for b in
                 jax_halo.partition_scene(coord0, 4, halo=0.0)]
    assert [len(i) for i in cores].count(0) == 1
    assert np.bincount(np.concatenate(cores), minlength=len(coord)).max() == 1
    assert np.bincount(np.concatenate(jax_cores))[0] == 2
    # slabs of 0, ~750, ~190 and ~2060 core points; the empty slab's
    # halo holds the plane's 1500 points at depth 0
    kw = dict(core_pad=2176, halo_cap=1024, halo=1.0)
    job = {"model": ("window_mean", STANDIN_WS), "coord": coord,
           "feat": feat, "num_classes": 3,
           "calls": [("host", dict(n_pad=3072, halo=1.0, concat_xyz=False)),
                     ("collective", dict(kw, concat_xyz=False))]}
    host, got = run_ranks(job, 4, tmp_path)
    stats = {}
    jax_probs = jax_halo.sharded_scene_probs_collective(
        lambda f, x, o: _jax_window_mean(f[None], x[None], o[None])[0],
        coord, feat, 3, mesh=make_mesh(4), concat_xyz=False, stats=stats,
        **kw)
    assert stats["block_points"] == [len(i) for i in jax_cores]
    assert got["stats"]["block_points"] == [len(i) for i in cores]
    whole = _jax_window_mean(
        jnp.asarray(feat)[None], jnp.asarray(coord0)[None],
        jnp.array([[len(coord)]]))[0]
    np.testing.assert_allclose(got["probs"], whole, rtol=0,
                               atol=STANDIN_ATOL)
    np.testing.assert_array_equal(got["probs"], host["probs"])
    # JAX's: point 0 (on the plane x = 5, the empty slab's lower edge)
    # enters the halo of its own slab's device a second time and skews its
    # grid cell there
    assert np.abs(jax_probs - whole).max() > 1e-3


def test_only_a_core_slab_overflow_falls_back():
    """Divergence (i): JAX falls back to host replication on any
    ValueError of its exchange (``eval/voting.py:251-252``); the port only
    on `CoreSlabOverflow`, and any other error propagates. A block forward
    that raises at the exchange's capacity: JAX returns host replication's
    result, the port raises."""
    rng = np.random.default_rng(9)
    coord = rng.uniform(0, [3, 2, 1], (600, 3)).astype(np.float32)
    feat = rng.uniform(0, 255, (600, 3)).astype(np.float32)
    core_pad = halo_cap = 1024
    b_pad = core_pad + 2 * halo_cap

    def jax_apply(f, x, o):
        if f.shape[0] == b_pad:
            raise ValueError("a fault of the block forward")
        return _jax_window_mean(f[None], x[None], o[None])[0]

    kw = dict(halo_width=0.3, block_pad=1024, transforms=[None])
    stats = {}
    _, probs = jax_voting.evaluate_scene_sharded(
        jax.jit(_jax_window_mean), coord, feat, 3, mesh=make_mesh(1),
        apply_probs=jax_apply, core_pad=core_pad, halo_cap=halo_cap,
        stats=stats, **kw)
    assert stats["collective_fallback_chunks"] == stats["blocks_evaluated"]
    assert np.isfinite(probs).all()

    import torch_halo_worker
    standin = torch_halo_worker.window_mean(STANDIN_WS)

    def port_predict(feats, xyz, offsets):
        if feats.shape[0] == b_pad:
            raise ValueError("a fault of the block forward")
        return standin(feats, xyz, offsets)

    with pytest.raises(ValueError, match="a fault of the block forward"):
        voting.evaluate_scene_sharded(
            port_predict, coord, feat, 3, core_pad=core_pad,
            halo_cap=halo_cap, device="cpu", **kw)
    # a core slab beyond core_pad: the port falls back, as JAX
    stats = {}
    _, got = voting.evaluate_scene_sharded(
        port_predict, coord, feat, 3, core_pad=128, halo_cap=halo_cap,
        device="cpu", stats=stats, **kw)
    assert stats["collective_fallback_chunks"] == stats["blocks_evaluated"]
    np.testing.assert_allclose(got, probs, rtol=0, atol=STANDIN_ATOL)


# ---- the eval driver on two ranks ------------------------------------------

NARROW_ARGS = ["channels", "[16,32,64,128]", "num_heads", "[1,2,4,8]",
               "depths", "[1,1,2,1]"]


def test_driver_runs_sharded_on_two_cpu_ranks(capfd):
    """``sharded true sharded_devices 2 --device cpu``: two gloo ranks,
    rank 0's lines (the sharded settings, the scene, ``test.py``'s
    counters line, the result), its metrics returned; equal to one rank's
    metrics where the halo covers the chunk (the receptive halo spans the
    room)."""
    cfg = merge_cfg_from_list(
        load_cfg(os.path.join(CONFIGS, "s3dis_stratified.yaml")),
        NARROW_ARGS + ["data_name", "synthetic", "synthetic_points", "800",
                       "synthetic_eval_scenes", "1", "voxel_max", "400",
                       "sharded", "True", "sharded_devices", "2",
                       "sharded_block_points", "1024"])
    lines = []
    m = driver.run(cfg, "cpu", log=lines.append, timeout_s=60,
                   join_timeout_s=JOIN_TIMEOUT_S)
    out = capfd.readouterr().out
    assert lines == ["spawning 2 ranks on cpu"]
    assert "sharded eval: 2 devices, block_pad 1024, halo 11.22 m" in out
    assert "Scene [1/1] synthetic_0: acc " in out
    stats_line = [x for x in out.splitlines()
                  if x.startswith("sharded eval stats: ")]
    assert len(stats_line) == 1 and "re-run 0)" in stats_line[0]
    assert out.strip().splitlines()[-1].startswith(
        "Val result: mIoU/mAcc/allAcc ")
    st = m["sharded_stats"]
    assert st["collective_chunks"] > 0 and st["truncated_halo_points"] == 0
    assert st["blocks_evaluated"] == 2 * st["collective_chunks"]
    one = driver.run(dict(cfg, sharded_devices=1), "cpu",
                     log=lambda _: None)
    assert one["sharded_stats"]["blocks_evaluated"] == st[
        "collective_chunks"]
    assert abs(one["all_acc"] - m["all_acc"]) < 1e-2
