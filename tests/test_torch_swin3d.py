"""PyTorch port, the Swin3D family (``arch: swin3d_transformer``:
``use_stratified`` False, ``rpe_mode`` "swin_window"; the shipped
``configs/s3dis_swin3d.yaml`` and ``configs/scannetv2_swin3d.yaml``) at a
narrow width against the JAX package, which runs the mode on its jnp path:
the window-quantized positions and bins, the plain swin band forward and
backward, `Block` at both shift parities, the whole model (S3DIS- and
ScanNet-style, with a host pyramid and with on-device geometry), one train
step, the converter and AdamW state at 31 table rows, the pyramid and the
audit without members, the two drivers. The band kernels' swin mode on a
card: ``tests/test_torch_cuda.py``."""

import dataclasses
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stratified_transformer_tpu.data import pyramid as jax_pyramid_mod
from stratified_transformer_tpu.eval import voting as jax_voting
from stratified_transformer_tpu.models.attention import Block as JaxBlock
from stratified_transformer_tpu.models.stratified import (
    StratifiedConfig as JaxConfig)
from stratified_transformer_tpu.models.swin3d import Swin3D as JaxSwin3D
from stratified_transformer_tpu.ops import attention as jax_attn
from stratified_transformer_tpu.ops import plan as jax_plan
from stratified_transformer_tpu.train import audit as jax_audit
from stratified_transformer_tpu.train import schedulers as jax_sched
from stratified_transformer_tpu.train.state import (
    TrainState, make_optimizer as jax_make_optimizer)
from stratified_transformer_tpu.train.step import (
    make_train_step as jax_make_train_step)
from stratified_transformer_torch import convert
from stratified_transformer_torch.config import StratifiedConfig
from stratified_transformer_torch.convert import from_flax, from_flax_state
from stratified_transformer_torch.data import loader
from stratified_transformer_torch.data import pyramid as torch_pyramid
from stratified_transformer_torch.eval import driver as eval_driver
from stratified_transformer_torch.eval import voting
from stratified_transformer_torch.models.attention import (
    Block, swin_positions)
from stratified_transformer_torch.models.stratified import (
    Stratified, geometry_pyramid)
from stratified_transformer_torch.models.swin3d import Swin3D
from stratified_transformer_torch.ops import attention as plain
from stratified_transformer_torch.ops import plan as torch_plan
from stratified_transformer_torch.ops.attention_fused import (
    stratified_attention_fused)
from stratified_transformer_torch.train import audit
from stratified_transformer_torch.train import driver as train_driver
from stratified_transformer_torch.train import schedulers as torch_sched
from stratified_transformer_torch.train.state import make_optimizer
from stratified_transformer_torch.train.step import make_train_step
from stratified_transformer_torch.utils.config import (
    load_cfg, merge_cfg_from_list)
from test_torch_model import _random_variables
from test_torch_train import _record_grads
from test_torch_whole_scene import PROB_ATOL

torch.set_num_threads(1)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
# floats: as the JAX suite holds its own paths against each other
# (tests/test_pallas_attention.py:63-64); integers exactly
RTOL, ATOL = 2e-4, 2e-5
# S3DIS's stage 0 under the Swin YAMLs: window 4 x 0.04 m, quant 0.01 m,
# so qgl 16 and 31 table rows (every stage of both YAMLs has window/quant
# 16)
WS, QS = 0.16, 0.01
QGL = int(WS / QS)
NBINS = 2 * QGL - 1
H, D = 2, 16
# the two families at a narrow width; the Swin YAMLs' geometry (S3DIS:
# window 4 x grid 0.04; ScanNet: window 4 x grid 0.02, quant 0.005)
S3DIS = dict(num_classes=13, in_channels=6, channels=(16, 32, 64, 128),
             num_heads=(1, 2, 4, 8), depths=(2, 1, 2, 1), num_layers=4,
             n_pad=2048, num_scenes=2, tile=128, band=128,
             band_per_stage=(128, 128, 384, 192), sparse_cap=48, s_band=128,
             drop_path_rate=0.0)
SCANNET = dict(num_classes=20, in_channels=6, channels=(16, 16, 32, 64, 64),
               num_heads=(1, 1, 2, 4, 4), depths=(1, 2, 1, 2, 1),
               num_layers=5, window_size=4.0, grid_size=0.02,
               quant_size=0.005, stem_transformer=False, n_pad=2048,
               num_scenes=2, tile=128, band=128,
               band_per_stage=(128, 128, 384, 192, 192), sparse_cap=48,
               s_band=128, drop_path_rate=0.0)
FAMILIES = {"s3dis": (S3DIS, dict(), 255),
            "scannet": (SCANNET, dict(voxel_size=0.02, extent=1.0,
                                      ignore_label=-100), -100)}
SWIN = dict(use_stratified=False, rpe_mode="swin_window")
# the S3DIS Swin YAML's schedule, weight decay and lr scale
SCHEDULE_CFG = {"scheduler": "MultiStep", "scheduler_update": "epoch",
                "base_lr": 0.006, "epochs": 100}
WEIGHT_DECAY = 0.01


def _jax_config(narrow, **kw):
    return JaxConfig(**dict(narrow, **kw), sampler="grid",
                     attn_impl="reference", rpe_precision="highest",
                     qk_precision="highest")


def _jnp(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


# ---- positions and bins ------------------------------------------------------

def _boundary_points(rng, n=3000):
    """Random points in a 1 m box plus points on the window and quantum
    lattice and one float below it (from the box's own origin at 0), where
    ``mod`` and the division meet their edges."""
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    pts[0] = 0.0                                   # the origin
    lat = (rng.integers(0, 100, (n // 2, 3)) * np.float32(QS)).astype(
        np.float32)
    lat[: n // 4] = (rng.integers(0, 6, (n // 4, 3))
                     * np.float32(WS / 2)).astype(np.float32)
    below = np.nextafter(lat, np.float32(-1)).astype(np.float32)
    return np.concatenate([pts, lat, np.maximum(below, 0)])


@pytest.mark.parametrize("parity", [0, 1])
def test_positions_and_bins_equal_jax(parity):
    """``u`` from the plan's grid origin, bit-equal to JAX's
    (``models/attention.py:84-100``) at both shift parities, boundary
    points included; the bins of random pairs and of every integer
    ``rel`` in ``[-qgl-2, qgl+2]`` (the clip) equal to JAX's."""
    rng = np.random.default_rng(3)
    xyz = _boundary_points(rng)
    n = len(xyz)
    valid = np.ones(n, bool)
    batch = np.zeros(n, np.int32)
    shift = WS / 2.0 if parity else 0.0
    tp = torch_plan.build_attention_plan(
        torch.from_numpy(xyz), torch.from_numpy(batch),
        torch.from_numpy(valid), WS, shifted=bool(parity))
    jp = jax_plan.build_attention_plan(
        jnp.asarray(xyz), jnp.asarray(batch), jnp.asarray(valid), WS,
        shifted=bool(parity))
    np.testing.assert_array_equal(tp.grid_start.numpy(),
                                  np.asarray(jp.grid_start))
    got = swin_positions(tp.xyz_sorted, tp.grid_start, shift, WS, QS)

    def jax_u(xs, origin):
        r = jnp.mod(xs - origin + shift, WS)
        return jnp.floor(r / QS)

    # the formula as written (op by op); under jit XLA multiplies by the
    # reciprocal of the constant quant instead, which moves u where the two
    # round to either side of an integer (a reference-side rewrite, as its
    # FMA in the stratified bins: ROADMAP.md section 3)
    want = np.asarray(jax_u(jp.xyz_sorted, jp.grid_start))
    rewritten = np.asarray(jax.jit(jax_u)(jp.xyz_sorted, jp.grid_start))
    r = np.asarray(jnp.mod(jp.xyz_sorted - jp.grid_start + shift, WS))
    recip = np.floor(r * np.float32(1.0 / np.float32(QS)))
    np.testing.assert_array_equal(rewritten, recip)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the windows' both edges are reached (u up to qgl - 1 here; the clip
    # of the bins, for tables where the division rounds up to qgl, is held
    # by the integer sweep below)
    assert (want == QGL - 1).any() and (want == 0).any()
    u = got.numpy()
    i0, i1 = rng.integers(0, n, 20000), rng.integers(0, n, 20000)
    ints = np.arange(-QGL - 2, QGL + 3, dtype=np.float32)
    rel = np.concatenate([(u[i0] - u[i1]).ravel(), ints])
    want_b = np.asarray(jax_attn.swin_relative_position_index(
        jnp.asarray(rel), NBINS))
    got_b = plain.swin_relative_position_index(torch.from_numpy(rel), NBINS)
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    assert got_b.min() == 0 and got_b.max() == NBINS - 1


# ---- the plain swin band attention ----------------------------------------

def _attention_case(seed, with_rpe, n_pad=512, n_valid=430, shifted=True):
    """q, k, v, the cotangent, tables of 31 rows and a plan of 0.16 m
    windows over two scenes of a 0.6 m box, with the swin positions of its
    shift parity."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 0.6, (n_pad, 3)).astype(np.float32)
    batch = np.sort(rng.integers(0, 2, n_valid)).astype(np.int32)
    batch = np.concatenate([batch, np.full(n_pad - n_valid, 2, np.int32)])
    valid = np.arange(n_pad) < n_valid
    q, k, v, g = (rng.normal(size=(n_pad, H, D)).astype(np.float32)
                  for _ in range(4))
    tables = tuple(
        (rng.normal(size=(NBINS, H, D, 3)) * 0.05).astype(np.float32)
        if with_rpe else None for _ in range(3))
    tp = torch_plan.build_attention_plan(
        torch.from_numpy(xyz), torch.from_numpy(batch),
        torch.from_numpy(valid), WS, shifted=shifted)
    u = swin_positions(tp.xyz_sorted, tp.grid_start,
                       WS / 2.0 if shifted else 0.0, WS, QS)
    o = tp.order.numpy()
    return tp, u, (q[o], k[o], v[o]), tables, g


KW = dict(window_size=WS, quant_size=QS, scale=D ** -0.5)


def _jax_swin(qkv, u, tp, tables):
    return jax_attn.stratified_attention(
        *map(jnp.asarray, qkv), jnp.asarray(u.numpy()),
        jnp.asarray(tp.seg_start.numpy()), jnp.asarray(tp.seg_end.numpy()),
        jnp.asarray(tp.valid_sorted.numpy()), None, None,
        *map(_jnp, tables), **KW, band=128, tile=128,
        rpe_mode="swin_window")


@pytest.mark.parametrize("with_rpe", [True, False])
def test_plain_swin_forward_matches_jax(with_rpe):
    tp, u, qkv, tables, _ = _attention_case(0, with_rpe)
    want = np.asarray(_jax_swin(qkv, u, tp, tables))
    triple = plain.band_attention_plain(
        *map(_t, qkv), u, tp.seg_start, tp.seg_end, tp.valid_sorted,
        *map(_t, tables), **KW, band=128, tile=128, rpe_mode="swin_window")
    got = plain.merge([triple])[0]
    valid = tp.valid_sorted.numpy()
    np.testing.assert_allclose(got.numpy()[valid], want[valid], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("with_rpe", [True, False])
def test_plain_swin_backward_matches_jax_vjp(with_rpe):
    tp, u, qkv, tables, g = _attention_case(1, with_rpe, shifted=False)
    present = [t for t in tables if t is not None]

    def f(q, k, v, *tabs):
        it = iter(tabs)
        ts = [None if t is None else next(it) for t in tables]
        return jax_attn.stratified_attention(
            q, k, v, jnp.asarray(u.numpy()),
            jnp.asarray(tp.seg_start.numpy()),
            jnp.asarray(tp.seg_end.numpy()),
            jnp.asarray(tp.valid_sorted.numpy()), None, None, *ts, **KW,
            band=128, tile=128, rpe_mode="swin_window")

    _, vjp = jax.vjp(f, *map(jnp.asarray, qkv), *map(jnp.asarray, present))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    geom = (u, tp.seg_start, tp.seg_end, tp.valid_sorted)
    tt = tuple(map(_t, tables))
    out, m, den = plain.merge([plain.band_attention_plain(
        *map(_t, qkv), *geom, *tt, **KW, band=128, tile=128,
        rpe_mode="swin_window")])
    got = plain.band_attention_bwd_plain(
        *map(_t, qkv), *geom, _t(g), out, m, den, *tt, **KW, band=128,
        tile=128, rpe_mode="swin_window")
    got = [x for x in got if x is not None]
    assert len(got) == len(want) == 3 + len(present)
    for name, a, b in zip(("dq", "dk", "dv", "dtq", "dtk", "dtv"), got,
                          want):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    # the autograd Function (the wrappers' CPU path) gives the same
    leaves = [_t(x).requires_grad_() for x in qkv] + [
        None if t is None else _t(t).requires_grad_() for t in tables]
    out_f = stratified_attention_fused(
        *leaves[:3], *geom, None, *leaves[3:], **KW, band=128, tile=128,
        rpe_mode="swin_window")
    out_f.backward(_t(g))
    for name, leaf, b in zip(("q", "k", "v", "tq", "tk", "tv"),
                             [x for x in leaves if x is not None], want):
        np.testing.assert_allclose(leaf.grad.numpy(), b, rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def _kernel_case(case, seed=11, n=256):
    """The windows and positions on which ``tests/test_torch_cuda.py``
    holds the fp32 swin backward kernel (32-row blocks, 32-key chunks) to
    the plain version, from numpy: windows given as key segments that
    straddle the blocks and chunks; integer positions ("straddle"),
    positions at u = 0, 15 and 16 (both table edges and the clip,
    "clip"), positions off any lattice ("continuous"), or rows whose
    segment is empty and invalid keys inside windows ("no_key")."""
    rng = np.random.default_rng(seed)
    edges = [0, 20, 60, 75, 100, 140, 170, 200, 230]
    seg_start = np.full(n, edges[-1], np.int32)
    seg_end = np.full(n, edges[-1], np.int32)
    for a, b in zip(edges[:-1], edges[1:]):
        seg_start[a:b], seg_end[a:b] = a, b
    valid = np.arange(n) < edges[-1]
    if case == "clip":
        u = rng.choice(np.float32([0.0, 15.0, 16.0]), (n, 3))
    elif case == "continuous":
        u = (rng.random((n, 3)) * 16.0).astype(np.float32)
    else:
        u = rng.integers(0, 16, (n, 3)).astype(np.float32)
    if case == "no_key":
        seg_end[40:50] = seg_start[40:50]
        valid[[80, 81, 150]] = False
    q, k, v, g = (rng.normal(size=(n, H, D)).astype(np.float32)
                  for _ in range(4))
    tables = tuple((rng.normal(size=(NBINS, H, D, 3)) * 0.05).astype(
        np.float32) for _ in range(3))
    return (u, seg_start, seg_end, valid), (q, k, v), g, tables


@pytest.mark.parametrize("case", ["straddle", "clip", "continuous",
                                  "no_key"])
def test_plain_swin_forward_matches_jax_on_the_kernel_cases(case):
    """The plain swin forward, which the CUDA tests hold the fp32 kernel to
    on these cases, merged, against JAX's jnp swin attention; rows whose
    segment is empty give the empty triple (m = -1e30, den = 0, acc = 0)."""
    geom, qkv, _, tables = _kernel_case(case)
    want = np.asarray(jax_attn.stratified_attention(
        *map(jnp.asarray, qkv + geom), None, None,
        *map(jnp.asarray, tables), **KW, band=128, tile=128,
        rpe_mode="swin_window"))
    tgeom = tuple(torch.from_numpy(x) for x in geom)
    acc, m, den = plain.band_attention_plain(
        *map(_t, qkv), *tgeom, *map(_t, tables), **KW, band=128, tile=128,
        rpe_mode="swin_window")
    got = plain.merge([(acc, m, den)])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if case == "no_key":
        assert bool((m[40:50] == -1e30).all())
        assert not den[40:50].any() and not acc[40:50].any()


@pytest.mark.parametrize("case", ["straddle", "clip", "continuous",
                                  "no_key"])
def test_plain_swin_backward_matches_jax_on_the_kernel_cases(case):
    """The plain swin backward, which the CUDA tests hold the fp32 kernel
    to on these cases, against JAX's vjp of its jnp swin attention."""
    geom, qkv, g, tables = _kernel_case(case)

    def f(q, k, v, *tabs):
        return jax_attn.stratified_attention(
            q, k, v, *map(jnp.asarray, geom), None, None, *tabs, **KW,
            band=128, tile=128, rpe_mode="swin_window")

    _, vjp = jax.vjp(f, *map(jnp.asarray, qkv + tables))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    tgeom = tuple(torch.from_numpy(x) for x in geom)
    tt = tuple(map(_t, tables))
    out, m, den = plain.merge([plain.band_attention_plain(
        *map(_t, qkv), *tgeom, *tt, **KW, band=128, tile=128,
        rpe_mode="swin_window")])
    got = plain.band_attention_bwd_plain(
        *map(_t, qkv), *tgeom, _t(g), out, m, den, *tt, **KW, band=128,
        tile=128, rpe_mode="swin_window")
    for name, a, b in zip(("dq", "dk", "dv", "dtq", "dtk", "dtv"), got,
                          want):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    if case == "no_key":
        assert not got[0][40:50].any()
        for x in got[:3]:
            assert not x[[80, 81, 150]].any()


# Swin3D at DEFAULT precision (a kept divergence, ROADMAP.md section 3):
# the JAX package runs the mode on its jnp path, whose DEFAULT contractions
# are fp32 on the CPU; the port runs the band kernels' fast form, which
# rounds each product's operands to bf16. Relative L2 of the output from
# JAX's: the fp32 form within the fp32 tolerance (measured 3.4e-8), the
# fast form at bf16's scale (measured 2.1e-3; the stratified stage 3's
# divergence in tests/test_torch_fast.py reads 2.3e-3).
FAST_DIVERGENCE = (1e-4, 1e-2)


def test_fast_swin_divergence_is_bf16_rounding():
    tp, u, qkv, tables, _ = _attention_case(3, True)
    geom = (u, tp.seg_start, tp.seg_end, tp.valid_sorted)
    jnp_out = np.asarray(jax_attn.stratified_attention(
        *map(jnp.asarray, qkv), *(jnp.asarray(x.numpy()) for x in geom),
        None, None, *map(_jnp, tables), **KW, band=128, tile=128,
        rpe_mode="swin_window", rpe_precision="default",
        qk_precision="default"))
    with torch.no_grad():
        ours = {fast: stratified_attention_fused(
            *map(_t, qkv), *geom, None, *map(_t, tables), **KW, band=128,
            fast=fast, rpe_mode="swin_window").numpy()
            for fast in (False, True)}
    valid = tp.valid_sorted.numpy()
    np.testing.assert_allclose(ours[False][valid], jnp_out[valid],
                               rtol=RTOL, atol=ATOL)
    lo, hi = FAST_DIVERGENCE
    assert lo <= _rel_l2(ours[True][valid], jnp_out[valid]) <= hi


def test_swin_mode_refuses_far_keys():
    tp, u, qkv, tables, _ = _attention_case(2, True)
    sp = torch_plan.build_attention_plan(
        tp.xyz_sorted, torch.zeros(512, dtype=torch.int32),
        tp.valid_sorted, WS, shifted=False,
        is_down=tp.valid_sorted.clone(), sparse_cap=8)
    with pytest.raises(ValueError, match="window-dense"):
        stratified_attention_fused(
            *map(_t, qkv), u, tp.seg_start, tp.seg_end, tp.valid_sorted,
            sp.sparse_band, *map(_t, tables), **KW, band=128,
            rpe_mode="swin_window")


# ---- one block at each shift parity -----------------------------------------

@pytest.mark.parametrize("parity", [0, 1])
def test_block_matches_jax(parity):
    """`Block` with ``rpe_mode`` "swin_window" and the stage's shift on odd
    blocks (``models/stratified.py:241-242``), on the plan of its parity."""
    rng = np.random.default_rng(10 + parity)
    n, n_valid, dim, heads = 512, 450, 32, 2
    xyz = rng.uniform(0, 0.6, (n, 3)).astype(np.float32)
    batch = np.concatenate([np.zeros(n_valid // 2, np.int32),
                            np.ones(n_valid - n_valid // 2, np.int32),
                            np.full(n - n_valid, 2, np.int32)])
    valid = np.arange(n) < n_valid
    feats = rng.normal(size=(n, dim)).astype(np.float32)
    shift = WS / 2.0 if parity else 0.0
    jp = jax_plan.build_attention_plan(
        jnp.asarray(xyz), jnp.asarray(batch), jnp.asarray(valid), WS,
        shifted=bool(parity))
    jblock = JaxBlock(dim=dim, num_heads=heads, window_size=WS,
                      quant_size=QS, band=128, tile=128,
                      rpe_mode="swin_window", shift_size=shift)
    shapes = jax.eval_shape(lambda: jblock.init(
        jax.random.PRNGKey(0), jnp.asarray(feats), jp, training=False))
    params = _random_variables(shapes["params"], rng)
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(feats),
                                   jp, training=False))
    block = Block(dim, heads, WS, QS, band=128, tile=128, s_band=128,
                  rpe_mode="swin_window", shift_size=shift)
    block.load_state_dict(from_flax(params), strict=True)
    assert block.attn.rel_query_table.shape == (NBINS, heads, dim // heads, 3)
    tp = torch_plan.build_attention_plan(
        torch.from_numpy(xyz), torch.from_numpy(batch),
        torch.from_numpy(valid), WS, shifted=bool(parity))
    with torch.no_grad():
        got = block.eval()(torch.from_numpy(feats), tp)
    np.testing.assert_allclose(got.numpy()[valid], want[valid], rtol=RTOL,
                               atol=ATOL)


# ---- the whole model --------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _family(name):
    """The narrow Swin3D of one family in both packages (JAX's `Swin3D`),
    with the same random weights, on one host batch; and one JAX train step
    (AdamW with the YAMLs' groups and weight decay, drop-path 0) and the
    JAX state after it, and after a second step."""
    narrow, rooms, ignore = FAMILIES[name]
    cfg = StratifiedConfig(**narrow, **SWIN)
    hb = loader.host_batch(cfg, seed=0, **rooms)
    if name == "scannet":
        # ScanNet marks unlabelled points: every 7th valid point carries the
        # ignore label, as in tests/test_torch_scannet.py's batch
        labels = hb["labels"].copy()
        labels[:int(hb["offsets"][-1]):7] = ignore
        hb["labels"] = labels
    jmodel = JaxSwin3D(_jax_config(narrow))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, hb["feats"], hb["xyz"],
        hb["offsets"], training=False, stem_nidx=hb["stem_nidx"],
        stem_nmask=hb["stem_nmask"], pyramid=hb["pyramid"]))
    rng = np.random.default_rng(7)
    variables = {"params": _random_variables(shapes["params"], rng),
                 "batch_stats": _random_variables(shapes["batch_stats"], rng)}
    model = Swin3D(StratifiedConfig(**narrow))
    model.load_state_dict(from_flax(variables["params"],
                                    variables["batch_stats"]), strict=True)
    params, stats = variables["params"], variables["batch_stats"]
    tx = optax.chain(_record_grads(), jax_make_optimizer(
        params, jax_sched.from_config(SCHEDULE_CFG, 2)[0], WEIGHT_DECAY,
        0.1))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params), tx=tx,
                       apply_fn=jmodel.apply)
    jstep = jax.jit(jax_make_train_step(ignore, narrow["num_classes"]))
    states, losses = [], []
    for _ in range(2):
        state, st = jstep(state, hb, jax.random.PRNGKey(0))
        states.append(state)
        losses.append(float(st["loss"]))
    return types.SimpleNamespace(
        name=name, narrow=narrow, cfg=cfg, hb=hb, jmodel=jmodel,
        variables=variables, model=model.eval(), ignore=ignore,
        j_states=states, j_losses=losses)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    return _family(request.param)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def _torch_trainer(f):
    model = Swin3D(StratifiedConfig(**f.narrow))
    model.load_state_dict(f.model.state_dict())
    model.train()
    opt = make_optimizer(model,
                         torch_sched.from_config(SCHEDULE_CFG, 2)[0],
                         weight_decay=WEIGHT_DECAY)
    return model, opt, make_train_step(f.ignore, f.narrow["num_classes"])


@pytest.mark.parametrize("pyramid", ["host", "device"])
def test_swin3d_forward_matches_jax(family, pyramid):
    """The eval forward with the host pyramid, and with the stem
    neighbours and the geometry computed by the model (whole-scene
    evaluation's path), against JAX's `Swin3D`."""
    f = family
    hb = f.hb
    kw = (dict(stem_nidx=hb["stem_nidx"], stem_nmask=hb["stem_nmask"],
               pyramid=hb["pyramid"]) if pyramid == "host" else {})
    want = np.asarray(jax.jit(lambda v, b: f.jmodel.apply(
        v, b["feats"], b["xyz"], b["offsets"], training=False,
        **({k: b[k] for k in ("stem_nidx", "stem_nmask", "pyramid")}
           if pyramid == "host" else {}))[0])(f.variables, hb))
    batch = loader.to_device(hb, "cpu")
    tkw = ({k: batch[k] for k in ("stem_nidx", "stem_nmask", "pyramid")}
           if pyramid == "host" else {})
    with torch.no_grad():
        got = f.model(batch["feats"], batch["xyz"], batch["offsets"],
                      **tkw)[0]
    assert not kw or hb["pyramid"]["stage_down"] == ()
    n_valid = int(hb["offsets"][-1])
    np.testing.assert_allclose(got.numpy()[:n_valid], want[:n_valid],
                               rtol=RTOL, atol=ATOL)


def test_swin3d_plans_have_no_far_keys(family, monkeypatch):
    """Every block of the forward runs on a plan without a far-key layout,
    in the swin mode, at the stage's shift (odd blocks ``window / 2``)."""
    seen = []
    real = plain.band_attention_plain

    def spy(*args, **kw):
        seen.append(kw["rpe_mode"])
        return real(*args, **kw)

    def no_sparse(*args, **kw):
        raise AssertionError("a Swin3D block reached the far-key half")

    from stratified_transformer_torch.kernels import band_attention as bk
    from stratified_transformer_torch.kernels import (
        sparse_band_attention as sk)
    monkeypatch.setattr(bk, "band_attention_plain", spy)
    monkeypatch.setattr(sk, "sparse_band_attention_plain", no_sparse)
    batch = loader.to_device(family.hb, "cpu")
    with torch.no_grad():
        family.model(batch["feats"], batch["xyz"], batch["offsets"],
                     stem_nidx=batch["stem_nidx"],
                     stem_nmask=batch["stem_nmask"], pyramid=batch["pyramid"])
    cfg = family.cfg
    assert seen == ["swin_window"] * sum(cfg.depths[cfg.layer_start:])
    for i in range(cfg.layer_start, cfg.num_layers):
        ws = cfg.window_sizes()[i]
        layer = getattr(family.model, f"layer_{i}")
        for b in range(cfg.depths[i]):
            attn = getattr(layer, f"blocks_{b}").attn
            assert attn.shift_size == (ws / 2.0 if b % 2 else 0.0)
            assert attn.rel_key_table.shape[0] == NBINS


def _stem_0_decisions(model, flip):
    """Make ``stem_0``'s LeakyReLU take the other branch where ``flip`` is
    set (elsewhere the same values and derivatives as ``F.leaky_relu``)."""
    blk = model.stem_0

    def forward(feats, xyz, neighbor_idx, neighbor_mask, valid):
        y = blk.bn(blk.kpconv(feats, xyz, neighbor_idx, neighbor_mask), valid)
        return torch.where((y > 0) ^ flip, y, blk.negative_slope * y)

    blk.forward = forward


def test_swin3d_train_step_matches_jax(family):
    """One train step (AdamW, the YAMLs' groups, drop-path 0) against
    ``make_train_step``: every gradient, the parameters after it and the
    loss.

    A LeakyReLU decision of ``stem_0`` on a pre-activation within fp32
    rounding of 0 is decided by the two frameworks' rounding, and where
    they decide it differently the whole channel's stem gradients differ
    (on the ScanNet-style batch point 1097's channel 1, at -1.4e-7: 1.3e-2
    relative L2 in ``stem_0.kpconv.kernel_weights``, 2.5e-2 in
    ``stem_0.bn.bias``). So the step is also taken with each such decision
    the other way, and one of those steps must equal JAX's everywhere."""
    f = family
    want = from_flax(f.j_states[0].opt_state[0])
    batch = loader.to_device(f.hb, "cpu")
    seen = {}
    model, opt, step = _torch_trainer(f)
    hook = model.stem_0.bn.register_forward_hook(
        lambda m, i, y: seen.update(y=y.detach().clone()))
    runs = [(model, step(model, opt, batch, None))]
    hook.remove()
    n_valid = int(f.hb["offsets"][-1])
    near = torch.zeros_like(seen["y"], dtype=torch.bool)
    near[:n_valid] = seen["y"][:n_valid].abs() < 1e-6
    sites = near.nonzero().tolist()
    assert len(sites) <= 2, sites
    for k in range(1, 2 ** len(sites)):
        flip = torch.zeros_like(near)
        for i, (r, c) in enumerate(sites):
            flip[r, c] = bool(k >> i & 1)
        m, o, _ = _torch_trainer(f)
        _stem_0_decisions(m, flip)
        runs.append((m, step(m, o, batch, None)))

    def off(m):
        """The parameters whose gradient differs from JAX's."""
        return [n for n, p in m.named_parameters() if not np.allclose(
            p.grad.numpy(), want[n].numpy(), rtol=RTOL, atol=ATOL)]

    model, t_st = min(runs, key=lambda run: len(off(run[0])))
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(want) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(float(t_st["loss"]), f.j_losses[0],
                               rtol=RTOL)
    tables = [n for n in grads if n.endswith("_table")]
    assert tables and all(float(grads[n].abs().max()) > 1e-6 for n in tables)
    # the parameters after AdamW's first step, about lr * sign(grad):
    # equal where the grad's sign is well above the two frameworks' fp32
    # noise, and within the step's size where it is not (a grad that is 0
    # in exact arithmetic, e.g. a KPConv kernel point without neighbours)
    lr = SCHEDULE_CFG["base_lr"]
    new = from_flax(f.j_states[0].params)
    for name, p in model.named_parameters():
        got, w = p.detach().numpy(), new[name].numpy()
        sure = np.abs(want[name].numpy()) > 1e-4
        np.testing.assert_allclose(got[sure], w[sure], rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        assert np.abs(got - w).max() <= 2.02 * lr, name


def test_swin3d_adamw_state_converts_at_31_rows(family):
    """`from_flax_state` carries JAX's Swin3D state after step 1 across
    (31-row tables, their AdamW moments by name); the port's step 2 from it
    gives JAX's step-2 loss."""
    from tools import orbax_to_torch
    f = family
    st = f.j_states[0]
    model, opt, step = _torch_trainer(f)
    payload = from_flax_state(
        orbax_to_torch.plain_tree(st.params),
        orbax_to_torch.plain_tree(st.batch_stats),
        orbax_to_torch.plain_tree(st.opt_state[1]), 1, 0, model=model,
        optimizer=opt)
    model.load_state_dict(payload["model"], strict=True)
    opt.load_state_dict(payload["optimizer"])
    adam, = convert._adam_states(orbax_to_torch.plain_tree(st.opt_state[1]))
    mu = from_flax(adam["mu"])
    n_tables = 0
    for name, p in model.named_parameters():
        assert torch.equal(opt.state[p]["exp_avg"], mu[name]), name
        if name.endswith("_table"):
            assert p.shape[0] == NBINS
            n_tables += 1
    assert n_tables == 3 * sum(f.cfg.depths[f.cfg.layer_start:])
    loss = float(step(model, opt, loader.to_device(f.hb, "cpu"),
                      None)["loss"])
    np.testing.assert_allclose(loss, f.j_losses[1], rtol=RTOL)


# ---- configuration, pyramid, audit ---------------------------------------

def test_pyramid_and_audit_have_no_members(family):
    """The host pyramid equals JAX's with no ``stage_down`` entry
    (``data/pyramid.py:179``), the on-device geometry makes none, and the
    audit counts nothing (``train/audit.py:102``)."""
    f = family
    hb = f.hb
    jcfg = _jax_config(f.narrow, **SWIN)
    pyr_j = jax_pyramid_mod.build_geometry_pyramid(hb["xyz"], hb["offsets"],
                                                   jcfg)
    pyr_t = torch_pyramid.build_geometry_pyramid(hb["xyz"], hb["offsets"],
                                                 f.cfg)
    assert pyr_t["stage_down"] == pyr_j["stage_down"] == ()
    for a, b in zip(pyr_t["down"], pyr_j["down"]):
        for key in ("idx", "valid", "offsets", "knn_mask"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    dev = geometry_pyramid(f.cfg, torch.from_numpy(hb["xyz"]),
                           torch.from_numpy(hb["offsets"]).long())
    assert dev["stage_down"] == ()
    assert len(dev["down"]) == f.cfg.num_layers - 1
    assert jax_audit.audit_truncation(jcfg, hb) == {}
    got = audit.audit_truncation_packed(f.cfg, loader.to_device(hb, "cpu"))
    assert tuple(got.shape) == (0, 6)
    assert audit.unpack_truncation(f.cfg, got.numpy()) == {}


# ---- the drivers ----------------------------------------------------------

def test_train_driver_epoch_on_the_swin_yaml(tmp_path):
    """One narrow epoch of the train driver on ``configs/s3dis_swin3d.yaml``
    (synthetic rooms): the Swin3D model on its main path (``attn_impl``
    "fused" whatever the YAML says), no audit, finite losses and a
    checkpoint."""
    opts = ["channels", "[16,32,64,128]", "num_heads", "[1,2,4,8]",
            "depths", "[1,1,2,1]", "max_batch_points", "2048",
            "batch_size", "2", "voxel_max", "900", "data_name", "synthetic",
            "synthetic_scenes", "4", "synthetic_points", "1500", "epochs",
            "1", "evaluate", "True", "print_freq", "1", "use_tensorboard",
            "False", "save_path", str(tmp_path)]
    lines = []
    model, summary = train_driver.run(merge_cfg_from_list(
        load_cfg(os.path.join(CONFIGS, "s3dis_swin3d.yaml")), opts),
        "cpu", log=lines.append)
    assert model.cfg.rpe_mode == "swin_window"
    assert not model.cfg.use_stratified and model.cfg.attn_impl == "fused"
    attn = [m for m in model.modules()
            if type(m).__name__ == "WindowAttention"]
    assert len(attn) == 5 and all(not a.plain for a in attn)
    assert summary["steps"] == 2
    assert all(np.isfinite(it["loss"]) for it in summary["iters"])
    recs = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert recs and not any("audit" in r for r in recs)
    assert not any("pair-drop" in x for x in lines)
    assert os.listdir(tmp_path / "ckpt")


def test_eval_protocol_scene_matches_jax():
    """``test.py``'s protocol (TTA x vote chunks x sphere crops) on one small
    synthetic scene through the port's S3DIS-style Swin3D with on-device
    geometry, against the JAX package's `evaluate_scene` with the same
    weights."""
    f = _family("s3dis")
    rng = np.random.default_rng(4)
    coord = rng.uniform(0, 1.5, (900, 3)).astype(np.float32)
    coord[:, 2] *= 0.5
    feat = rng.uniform(0, 255, (900, 3)).astype(np.float32)
    n_pad = 1024
    cfg = dataclasses.replace(f.cfg, n_pad=n_pad)
    model = Stratified(cfg)
    model.load_state_dict(f.model.state_dict())
    predict = eval_driver.make_predict_probs(model.eval())
    kw = dict(data_name="s3dis", voxel_size=0.04, voxel_max=500,
              batch_size_test=2, n_pad=n_pad, num_scenes=2)
    calls = []

    def counted(feats, xyz, offsets):
        calls.append(int(offsets[-1]))
        return predict(feats, xyz, offsets)

    pred, probs = voting.evaluate_scene(counted, coord, feat, 13, **kw)
    jmodel = JaxSwin3D(_jax_config(f.narrow, n_pad=n_pad))

    @jax.jit
    def jax_probs(feats, xyz, offsets):
        return jax.nn.softmax(jmodel.apply(
            f.variables, feats, xyz, offsets, training=False)[0], -1)

    want_pred, want_probs = jax_voting.evaluate_scene(
        lambda a, b, c: np.asarray(jax_probs(a, b, c)), coord, feat, 13,
        **kw)
    assert len(calls) >= 7
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=PROB_ATOL)
    top2 = np.sort(want_probs, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    np.testing.assert_array_equal(pred[clear], want_pred[clear])


def test_eval_driver_runs_the_swin_yaml():
    """The eval driver (``test.py``) on the S3DIS Swin YAML with synthetic
    rooms: the Swin3D model on its main path, one scene scored."""
    lines = []
    yaml_cfg = merge_cfg_from_list(
        load_cfg(os.path.join(CONFIGS, "s3dis_swin3d.yaml")),
        ["data_name", "synthetic", "synthetic_points", "400",
         "synthetic_eval_scenes", "1", "voxel_max", "400",
         "batch_size_test", "2", "channels", "[16,32,64,128]", "num_heads",
         "[1,2,4,8]", "depths", "[1,1,2,1]"])
    cfg = eval_driver.eval_config(yaml_cfg)
    assert cfg.rpe_mode == "swin_window" and cfg.attn_impl == "fused"
    m = eval_driver.run(yaml_cfg, "cpu", log=lines.append)
    assert len(m["scenes"]) == 1
    assert lines[-1].startswith("Val result: mIoU/mAcc/allAcc ")
