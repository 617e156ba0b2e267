"""PyTorch port, attention: the plain versions of the two kernels and their
merge against the JAX package's Pallas kernels run in interpret mode, at
the point of ``tests/test_pallas_attention.py``; cRPE bins exact on a
boundary-dense sweep."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratified_transformer_tpu.ops import attention as jax_attn
from stratified_transformer_tpu.ops import plan as jax_plan
from stratified_transformer_tpu.ops.attention_fused import (
    stratified_attention_fused as jax_fused)
from stratified_transformer_tpu.ops.pallas.fused_attention import (
    band_attention as jax_band, sparse_band_attention as jax_sparse)
from stratified_transformer_torch.kernels.band_attention import band_attention
from stratified_transformer_torch.kernels.sparse_band_attention import (
    sparse_band_attention)
from stratified_transformer_torch.ops import attention as torch_attn
from stratified_transformer_torch.ops import plan as torch_plan
from stratified_transformer_torch.ops.attention_fused import (
    stratified_attention_fused)

torch.set_num_threads(1)

H, D = 2, 8
WS = 0.5
QUANT = 0.125
NBINS = 2 * int((2 * WS + 1e-4) // QUANT)
SCALE = D ** -0.5
TILE, BAND, WCHUNK, S_BAND = 32, 32, 32, 64
# as tests/test_pallas_attention.py:63-64 between the Pallas and jnp paths
RTOL, ATOL = 2e-4, 2e-5


def _case(seed, with_rpe, n_valid=100, n_pad=128):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 2, (n_pad, 3)).astype(np.float32)
    batch = np.sort(rng.integers(0, 2, n_valid)).astype(np.int32)
    batch = np.concatenate([batch, np.full(n_pad - n_valid, 2, np.int32)])
    valid = np.arange(n_pad) < n_valid
    q, k, v = (rng.normal(size=(n_pad, H, D)).astype(np.float32)
               for _ in range(3))
    is_down = (rng.uniform(size=n_pad) < 0.4) & valid
    tables = tuple(
        (rng.normal(size=(NBINS, H, D, 3)) * 0.05).astype(np.float32)
        if with_rpe else None for _ in range(3))
    jp = jax_plan.build_attention_plan(
        jnp.asarray(xyz), jnp.asarray(batch), jnp.asarray(valid), WS,
        shifted=False, is_down=jnp.asarray(is_down), sparse_cap=16)
    tp = torch_plan.build_attention_plan(
        torch.from_numpy(xyz), torch.from_numpy(batch),
        torch.from_numpy(valid), WS, shifted=False,
        is_down=torch.from_numpy(is_down), sparse_cap=16)
    o = np.asarray(jp.order)
    return jp, tp, (q[o], k[o], v[o]), tables


def _jnp(x):
    return None if x is None else jnp.asarray(x)


def _torch(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _assert_triple(got, want):
    for g, w, name in zip(got, want, ("acc", "m", "den")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("with_rpe", [False, True])
def test_band_plain_matches_pallas(with_rpe):
    jp, tp, qkv, tables = _case(0, with_rpe)
    kw = dict(window_size=WS, quant_size=QUANT, scale=SCALE, band=BAND,
              tile=TILE)
    want = jax_band(*map(_jnp, qkv), jp.xyz_sorted, jp.seg_start, jp.seg_end,
                    jp.valid_sorted, *map(_jnp, tables), **kw,
                    w_chunk=WCHUNK, interpret=True)
    got = band_attention(*map(_torch, qkv), tp.xyz_sorted, tp.seg_start,
                         tp.seg_end, tp.valid_sorted, *map(_torch, tables),
                         **kw)
    _assert_triple(got, want)
    # the case is not degenerate: rows see keys
    assert float(got[2].max()) > 0


@pytest.mark.parametrize("with_rpe", [False, True])
def test_sparse_plain_matches_pallas(with_rpe):
    jp, tp, qkv, tables = _case(1, with_rpe)
    kw = dict(window_size=WS, quant_size=QUANT, scale=SCALE, s_band=S_BAND,
              tile=TILE)
    want = jax_sparse(*map(_jnp, qkv), jp.sparse_band, *map(_jnp, tables),
                      **kw, w_chunk=WCHUNK, interpret=True)
    got = sparse_band_attention(*map(_torch, qkv), tp.sparse_band,
                                *map(_torch, tables), **kw)
    _assert_triple(got, want)
    assert float(got[2].max()) > 0


@pytest.mark.parametrize("with_rpe", [False, True])
def test_merged_output_matches_fused(with_rpe):
    jp, tp, qkv, tables = _case(2, with_rpe)
    kw = dict(window_size=WS, quant_size=QUANT, scale=SCALE, band=BAND,
              tile=TILE, s_band=S_BAND)
    want = jax_fused(*map(_jnp, qkv), jp.xyz_sorted, jp.seg_start,
                     jp.seg_end, jp.valid_sorted,
                     sparse_band=jp.sparse_band,
                     table_q=_jnp(tables[0]), table_k=_jnp(tables[1]),
                     table_v=_jnp(tables[2]), **kw, w_chunk=WCHUNK,
                     interpret=True)
    for plain in (False, True):
        got = stratified_attention_fused(
            *map(_torch, qkv), tp.xyz_sorted, tp.seg_start, tp.seg_end,
            tp.valid_sorted, tp.sparse_band, *map(_torch, tables), **kw,
            plain=plain)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


def bin_sweep(ws, qs, n=1 << 14, seed=0):
    """Relative coordinates dense at the quantization boundaries: random
    1e-5 lattice points, the exact bin edges and their 1-ulp neighbours
    (the design of tools/bin_math_probe.py)."""
    rng = np.random.default_rng(seed)
    bounds = (np.arange(64) * qs - 2 * ws + 1e-4).astype(np.float32)
    lattice = np.round(rng.uniform(-2 * ws, 2 * ws, n) * 1e5) / 1e5
    return np.concatenate([
        lattice.astype(np.float32), bounds,
        np.nextafter(bounds, np.float32(-np.inf)),
        np.nextafter(bounds, np.float32(np.inf)),
        (bounds + np.float32(1e-5)).astype(np.float32)]).astype(np.float32)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_bins_exact_on_boundary_sweep(stage):
    ws, qs = 0.16 * 2 ** stage, 0.01 * 2 ** stage
    rel = bin_sweep(ws, qs)
    want = np.asarray(jax_attn.relative_position_index(
        jnp.asarray(rel), ws, qs, 64))
    got = torch_attn.relative_position_index(torch.from_numpy(rel), ws, qs,
                                             64).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 32


@pytest.mark.parametrize("rpe_mode,fast,symbol", [
    ("swin_window", False, "band_attention_swin_limits"),
    ("swin_window", True, "band_attention_bf16_limits"),
    ("stratified", False, "band_attention_limits"),
    ("stratified", True, "band_attention_bf16_limits")])
def test_band_forward_asks_each_form_its_own_limits(monkeypatch, rpe_mode,
                                                    fast, symbol):
    """The band forward's wrapper asks the fp32 swin mode's own limits
    (``band_attention_swin_limits``: its routine's blocks and shared
    memory), the bf16 form its own whether swin or not, and the stratified
    fp32 form ``band_attention_limits``; it refuses tables beyond the
    limit it is given before it touches the card."""
    from stratified_transformer_torch import kernels
    from stratified_transformer_torch.kernels import band_attention as band_k
    asked = []
    monkeypatch.setattr(kernels, "_limits",
                        lambda *a: asked.append(a) or (64, 0))
    monkeypatch.setattr(band_k, "check_cuda_inputs",
                        lambda name, tensors: torch.device("cuda", 0))
    n, h, d = 128, 1, 16
    q = torch.zeros(n, h, d)
    seg = torch.zeros(n, dtype=torch.int32)
    tables = (torch.zeros(31, h, d, 3),) * 3
    with pytest.raises(ValueError, match="table rows per axis"):
        band_k.launch_args(q, q, q, torch.zeros(n, 3), seg, seg,
                           torch.ones(n, dtype=torch.bool), *tables,
                           window_size=0.16, quant_size=0.01, scale=0.25,
                           band=0, fast=fast, rpe_mode=rpe_mode)
    assert asked == [("band_attention", symbol, 0, None)]
