"""PyTorch port, attention backward: the plain versions of the two backward
kernels against the JAX package's Pallas backward kernels in interpret mode
(at the point of ``tests/test_pallas_attention.py``), the autograd Function
against ``jax.grad`` of the JAX fused and jnp attention (including a band
that is no multiple of the tile), and against torch autograd through the
plain forward versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratified_transformer_tpu.ops import attention as jax_attn
from stratified_transformer_tpu.ops import plan as jax_plan
from stratified_transformer_tpu.ops.attention_fused import (
    stratified_attention_fused as jax_fused)
from stratified_transformer_tpu.ops.pallas.fused_attention_bwd import (
    band_attention_bwd as jax_band_bwd,
    sparse_band_attention_bwd as jax_sparse_bwd)
from stratified_transformer_torch.kernels.band_attention_bwd import (
    band_attention_bwd)
from stratified_transformer_torch.kernels.sparse_band_attention_bwd import (
    sparse_band_attention_bwd)
from stratified_transformer_torch.ops import attention as torch_attn
from stratified_transformer_torch.ops import plan as torch_plan
from stratified_transformer_torch.ops.attention_fused import (
    stratified_attention_fused)

torch.set_num_threads(1)

H, D = 2, 8
QUANT = 0.125
SCALE = D ** -0.5
TILE, BAND, WCHUNK, S_BAND = 32, 32, 32, 64
# as tests/test_pallas_attention.py:91-94 between the Pallas backward and
# jax.grad of the jnp path: fp32 sums in another order (per-tile partials,
# bin masses, the two halves' grads added)
RTOL, ATOL = 5e-4, 5e-5
NAMES = ("q", "k", "v", "tq", "tk", "tv")


def _case(seed, with_rpe, n_valid=100, n_pad=128, ws=0.5, quant=QUANT):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 2, (n_pad, 3)).astype(np.float32)
    batch = np.sort(rng.integers(0, 2, n_valid)).astype(np.int32)
    batch = np.concatenate([batch, np.full(n_pad - n_valid, 2, np.int32)])
    valid = np.arange(n_pad) < n_valid
    q, k, v, g = (rng.normal(size=(n_pad, H, D)).astype(np.float32)
                  for _ in range(4))
    is_down = (rng.uniform(size=n_pad) < 0.4) & valid
    nbins = 2 * int((2 * ws + 1e-4) // quant)
    tables = tuple(
        (rng.normal(size=(nbins, H, D, 3)) * 0.05).astype(np.float32)
        if with_rpe else None for _ in range(3))
    jp = jax_plan.build_attention_plan(
        jnp.asarray(xyz), jnp.asarray(batch), jnp.asarray(valid), ws,
        shifted=False, is_down=jnp.asarray(is_down), sparse_cap=16)
    tp = torch_plan.build_attention_plan(
        torch.from_numpy(xyz), torch.from_numpy(batch),
        torch.from_numpy(valid), ws, shifted=False,
        is_down=torch.from_numpy(is_down), sparse_cap=16)
    o = np.asarray(jp.order)
    return jp, tp, (q[o], k[o], v[o]), tables, g


def _jnp(x):
    return None if x is None else jnp.asarray(x)


def _torch(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _residuals(tp, qkv, tables, kw, band):
    """Merged ``(out, m, den)`` of both halves (plain forward versions)."""
    args = tuple(map(_torch, qkv))
    tt = tuple(map(_torch, tables))
    parts = [torch_attn.band_attention_plain(
        *args, tp.xyz_sorted, tp.seg_start, tp.seg_end, tp.valid_sorted,
        *tt, **kw, band=band, tile=TILE),
        torch_attn.sparse_band_attention_plain(
            *args, tp.sparse_band, *tt, **kw, s_band=S_BAND, tile=TILE)]
    return torch_attn.merge(parts)


def _assert_grads(got, want, rtol=RTOL, atol=ATOL):
    for g_, w_, name in zip(got, want, NAMES):
        if w_ is None:
            assert g_ is None, name
            continue
        np.testing.assert_allclose(np.asarray(g_), np.asarray(w_),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("with_rpe", [False, True])
def test_band_bwd_plain_matches_pallas(with_rpe):
    jp, tp, qkv, tables, g = _case(0, with_rpe)
    kw = dict(window_size=0.5, quant_size=QUANT, scale=SCALE)
    out, m, den = _residuals(tp, qkv, tables, kw, BAND)
    res = (g, out.numpy(), m.numpy(), den.numpy())
    want = jax_band_bwd(*map(_jnp, qkv), jp.xyz_sorted, jp.seg_start,
                        jp.seg_end, jp.valid_sorted, *map(_jnp, res),
                        *map(_jnp, tables), **kw, band=BAND, tile=TILE,
                        w_chunk=WCHUNK, interpret=True)
    got = band_attention_bwd(*map(_torch, qkv), tp.xyz_sorted, tp.seg_start,
                             tp.seg_end, tp.valid_sorted,
                             *map(_torch, res), *map(_torch, tables), **kw,
                             band=BAND, tile=TILE)
    _assert_grads(got, want)
    assert float(got[1].abs().max()) > 1e-2      # keys receive gradient


def test_band_bwd_plain_band_wider_than_input():
    """band 96 > N = 64: every tile's window covers the whole input
    (``tests/test_pallas_attention.py:231``)."""
    jp, tp, qkv, tables, g = _case(3, True, n_valid=50, n_pad=64, ws=0.6)
    kw = dict(window_size=0.6, quant_size=QUANT, scale=SCALE)
    out, m, den = torch_attn.merge([torch_attn.band_attention_plain(
        *map(_torch, qkv), tp.xyz_sorted, tp.seg_start, tp.seg_end,
        tp.valid_sorted, *map(_torch, tables), **kw, band=96, tile=TILE)])
    res = (g, out.numpy(), m.numpy(), den.numpy())
    want = jax_band_bwd(*map(_jnp, qkv), jp.xyz_sorted, jp.seg_start,
                        jp.seg_end, jp.valid_sorted, *map(_jnp, res),
                        *map(_jnp, tables), **kw, band=96, tile=TILE,
                        w_chunk=WCHUNK, interpret=True)
    got = band_attention_bwd(*map(_torch, qkv), tp.xyz_sorted, tp.seg_start,
                             tp.seg_end, tp.valid_sorted,
                             *map(_torch, res), *map(_torch, tables), **kw,
                             band=96, tile=TILE)
    _assert_grads(got, want)


@pytest.mark.parametrize("with_rpe", [False, True])
def test_sparse_bwd_plain_matches_pallas(with_rpe):
    jp, tp, qkv, tables, g = _case(1, with_rpe)
    kw = dict(window_size=0.5, quant_size=QUANT, scale=SCALE)
    out, m, den = _residuals(tp, qkv, tables, kw, BAND)
    res = (g, out.numpy(), m.numpy(), den.numpy())
    want = jax_sparse_bwd(*map(_jnp, qkv), jp.sparse_band, *map(_jnp, res),
                          *map(_jnp, tables), **kw, s_band=S_BAND,
                          tile=TILE, w_chunk=WCHUNK, interpret=True)
    got = sparse_band_attention_bwd(*map(_torch, qkv), tp.sparse_band,
                                    *map(_torch, res), *map(_torch, tables),
                                    **kw, s_band=S_BAND, tile=TILE)
    _assert_grads(got, want)
    assert float(got[1].abs().max()) > 1e-2


@pytest.mark.parametrize("half", ["band", "sparse"])
def test_bwd_plain_matches_pallas_at_scannet_table_rows(half):
    """ScanNet's table size, 80 rows per axis (window 5 x 0.02 m, quant
    0.005; here window 0.5, quant 0.025, the same count), so a band slice of
    48 rows: both plain backward versions against the Pallas kernels."""
    quant = 0.025
    jp, tp, qkv, tables, g = _case(6, True, quant=quant)
    assert tables[0].shape[0] == 80
    assert torch_attn.band_table_slice(80)[1] == 48
    kw = dict(window_size=0.5, quant_size=quant, scale=SCALE)
    out, m, den = _residuals(tp, qkv, tables, kw, BAND)
    res = (g, out.numpy(), m.numpy(), den.numpy())
    if half == "band":
        want = jax_band_bwd(*map(_jnp, qkv), jp.xyz_sorted, jp.seg_start,
                            jp.seg_end, jp.valid_sorted, *map(_jnp, res),
                            *map(_jnp, tables), **kw, band=BAND, tile=TILE,
                            w_chunk=WCHUNK, interpret=True)
        got = band_attention_bwd(*map(_torch, qkv), tp.xyz_sorted,
                                 tp.seg_start, tp.seg_end, tp.valid_sorted,
                                 *map(_torch, res), *map(_torch, tables),
                                 **kw, band=BAND, tile=TILE)
    else:
        want = jax_sparse_bwd(*map(_jnp, qkv), jp.sparse_band,
                              *map(_jnp, res), *map(_jnp, tables), **kw,
                              s_band=S_BAND, tile=TILE, w_chunk=WCHUNK,
                              interpret=True)
        got = sparse_band_attention_bwd(*map(_torch, qkv), tp.sparse_band,
                                        *map(_torch, res),
                                        *map(_torch, tables), **kw,
                                        s_band=S_BAND, tile=TILE)
    _assert_grads(got, want)
    assert float(got[1].abs().max()) > 1e-2
    # the table grads reach rows of the whole table
    assert float(got[4].abs().max()) > 0


def _function_grads(tp, qkv, tables, g, kw, plain=False):
    leaves = [None if x is None else _torch(x).requires_grad_(True)
              for x in tuple(qkv) + tuple(tables)]
    out = stratified_attention_fused(
        *leaves[:3], tp.xyz_sorted, tp.seg_start, tp.seg_end,
        tp.valid_sorted, tp.sparse_band, *leaves[3:], **kw, plain=plain)
    (out * _torch(g)).sum().backward()
    return [None if x is None else x.grad.numpy() for x in leaves]


@pytest.fixture(scope="module")
def fused_case():
    """A case and ``jax.grad`` of the JAX fused attention on it, with its
    Pallas backward in interpret mode."""
    jp, tp, qkv, tables, g = _case(2, True)
    kw = dict(window_size=0.5, quant_size=QUANT, scale=SCALE, band=BAND,
              tile=TILE, s_band=S_BAND)

    def loss(q, k, v, tq, tk, tv):
        out = jax_fused(q, k, v, jp.xyz_sorted, jp.seg_start, jp.seg_end,
                        jp.valid_sorted, sparse_band=jp.sparse_band,
                        table_q=tq, table_k=tk, table_v=tv, **kw,
                        w_chunk=WCHUNK, interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=tuple(range(6)))(
        *map(_jnp, tuple(qkv) + tuple(tables)))
    return tp, qkv, tables, g, kw, want


@pytest.mark.parametrize("plain", [False, True])
def test_function_matches_jax_fused_grads(fused_case, plain):
    """All six grads of the autograd Function (kernel wrappers, which run
    the plain versions on the CPU, and ``plain=True``) against the JAX
    fused attention's; the halves' grads rest on the MERGED statistics."""
    tp, qkv, tables, g, kw, want = fused_case
    _assert_grads(_function_grads(tp, qkv, tables, g, kw, plain), want)


def test_band_not_multiple_of_tile_matches_jnp_grads():
    """band 48 with tile 32 (stage 3 runs band 192 with tile 128): the
    Pallas backward refuses it, the port composes dk/dv by absolute key
    position. Reference: ``jax.grad`` of the jnp ``stratified_attention``."""
    jp, tp, qkv, tables, g = _case(4, True, n_valid=110)
    kw = dict(window_size=0.5, quant_size=QUANT, scale=SCALE, band=48,
              tile=TILE)

    def loss(q, k, v, tq, tk, tv):
        out = jax_attn.stratified_attention(
            q, k, v, jp.xyz_sorted, jp.seg_start, jp.seg_end,
            jp.valid_sorted, sparse_band=jp.sparse_band, table_q=tq,
            table_k=tk, table_v=tv, s_band=S_BAND, **kw)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=tuple(range(6)))(
        *map(_jnp, tuple(qkv) + tuple(tables)))
    got = _function_grads(tp, qkv, tables, g, dict(kw, s_band=S_BAND))
    _assert_grads(got, want)
    # the band reaches keys beyond the tile-aligned windows of band 32
    np.testing.assert_array_less(0.0, np.abs(got[1]).max())


@pytest.mark.parametrize("with_rpe", [False, True])
def test_function_matches_autograd_of_plain_forward(with_rpe):
    """The explicit backward against torch autograd through the plain
    forward versions and `merge`: an independent check of the backward
    formulas."""
    _, tp, qkv, tables, g = _case(5, with_rpe)
    kw = dict(window_size=0.5, quant_size=QUANT, scale=SCALE)
    leaves = [None if x is None else _torch(x).requires_grad_(True)
              for x in tuple(qkv) + tuple(tables)]
    parts = [torch_attn.band_attention_plain(
        *leaves[:3], tp.xyz_sorted, tp.seg_start, tp.seg_end,
        tp.valid_sorted, *leaves[3:], **kw, band=BAND, tile=TILE),
        torch_attn.sparse_band_attention_plain(
            *leaves[:3], tp.sparse_band, *leaves[3:], **kw, s_band=S_BAND,
            tile=TILE)]
    (torch_attn.merge(parts)[0] * _torch(g)).sum().backward()
    want = [None if x is None else x.grad.numpy() for x in leaves]
    got = _function_grads(tp, qkv, tables, g,
                          dict(kw, band=BAND, tile=TILE, s_band=S_BAND))
    # both sides are this package's fp32 arithmetic: 1e-4 / 1e-5
    _assert_grads(got, want, rtol=1e-4, atol=1e-5)


def test_compose_band_by_absolute_position():
    """Slot s of tile t lands on key t*tile - band + s, for a band that is
    no multiple of the tile; slots outside [0, N) are dropped."""
    n, tile, band = 96, 32, 20
    nt, w = n // tile, tile + 2 * band
    part = torch.arange(nt * w, dtype=torch.float64).reshape(nt, w)
    want = torch.zeros(n, dtype=torch.float64)
    for t in range(nt):
        for s in range(w):
            if 0 <= t * tile - band + s < n:
                want[t * tile - band + s] += part[t, s]
    torch.testing.assert_close(
        torch_attn.compose_band(part, band, tile, n), want, rtol=0, atol=0)


def test_rows16_gives_the_backward_kernels_aligned_rows():
    """The fp32 backward wrappers hand their kernels q, g, k and v whose
    data starts on 16 bytes (the kernels copy rows by cp.async and their
    launchers refuse others): `rows16` keeps an aligned contiguous fp32
    tensor as it is and copies any other, values unchanged."""
    from stratified_transformer_torch.kernels import rows16
    base = torch.randn(4 * 3 * 16 + 1)
    shifted = base[1:].view(4, 3, 16)
    assert shifted.data_ptr() % 16 != 0
    for t in (shifted, torch.randn(4, 3, 16, dtype=torch.float64),
              torch.randn(4, 16, 3).transpose(1, 2)):
        got = rows16(t)
        assert got.data_ptr() % 16 == 0 and got.is_contiguous()
        assert got.dtype == torch.float32
        assert torch.equal(got, t.to(torch.float32))
    aligned = torch.randn(4, 3, 16)
    assert aligned.data_ptr() % 16 == 0 and rows16(aligned) is aligned


def test_block_limits_asks_each_form_its_own_entry_point(monkeypatch):
    """`block_limits` asks the fp32 band backward's swin mode its own
    heights (``band_attention_bwd_swin_limits``: 32-row blocks, two per
    SM), the bf16 form its own whether swin or not, and the stratified
    fp32 form ``<source>_limits``."""
    from stratified_transformer_torch import kernels
    asked = []
    monkeypatch.setattr(kernels, "_limits",
                        lambda *a: asked.append(a) or (32, 112))
    dev = torch.device("cuda", 0)
    kernels.block_limits("band_attention_bwd", dev, 31, swin=True)
    kernels.block_limits("band_attention_bwd", dev, 31, fast=True, swin=True)
    kernels.block_limits("band_attention_bwd", dev, 40)
    kernels.block_limits("band_attention", dev)
    assert asked == [
        ("band_attention_bwd", "band_attention_bwd_swin_limits", 0, 31),
        ("band_attention_bwd", "band_attention_bwd_bf16_limits", 0, 31),
        ("band_attention_bwd", "band_attention_bwd_limits", 0, 40),
        ("band_attention", "band_attention_limits", 0, None)]
