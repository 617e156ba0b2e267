"""CUDA kernels of the PyTorch port (attention forward and backward, the two
probes) against their plain PyTorch versions, and the kernels' limits,
empty rows and determinism.

Marked ``cuda``: each test asks the ``cuda_device`` fixture for the card
and is skipped where there is none. Run them on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest`` because ``tests/conftest.py`` imports JAX, which the GPU
machine need not have.)
"""

import numpy as np
import pytest
import torch

from stratified_transformer_torch.kernels import band_attention as band_k
from stratified_transformer_torch.kernels import band_attention_bwd as band_bwd_k
from stratified_transformer_torch.kernels import sparse_band_attention as sparse_k
from stratified_transformer_torch.kernels import (
    sparse_band_attention_bwd as sparse_bwd_k)
from stratified_transformer_torch.ops import attention as plain
from stratified_transformer_torch.ops import plan as plan_mod
from stratified_transformer_torch.tools import bin_math_probe, cache_key_probe

# kernel vs plain version, both fp32: sums in another order
RTOL, ATOL = 2e-4, 2e-5
# backward kernel vs plain version: as the JAX package holds its Pallas
# backward against jax.grad (tests/test_pallas_attention.py:91-94); the
# table grads sum many pair terms through bin masses in another order
BWD_RTOL, BWD_ATOL = 5e-4, 5e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _case(dev, d, with_rpe, seed=0, n_pad=512, n_valid=450, h=3, ws=0.5,
          quant=0.0625):
    gen = torch.Generator().manual_seed(seed)
    xyz = torch.rand(n_pad, 3, generator=gen) * 2.0
    batch = torch.cat([torch.zeros(n_valid // 2, dtype=torch.int32),
                       torch.ones(n_valid - n_valid // 2, dtype=torch.int32),
                       torch.full((n_pad - n_valid,), 2, dtype=torch.int32)])
    valid = torch.arange(n_pad) < n_valid
    is_down = (torch.rand(n_pad, generator=gen) < 0.3) & valid
    plan = plan_mod.build_attention_plan(
        xyz.to(dev), batch.to(dev), valid.to(dev), ws, shifted=True,
        is_down=is_down.to(dev), sparse_cap=16)
    nbins = 2 * int((2 * ws + 1e-4) // quant)
    q, k, v = (torch.randn(n_pad, h, d, generator=gen).to(dev)
               for _ in range(3))
    tables = tuple((torch.randn(nbins, h, d, 3, generator=gen) * 0.05).to(dev)
                   if with_rpe else None for _ in range(3))
    kw = dict(window_size=ws, quant_size=quant, scale=d ** -0.5)
    return plan, (q, k, v), tables, kw


def _assert_triple(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("with_rpe", [False, True])
def test_band_kernel_matches_plain(cuda_device, with_rpe):
    plan, qkv, tables, kw = _case(cuda_device, 16, with_rpe)
    args = qkv + (plan.xyz_sorted, plan.seg_start, plan.seg_end,
                  plan.valid_sorted) + tables
    before = band_k.KERNEL.launches
    with torch.no_grad():
        got = band_k.band_attention(*args, **kw, band=128, tile=128)
        want = plain.band_attention_plain(*args, **kw, band=128, tile=128)
    torch.cuda.synchronize()
    assert band_k.KERNEL.launches == before + 1
    _assert_triple(got, want)
    assert float(want[2].max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("with_rpe", [False, True])
def test_sparse_kernel_matches_plain(cuda_device, with_rpe):
    plan, qkv, tables, kw = _case(cuda_device, 16, with_rpe, seed=1)
    before = sparse_k.KERNEL.launches
    with torch.no_grad():
        got = sparse_k.sparse_band_attention(
            *qkv, plan.sparse_band, *tables, **kw, s_band=64, tile=128)
        want = plain.sparse_band_attention_plain(
            *qkv, plan.sparse_band, *tables, **kw, s_band=64, tile=128)
    torch.cuda.synchronize()
    assert sparse_k.KERNEL.launches == before + 1
    _assert_triple(got, want)
    assert float(want[2].max()) > 0


@pytest.mark.cuda
def test_kernel_bins_match_cpu(cuda_device):
    ws, qs = 0.64, 0.04
    rng = np.random.default_rng(0)
    bounds = (np.arange(64) * qs - 2 * ws + 1e-4).astype(np.float32)
    rel = np.concatenate([
        (np.round(rng.uniform(-2 * ws, 2 * ws, 4096) * 1e5) / 1e5
         ).astype(np.float32), bounds,
        np.nextafter(bounds, np.float32(-np.inf)),
        np.nextafter(bounds, np.float32(np.inf))]).astype(np.float32)
    rel = torch.from_numpy(rel)
    want = plain.relative_position_index(rel, ws, qs, 64)
    got = band_k.rel_bins(rel.to(cuda_device), ws, qs, 64).cpu().long()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_refuses_gradients(cuda_device):
    plan, (q, k, v), tables, kw = _case(cuda_device, 16, True)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="autograd Function"):
        band_k.band_attention(q, k, v, plan.xyz_sorted, plan.seg_start,
                              plan.seg_end, plan.valid_sorted, *tables, **kw,
                              band=128, tile=128)


@pytest.mark.cuda
def test_cuda_plan_equals_cpu_plan(cuda_device):
    plan_gpu = _case(cuda_device, 16, False)[0]
    plan_cpu = _case(torch.device("cpu"), 16, False)[0]
    for name in ("order", "inv_order", "seg_start", "seg_end"):
        torch.testing.assert_close(getattr(plan_gpu, name).cpu(),
                                   getattr(plan_cpu, name), rtol=0, atol=0)
    for a, b in zip(plan_gpu.sparse_band, plan_cpu.sparse_band):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0)


def _bwd_case(dev, with_rpe, band, seed, **case):
    """Inputs of both backward kernels: random q/k/v/tables and cotangent,
    and the merged forward residuals of the plain versions."""
    plan, (q, k, v), tables, kw = _case(dev, 16, with_rpe, seed=seed,
                                        **case)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(seed)
                    ).to(dev)
    with torch.no_grad():
        parts = [plain.band_attention_plain(
            q, k, v, plan.xyz_sorted, plan.seg_start, plan.seg_end,
            plan.valid_sorted, *tables, **kw, band=band, tile=128),
            plain.sparse_band_attention_plain(
                q, k, v, plan.sparse_band, *tables, **kw, s_band=64,
                tile=128)]
        out, m, den = plain.merge(parts)
    return plan, (q, k, v), tables, kw, (g, out, m, den)


def _assert_grads(got, want):
    for name, g_, w_ in zip(("dq", "dk", "dv", "dtq", "dtk", "dtv"), got,
                            want):
        if w_ is None:
            assert g_ is None, name
            continue
        torch.testing.assert_close(g_, w_, rtol=BWD_RTOL, atol=BWD_ATOL,
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("with_rpe", [False, True])
@pytest.mark.parametrize("band", [128, 192])
def test_band_bwd_kernel_matches_plain(cuda_device, with_rpe, band):
    """band 192 with tile 128 is stage 3 of the S3DIS configuration: the
    slots are composed by absolute key position."""
    plan, qkv, tables, kw, res = _bwd_case(cuda_device, with_rpe, band, 2)
    args = qkv + (plan.xyz_sorted, plan.seg_start, plan.seg_end,
                  plan.valid_sorted) + res + tables
    before = band_bwd_k.KERNEL.launches
    with torch.no_grad():
        got = band_bwd_k.band_attention_bwd(*args, **kw, band=band, tile=128)
        want = plain.band_attention_bwd_plain(*args, **kw, band=band,
                                              tile=128)
    torch.cuda.synchronize()
    assert band_bwd_k.KERNEL.launches == before + 1
    _assert_grads(got, want)
    assert float(want[1].abs().max()) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("with_rpe", [False, True])
def test_sparse_bwd_kernel_matches_plain(cuda_device, with_rpe):
    plan, qkv, tables, kw, res = _bwd_case(cuda_device, with_rpe, 128, 3)
    before = sparse_bwd_k.KERNEL.launches
    with torch.no_grad():
        got = sparse_bwd_k.sparse_band_attention_bwd(
            *qkv, plan.sparse_band, *res, *tables, **kw, s_band=64,
            tile=128)
        want = plain.sparse_band_attention_bwd_plain(
            *qkv, plan.sparse_band, *res, *tables, **kw, s_band=64,
            tile=128)
    torch.cuda.synchronize()
    assert sparse_bwd_k.KERNEL.launches == before + 1
    _assert_grads(got, want)
    assert float(want[1].abs().max()) > 1e-2


# stage 2 of the S3DIS configuration: band 384, 12 heads, 64 bins per axis
# (window 0.64, quant 0.04), a few thousand points
STAGE2 = dict(n_pad=2688, n_valid=2500, h=12, ws=0.64, quant=0.04)


def _band_bwd_args(plan, qkv, tables, res):
    return qkv + (plan.xyz_sorted, plan.seg_start, plan.seg_end,
                  plan.valid_sorted) + res + tables


@pytest.mark.cuda
@pytest.mark.parametrize("with_rpe", [False, True])
def test_bwd_kernels_match_plain_at_stage2_shape(cuda_device, with_rpe):
    plan, qkv, tables, kw, res = _bwd_case(cuda_device, with_rpe, 384, 4,
                                           **STAGE2)
    if with_rpe:
        assert tables[0].shape[0] == 64
    args = _band_bwd_args(plan, qkv, tables, res)
    with torch.no_grad():
        got = band_bwd_k.band_attention_bwd(*args, **kw, band=384, tile=128)
        want = plain.band_attention_bwd_plain(*args, **kw, band=384,
                                              tile=128)
        got_s = sparse_bwd_k.sparse_band_attention_bwd(
            *qkv, plan.sparse_band, *res, *tables, **kw, s_band=128,
            tile=128)
        want_s = plain.sparse_band_attention_bwd_plain(
            *qkv, plan.sparse_band, *res, *tables, **kw, s_band=128,
            tile=128)
    torch.cuda.synchronize()
    _assert_grads(got, want)
    _assert_grads(got_s, want_s)
    assert float(want[1].abs().max()) > 1e-2
    assert float(want_s[1].abs().max()) > 1e-2


def _fwd_both(plan, qkv, tables, kw, band, s_band=128):
    """(kernel, plain) triples of both forward halves."""
    geom = (plan.xyz_sorted, plan.seg_start, plan.seg_end, plan.valid_sorted)
    with torch.no_grad():
        out = [(band_k.band_attention(*qkv, *geom, *tables, **kw, band=band,
                                      tile=128),
                plain.band_attention_plain(*qkv, *geom, *tables, **kw,
                                           band=band, tile=128)),
               (sparse_k.sparse_band_attention(
                   *qkv, plan.sparse_band, *tables, **kw, s_band=s_band,
                   tile=128),
                plain.sparse_band_attention_plain(
                    *qkv, plan.sparse_band, *tables, **kw, s_band=s_band,
                    tile=128))]
    torch.cuda.synchronize()
    return out


def _strided(qkv):
    """q, k, v as the model passes them: views of one [N, 3, h, d] tensor."""
    return torch.stack(qkv, 1).unbind(1)


@pytest.mark.cuda
def test_fwd_kernels_match_plain_at_stage2_shape(cuda_device):
    """Band 384, 12 heads, 64 bins (band slice 40), q/k/v as strided views
    of the qkv projection, which the kernels read in place."""
    plan, qkv, tables, kw = _case(cuda_device, 16, True, seed=7, **STAGE2)
    assert plain.band_table_slice(tables[0].shape[0])[1] == 40
    qkv = _strided(qkv)
    assert not qkv[0].is_contiguous()
    for got, want in _fwd_both(plan, qkv, tables, kw, 384):
        _assert_triple(got, want)
        assert float(want[2].max()) > 0


@pytest.mark.cuda
def test_fwd_kernels_take_scannet_table_sizes(cuda_device):
    """ScanNet's 80-bin tables (window 5 x 0.02, quant 0.005: here window
    0.4, quant 0.02): a band slice of 48 rows, 80 for the far keys."""
    plan, qkv, tables, kw = _case(cuda_device, 16, True, seed=8, ws=0.4,
                                  quant=0.02)
    assert tables[0].shape[0] == 80
    assert plain.band_table_slice(80)[1] == 48
    for name in ("band_attention", "sparse_band_attention"):
        from stratified_transformer_torch.kernels import block_limits
        assert block_limits(name, cuda_device)[1] >= 80
    for got, want in _fwd_both(plan, qkv, tables, kw, 128, 64):
        _assert_triple(got, want)
        assert float(want[2].max()) > 0


@pytest.mark.cuda
def test_fwd_kernels_rows_without_keys(cuda_device):
    """A tile of padding rows, and every other row with no key, comes out
    as m = -1e30, den = 0, acc = 0 exactly."""
    plan, qkv, tables, kw = _case(cuda_device, 16, True, seed=9, n_pad=640,
                                  n_valid=450)
    assert not bool(plan.valid_sorted[512:].any())     # tile 4: no row
    for got, want in _fwd_both(plan, qkv, tables, kw, 128, 64):
        _assert_triple(got, want)
        empty = want[1] == plain.NEG_INF
        assert bool(empty[512:].all()) and bool(empty.any())
        assert bool((got[1][empty] == plain.NEG_INF).all())
        assert bool((got[2][empty] == 0).all())
        assert bool((got[0][empty] == 0).all())


@pytest.mark.cuda
def test_fwd_kernels_are_deterministic(cuda_device):
    """Two launches on the same inputs give bit-identical triples: every sum
    of the forward kernels runs in a fixed order."""
    plan, qkv, tables, kw = _case(cuda_device, 16, True, seed=10, **STAGE2)
    geom = (plan.xyz_sorted, plan.seg_start, plan.seg_end, plan.valid_sorted)
    launches = {
        "band": (band_k, lambda: band_k.launch_args(
            *qkv, *geom, *tables, **kw, band=384, tile=128)),
        "sparse": (sparse_k, lambda: sparse_k.launch_args(
            *qkv, plan.sparse_band, *tables, **kw, s_band=128, tile=128)),
    }
    with torch.no_grad():
        for name, (mod, make) in launches.items():
            outs = []
            for _ in range(2):
                largs, out, _inputs = make()
                mod.KERNEL(*largs)
                torch.cuda.synchronize()
                outs.append(out)
            for o_name, a, b in zip(("acc", "m", "den"), *outs):
                assert torch.equal(a, b), (name, o_name)


@pytest.mark.cuda
def test_fwd_kernels_refuse_tables_beyond_their_limits(cuda_device):
    """Each library reports the most table rows per axis a block takes
    (``<source>_limits``); beyond it the wrapper raises before any launch."""
    from stratified_transformer_torch.kernels import block_limits
    plan, qkv, tables, kw = _case(cuda_device, 16, True, seed=11)
    band_rows, band_max = block_limits("band_attention", cuda_device)
    sparse_rows, sparse_max = block_limits("sparse_band_attention",
                                           cuda_device)
    assert band_rows == 64 and sparse_rows == 64
    assert band_max >= 48 and sparse_max >= 80
    nbf = next(b for b in range(2, 2048, 2)
               if plain.band_table_slice(b)[1] > band_max)
    gen = torch.Generator().manual_seed(11)

    def big(rows):
        return tuple(torch.randn((rows,) + t.shape[1:], generator=gen).to(
            cuda_device) * 0.05 for t in tables)

    geom = (plan.xyz_sorted, plan.seg_start, plan.seg_end, plan.valid_sorted)
    before = (band_k.KERNEL.launches, sparse_k.KERNEL.launches)
    with torch.no_grad():
        with pytest.raises(ValueError, match="shared memory"):
            band_k.band_attention(*qkv, *geom, *big(nbf), **kw, band=128,
                                  tile=128)
        with pytest.raises(ValueError, match="table rows per axis"):
            sparse_k.sparse_band_attention(
                *qkv, plan.sparse_band, *big(sparse_max + 2), **kw,
                s_band=64, tile=128)
    assert (band_k.KERNEL.launches, sparse_k.KERNEL.launches) == before


@pytest.mark.cuda
def test_bwd_kernels_are_deterministic(cuda_device):
    """Two launches on the same inputs give bit-identical outputs (dq, the
    dk/dv slots and the table partials): every sum of the backward kernels
    runs in a fixed order. (The sparse wrapper's scatter of the slots into
    points is PyTorch's ``index_add_``, which is not.)"""
    plan, qkv, tables, kw, res = _bwd_case(cuda_device, True, 384, 5,
                                           **STAGE2)
    args = _band_bwd_args(plan, qkv, tables, res)
    launches = {
        "band": (band_bwd_k, lambda: band_bwd_k.launch_args(
            *args, **kw, band=384, tile=128)),
        "sparse": (sparse_bwd_k, lambda: sparse_bwd_k.launch_args(
            *qkv, plan.sparse_band, *res, *tables, **kw, s_band=128,
            tile=128)),
    }
    with torch.no_grad():
        for name, (mod, make) in launches.items():
            outs = []
            for _ in range(2):
                largs, out, _inputs = make()
                mod.KERNEL(*largs)
                torch.cuda.synchronize()
                outs.append(out)
            for o_name, a, b in zip(("dq", "dk_part", "dv_part", "dt_part"),
                                    *outs):
                assert torch.equal(a, b), (name, o_name)
        got = [band_bwd_k.band_attention_bwd(*args, **kw, band=384,
                                             tile=128) for _ in range(2)]
    for a, b in zip(*got):
        assert torch.equal(a, b)


# ScanNet's 80-bin tables (grid 0.02, window 5 x 0.02, quant 0.005; here
# window 0.4, quant 0.02, the same bins): a band slice of 48 rows per axis
# and 80 for the far keys
SCANNET_TABLES = dict(ws=0.4, quant=0.02)


@pytest.mark.cuda
def test_bwd_kernels_pick_block_rows_by_table_size(cuda_device):
    """``<source>_limits`` gives the rows a launch takes for a table size:
    S3DIS's band slice (40) keeps 64-row blocks and its 64 far-key rows
    32-row blocks; ScanNet's band slice (48) takes 32-row blocks and its 80
    far-key rows 16-row blocks."""
    from stratified_transformer_torch.kernels import block_limits
    assert plain.band_table_slice(64)[1] == 40
    assert plain.band_table_slice(80)[1] == 48
    assert block_limits("band_attention_bwd", cuda_device, 40)[0] == 64
    assert block_limits("band_attention_bwd", cuda_device, 48)[0] == 32
    assert block_limits("sparse_band_attention_bwd", cuda_device, 64)[0] == 32
    assert block_limits("sparse_band_attention_bwd", cuda_device, 80)[0] == 16
    for name in ("band_attention_bwd", "sparse_band_attention_bwd"):
        assert block_limits(name, cuda_device, 0)[1] >= 80


@pytest.mark.cuda
@pytest.mark.parametrize("with_rpe", [False, True])
def test_bwd_kernels_match_plain_at_scannet_table_sizes(cuda_device,
                                                        with_rpe):
    plan, qkv, tables, kw, res = _bwd_case(cuda_device, with_rpe, 256, 12,
                                           **SCANNET_TABLES)
    if with_rpe:
        assert tables[0].shape[0] == 80
    args = _band_bwd_args(plan, qkv, tables, res)
    before = (band_bwd_k.KERNEL.launches, sparse_bwd_k.KERNEL.launches)
    with torch.no_grad():
        got = band_bwd_k.band_attention_bwd(*args, **kw, band=256, tile=128)
        want = plain.band_attention_bwd_plain(*args, **kw, band=256,
                                              tile=128)
        got_s = sparse_bwd_k.sparse_band_attention_bwd(
            *qkv, plan.sparse_band, *res, *tables, **kw, s_band=64,
            tile=128)
        want_s = plain.sparse_band_attention_bwd_plain(
            *qkv, plan.sparse_band, *res, *tables, **kw, s_band=64,
            tile=128)
    torch.cuda.synchronize()
    assert (band_bwd_k.KERNEL.launches,
            sparse_bwd_k.KERNEL.launches) == (before[0] + 1, before[1] + 1)
    _assert_grads(got, want)
    _assert_grads(got_s, want_s)
    assert float(want[1].abs().max()) > 1e-2
    assert float(want_s[1].abs().max()) > 1e-2


@pytest.mark.cuda
def test_bwd_kernels_are_deterministic_at_scannet_table_sizes(cuda_device):
    """As `test_bwd_kernels_are_deterministic`, with 80-row tables: the
    32-row band and 16-row sparse blocks sum in a fixed order too."""
    plan, qkv, tables, kw, res = _bwd_case(cuda_device, True, 256, 13,
                                           **SCANNET_TABLES)
    args = _band_bwd_args(plan, qkv, tables, res)
    launches = {
        "band": (band_bwd_k, lambda: band_bwd_k.launch_args(
            *args, **kw, band=256, tile=128)),
        "sparse": (sparse_bwd_k, lambda: sparse_bwd_k.launch_args(
            *qkv, plan.sparse_band, *res, *tables, **kw, s_band=64,
            tile=128)),
    }
    with torch.no_grad():
        for name, (mod, make) in launches.items():
            outs = []
            for _ in range(2):
                largs, out, _inputs = make()
                mod.KERNEL(*largs)
                torch.cuda.synchronize()
                outs.append(out)
            for o_name, a, b in zip(("dq", "dk_part", "dv_part", "dt_part"),
                                    *outs):
                assert torch.equal(a, b), (name, o_name)


@pytest.mark.cuda
def test_bwd_kernels_refuse_tables_beyond_their_limits(cuda_device):
    """Beyond the most table rows per axis that any block takes
    (``<source>_limits``), the wrappers raise before any launch."""
    from stratified_transformer_torch.kernels import block_limits
    band_max = block_limits("band_attention_bwd", cuda_device, 0)[1]
    sparse_max = block_limits("sparse_band_attention_bwd", cuda_device, 0)[1]
    assert block_limits("band_attention_bwd", cuda_device,
                        band_max + 1)[0] == 0
    nbf = next(b for b in range(2, 4096, 2)
               if plain.band_table_slice(b)[1] > band_max)
    plan, qkv, tables, kw, res = _bwd_case(cuda_device, True, 128, 6)
    gen = torch.Generator().manual_seed(6)

    def big(rows):
        return tuple(torch.randn((rows,) + t.shape[1:], generator=gen).to(
            cuda_device) * 0.05 for t in tables)

    before = (band_bwd_k.KERNEL.launches, sparse_bwd_k.KERNEL.launches)
    with torch.no_grad():
        with pytest.raises(ValueError, match="shared memory"):
            band_bwd_k.band_attention_bwd(
                *_band_bwd_args(plan, qkv, big(nbf), res), **kw, band=128,
                tile=128)
        with pytest.raises(ValueError,
                           match=f"{sparse_max + 2} table rows"):
            sparse_bwd_k.sparse_band_attention_bwd(
                *qkv, plan.sparse_band, *res, *big(sparse_max + 2), **kw,
                s_band=64, tile=128)
    assert (band_bwd_k.KERNEL.launches,
            sparse_bwd_k.KERNEL.launches) == before


@pytest.mark.cuda
def test_bin_math_probe_kernel_equals_cpu(cuda_device):
    x = torch.from_numpy(bin_math_probe.sweep())
    before = bin_math_probe.KERNEL.launches
    got = bin_math_probe.bin_formula(x.to(cuda_device), bin_math_probe.WS,
                                     bin_math_probe.QS)
    torch.cuda.synchronize()
    assert bin_math_probe.KERNEL.launches == before + 1
    want = bin_math_probe.bin_formula_plain(x, bin_math_probe.WS,
                                            bin_math_probe.QS)
    assert got.dtype == torch.int32 and got.shape == (256, 256)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cache_key_probe_kernel_doubles(cuda_device):
    x = torch.randn(128, 128, generator=torch.Generator().manual_seed(0))
    before = cache_key_probe.KERNEL.launches
    got = cache_key_probe.times_two(x.to(cuda_device))
    torch.cuda.synchronize()
    assert cache_key_probe.KERNEL.launches == before + 1
    assert torch.equal(got.cpu(), cache_key_probe.times_two_plain(x))


def _narrow_cfg(**kw):
    from stratified_transformer_torch.config import StratifiedConfig
    return StratifiedConfig(channels=(16, 32, 64, 128), num_heads=(1, 2, 4, 8),
                            depths=(1, 1, 2, 1), n_pad=4096, num_scenes=2,
                            band_per_stage=(128, 128, 384, 192), **kw)


@pytest.mark.cuda
def test_on_device_geometry_equals_the_cpu(cuda_device):
    from stratified_transformer_torch.data.loader import example_batch
    from stratified_transformer_torch.models.stratified import (
        geometry_pyramid, stem_neighbors)
    from stratified_transformer_torch.ops import sampling
    cfg = _narrow_cfg()
    b = example_batch(cfg.n_pad, cfg.num_scenes, seed=1)
    xyz = torch.from_numpy(b.xyz)
    off = torch.from_numpy(b.offsets.astype(np.int64))
    d_off = sampling.counts_to_offsets(sampling.floor_ratio_counts(
        off - sampling.scene_starts(off), 0.125))

    def run(dev):
        x, o, d = xyz.to(dev), off.to(dev), d_off.to(dev)
        return [stem_neighbors(cfg, x, o), geometry_pyramid(cfg, x, o),
                sampling.farthest_point_sampling(x, o, d, 520),
                sampling.blocked_fps(x, o, d, 520, 0.64)]

    def leaves(tree):
        if isinstance(tree, dict):
            return [v for k in sorted(tree) for v in leaves(tree[k])]
        if isinstance(tree, (tuple, list)):
            return [v for t in tree for v in leaves(t)]
        return [tree]

    got, want = leaves(run(cuda_device)), leaves(run("cpu"))
    assert len(got) == len(want) == 31
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_forward_without_pyramid_launches_the_kernels(cuda_device):
    import dataclasses

    from stratified_transformer_torch.data.loader import example_batch
    from stratified_transformer_torch.models.stratified import build_model
    cfg = _narrow_cfg()
    b = example_batch(cfg.n_pad, cfg.num_scenes, seed=2)
    args = (torch.from_numpy(b.feats).to(cuda_device),
            torch.from_numpy(b.xyz).to(cuda_device),
            torch.from_numpy(b.offsets.astype(np.int64)).to(cuda_device))
    model = build_model(cfg, cuda_device, seed=0)
    ref = build_model(dataclasses.replace(cfg, attn_impl="reference"),
                      cuda_device, seed=0)
    before = (band_k.KERNEL.launches, sparse_k.KERNEL.launches)
    with torch.no_grad():
        got = model(*args)[0]
        launched = (band_k.KERNEL.launches - before[0],
                    sparse_k.KERNEL.launches - before[1])
        want = ref(*args)[0]
    assert launched == (sum(cfg.depths),) * 2
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
