"""CUDA kernels of the PyTorch port (attention forward and backward, the two
probes, the masked row gather) against their plain PyTorch versions, and
the kernels' limits, empty rows and determinism; the band kernels' swin
mode (Swin3D's window-quantized bins).

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
from stratified_transformer_torch.kernels import gather_rows as gather_k
from stratified_transformer_torch.kernels import sparse_band_attention as sparse_k
from stratified_transformer_torch.kernels import (
    sparse_band_attention_bwd as sparse_bwd_k)
from stratified_transformer_torch.ops import attention as plain
from stratified_transformer_torch.ops.neighbors import GatherRows
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
    of the forward kernels runs in a fixed order, in their fp32 forms
    (``KERNEL``), their bf16 forms on the tensor cores (``KERNEL_FAST``,
    whose bin masses are walked in a fixed order) and the band kernel's
    swin mode in bf16."""
    plan, qkv, tables, kw = _case(cuda_device, 16, True, seed=10, **STAGE2)
    geom = (plan.xyz_sorted, plan.seg_start, plan.seg_end, plan.valid_sorted)
    sgeom, sqkv, _, stables, skw = _swin_case(cuda_device, 10, True)
    launches = {}
    for fast in (False, True):
        kernel = "KERNEL_FAST" if fast else "KERNEL"
        launches[f"band {kernel}"] = (
            getattr(band_k, kernel), lambda f=fast: band_k.launch_args(
                *qkv, *geom, *tables, **kw, band=384, tile=128, fast=f))
        launches[f"sparse {kernel}"] = (
            getattr(sparse_k, kernel), lambda f=fast: sparse_k.launch_args(
                *qkv, plan.sparse_band, *tables, **kw, s_band=128, tile=128,
                fast=f))
    launches["swin KERNEL_FAST"] = (
        band_k.KERNEL_FAST, lambda: band_k.launch_args(
            *sqkv, *sgeom, *stables, **skw, fast=True))
    with torch.no_grad():
        for name, (kernel, make) in launches.items():
            outs = []
            for _ in range(2):
                largs, out, _inputs = make()
                kernel(*largs)
                torch.cuda.synchronize()
                outs.append(out)
            for o_name, a, b in zip(("acc", "m", "den"), *outs):
                assert torch.equal(a, b), (name, o_name)
            assert float(outs[0][2].max()) > 0, name


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
    runs in a fixed order, in their fp32 forms (``KERNEL``), their bf16
    forms on the tensor cores (``KERNEL_FAST``) and the band kernel's swin
    mode in bf16. (The sparse wrapper's scatter of the slots into points is
    PyTorch's ``index_add_``, which is not.)"""
    plan, qkv, tables, kw, res = _bwd_case(cuda_device, True, 384, 5,
                                           **STAGE2)
    args = _band_bwd_args(plan, qkv, tables, res)
    sgeom, sqkv, sg, stables, skw = _swin_case(cuda_device, 5, True)
    with torch.no_grad():
        sres = (sg,) + plain.merge([plain.band_attention_plain(
            *sqkv, *sgeom, *stables, **skw, fast=True)])
    launches = {}
    for fast in (False, True):
        kernel = "KERNEL_FAST" if fast else "KERNEL"
        launches[f"band {kernel}"] = (
            getattr(band_bwd_k, kernel),
            lambda f=fast: band_bwd_k.launch_args(
                *args, **kw, band=384, tile=128, fast=f))
        launches[f"sparse {kernel}"] = (
            getattr(sparse_bwd_k, kernel),
            lambda f=fast: sparse_bwd_k.launch_args(
                *qkv, plan.sparse_band, *res, *tables, **kw, s_band=128,
                tile=128, fast=f))
    launches["swin KERNEL_FAST"] = (
        band_bwd_k.KERNEL_FAST, lambda: band_bwd_k.launch_args(
            *sqkv, *sgeom, *sres, *stables, **skw, fast=True))
    with torch.no_grad():
        for name, (kernel, make) in launches.items():
            outs = []
            for _ in range(2):
                largs, out, _inputs = make()
                kernel(*largs)
                torch.cuda.synchronize()
                outs.append(out)
            for o_name, a, b in zip(("dq", "dk_part", "dv_part", "dt_part"),
                                    *outs):
                assert torch.equal(a, b), (name, o_name)
            assert float(outs[0][3].abs().max()) > 0, name
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


# sizes with n % 4 tails one element a thread, a vector pass with a partial
# last chunk and a tail, and one of whole chunks
PROBE_SIZES = (1, 3, 5, 4097, 65539, (1 << 20) + 1203, 1 << 22)


def _probe_input(n, offset, dev):
    """``n`` sweep values on ``dev`` as a view ``offset`` elements into a
    larger tensor (at 1, 2 or 3 not 16-byte aligned), and the same values
    on the CPU."""
    tiles = -(-(n + offset) // (1 << 16))
    import chip_smoke
    flat = chip_smoke.sweep_tiles(tiles).reshape(-1)
    x = flat.to(dev)[offset:offset + n]
    assert (x.data_ptr() % 16 == 0) is (offset % 4 == 0)
    return x, flat[offset:offset + n]


def _probe_call(name, x):
    if name == "bin_math_probe":
        return bin_math_probe.bin_formula(x, bin_math_probe.WS,
                                          bin_math_probe.QS)
    return cache_key_probe.times_two(x)


def _probe_plain(name, x):
    if name == "bin_math_probe":
        return bin_math_probe.bin_formula_plain(x, bin_math_probe.WS,
                                                bin_math_probe.QS)
    return cache_key_probe.times_two_plain(x)


PROBES = {"bin_math_probe": bin_math_probe, "cache_key_probe": cache_key_probe}


@pytest.mark.cuda
@pytest.mark.parametrize("n", PROBE_SIZES)
@pytest.mark.parametrize("name", list(PROBES))
def test_probe_kernels_equal_plain_at_tail_sizes(cuda_device, name, n):
    x, x_cpu = _probe_input(n, 0, cuda_device)
    before = PROBES[name].KERNEL.launches
    got = _probe_call(name, x)
    torch.cuda.synchronize()
    assert PROBES[name].KERNEL.launches == before + 1
    assert got.shape == (n,)
    assert torch.equal(got.cpu(), _probe_plain(name, x_cpu))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("name", list(PROBES))
def test_probe_kernels_read_unaligned_views(cuda_device, name, offset):
    for n in (5, 65539, (1 << 20) + 1203):
        x, x_cpu = _probe_input(n, offset, cuda_device)
        got = _probe_call(name, x)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), _probe_plain(name, x_cpu)), n


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PROBES))
def test_probe_kernels_are_deterministic(cuda_device, name):
    x, _ = _probe_input(65539, 0, cuda_device)
    first, second = _probe_call(name, x), _probe_call(name, x)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PROBES))
def test_probe_floor_launches(cuda_device, name):
    """The empty kernel that chip_smoke.py reads the probe kernels' times
    against launches at every size and refuses none; it is no probe
    launch."""
    from stratified_transformer_torch.kernels import stream_of
    mod = PROBES[name]
    before = mod.KERNEL.launches
    for n in (1, 1 << 16, 1 << 26):
        mod.FLOOR(n, stream_of(cuda_device))
    torch.cuda.synchronize()
    assert mod.KERNEL.launches == before


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


# ---- the swin bins (Swin3D, rpe_mode "swin_window") -------------------------

SWIN_WS, SWIN_QS = 0.16, 0.01           # S3DIS Swin stage 0: 31 table rows
SWIN_QGL = int(SWIN_WS / SWIN_QS)
SWIN_NBINS = 2 * SWIN_QGL - 1


def _swin_case(dev, seed, shifted, n_pad=512, n_valid=430, h=3,
               qgl=SWIN_QGL):
    """A plan of 0.16 m windows (no far keys) over two scenes of a 0.6 m
    box, its points' window-quantized positions, q/k/v/g and 31-row
    tables (``qgl``: windows of qgl quanta, 2 qgl - 1 table rows)."""
    from stratified_transformer_torch.models.attention import swin_positions
    ws, nbins = qgl * SWIN_QS, 2 * qgl - 1
    gen = torch.Generator().manual_seed(seed)
    xyz = torch.rand(n_pad, 3, generator=gen) * 0.6
    batch = torch.cat([torch.zeros(n_valid // 2, dtype=torch.int32),
                       torch.ones(n_valid - n_valid // 2, dtype=torch.int32),
                       torch.full((n_pad - n_valid,), 2, dtype=torch.int32)])
    valid = torch.arange(n_pad) < n_valid
    plan = plan_mod.build_attention_plan(
        xyz.to(dev), batch.to(dev), valid.to(dev), ws, shifted=shifted)
    u = swin_positions(plan.xyz_sorted, plan.grid_start,
                       ws / 2 if shifted else 0.0, ws, SWIN_QS)
    q, k, v, g = (torch.randn(n_pad, h, 16, generator=gen).to(dev)
                  for _ in range(4))
    tables = tuple((torch.randn(nbins, h, 16, 3, generator=gen) * 0.05
                    ).to(dev) for _ in range(3))
    geom = (u, plan.seg_start, plan.seg_end, plan.valid_sorted)
    kw = dict(window_size=ws, quant_size=SWIN_QS, scale=16 ** -0.5,
              band=128, tile=128, rpe_mode="swin_window")
    return geom, (q, k, v), g, tables, kw


def _rel_l2(got, want):
    return float((got - want).double().norm() / want.double().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("shifted", [False, True])
def test_swin_kernels_match_plain(cuda_device, fast, shifted):
    """The band forward and backward kernels in the swin mode (fp32 form:
    the fp32 tolerances; bf16 form: phase 14's relative-L2 gates against the
    plain fast versions in the kernels' row slices), one launch each, no
    far-key kernel."""
    geom, qkv, g, tables, kw = _swin_case(cuda_device, 5, shifted)
    kw = dict(kw, fast=fast)
    fwd = band_k.KERNEL_FAST if fast else band_k.KERNEL
    bwd = band_bwd_k.KERNEL_FAST if fast else band_bwd_k.KERNEL
    before = (fwd.launches, bwd.launches, sparse_k.KERNEL.launches,
              sparse_bwd_k.KERNEL.launches)
    got = band_k.band_attention(*qkv, *geom, *tables, **kw)
    want = plain.band_attention_plain(*qkv, *geom, *tables, **kw)
    out, m, den = plain.merge([want])
    rows = (band_bwd_k.block_limits("band_attention_bwd", cuda_device,
                                    SWIN_NBINS, True)[0] if fast else None)
    gk = band_bwd_k.band_attention_bwd(*qkv, *geom, g, out, m, den, *tables,
                                       **kw)
    gp = plain.band_attention_bwd_plain(*qkv, *geom, g, out, m, den,
                                        *tables, **kw, slice_rows=rows)
    assert (fwd.launches, bwd.launches, sparse_k.KERNEL.launches,
            sparse_bwd_k.KERNEL.launches) == (before[0] + 1, before[1] + 1,
                                              before[2], before[3])
    if fast:
        assert _rel_l2(got[0], want[0]) < 2e-4
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        for a, b in zip(gk, gp):
            assert _rel_l2(a, b) < 5e-4
    else:
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        for a, b in zip(gk, gp):
            torch.testing.assert_close(a, b, rtol=BWD_RTOL, atol=BWD_ATOL)


def _swin_bwd_case(dev, case, seed=11, n=256, h=3, qgl=SWIN_QGL):
    """Inputs of the fp32 swin kernels for one of the cases below, on
    windows given as key segments (the band kernel's semantics: a row sees
    ``[seg_start, seg_end)`` of its tile's reach, both ends valid):
    "straddle": windows across the 32-row blocks' and the 32-key chunks'
    edges, integer positions; "clip": positions at u = 0, 15 and 16 (bins
    0 and 30 and the clip past the table's edge); "continuous": positions
    off any lattice (the bins round ``rel`` half to even); "no_key": valid
    rows whose segment is empty and invalid keys inside windows; "shifted":
    a plan at the shifted parity (`_swin_case`). ``qgl``: windows of qgl
    quanta (16, 31 table rows; the clip at u = qgl - 1 and qgl). Returns
    ``(geom, qkv, g, tables, kw)`` as `_swin_case`."""
    if case == "shifted":
        return _swin_case(dev, seed, True, n_pad=1024, n_valid=900, qgl=qgl)
    gen = torch.Generator().manual_seed(seed)
    # windows: [start, end) ranges that straddle rows 32, 64, ... and the
    # chunks counted from a block's first key
    edges = [0, 20, 60, 75, 100, 140, 170, 200, 230]
    seg_start = torch.zeros(n, dtype=torch.int32)
    seg_end = torch.zeros(n, dtype=torch.int32)
    for a, b in zip(edges[:-1], edges[1:]):
        seg_start[a:b], seg_end[a:b] = a, b
    valid = torch.arange(n) < edges[-1]
    seg_start[edges[-1]:] = seg_end[edges[-1]:] = edges[-1]
    if case == "clip":
        u = torch.tensor([0.0, qgl - 1.0, float(qgl)])[
            torch.randint(0, 3, (n, 3), generator=gen)]
    elif case == "continuous":
        u = torch.rand(n, 3, generator=gen) * float(qgl)
    else:
        u = torch.randint(0, qgl, (n, 3), generator=gen).to(torch.float32)
    if case == "no_key":
        # rows 40-49 see no key; keys 80, 81 and 150 are invalid
        seg_end[40:50] = seg_start[40:50]
        valid[[80, 81, 150]] = False
    q, k, v, g = (torch.randn(n, h, 16, generator=gen).to(dev)
                  for _ in range(4))
    tables = tuple((torch.randn(2 * qgl - 1, h, 16, 3, generator=gen) * 0.05
                    ).to(dev) for _ in range(3))
    geom = (u.to(dev), seg_start.to(dev), seg_end.to(dev), valid.to(dev))
    kw = dict(window_size=qgl * SWIN_QS, quant_size=SWIN_QS,
              scale=16 ** -0.5, band=128, tile=128, rpe_mode="swin_window")
    return geom, (q, k, v), g, tables, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["straddle", "clip", "continuous", "no_key",
                                  "shifted"])
def test_swin_bwd_matches_plain_at_its_height(cuda_device, case):
    """The fp32 band backward in the swin mode (32-row blocks, two per SM)
    against `band_attention_bwd_plain` on windows that straddle its blocks
    and key chunks, at the bins' edges and clip, off any lattice, with rows
    that see no key, and at the shifted parity: one launch, the fp32
    backward tolerances, and no key or row outside a window touched."""
    geom, qkv, g, tables, kw = _swin_bwd_case(cuda_device, case)
    with torch.no_grad():
        out, m, den = plain.merge([plain.band_attention_plain(
            *qkv, *geom, *tables, **kw)])
        before = band_bwd_k.KERNEL.launches
        got = band_bwd_k.band_attention_bwd(*qkv, *geom, g, out, m, den,
                                            *tables, **kw)
        want = plain.band_attention_bwd_plain(*qkv, *geom, g, out, m, den,
                                              *tables, **kw)
    torch.cuda.synchronize()
    assert band_bwd_k.KERNEL.launches == before + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=BWD_RTOL, atol=BWD_ATOL)
    if case == "no_key":
        assert not bool(got[0][40:50].any())
        for t in got[:3]:
            assert not bool(t[[80, 81, 150]].any())


@pytest.mark.cuda
def test_swin_bwd_two_launches_are_bit_identical(cuda_device):
    """No float atomics and every sum in a fixed order: two launches of the
    fp32 swin backward on the same inputs give the same bits."""
    geom, qkv, g, tables, kw = _swin_bwd_case(cuda_device, "straddle")
    with torch.no_grad():
        out, m, den = plain.merge([plain.band_attention_plain(
            *qkv, *geom, *tables, **kw)])
        runs = [band_bwd_k.band_attention_bwd(*qkv, *geom, g, out, m, den,
                                              *tables, **kw)
                for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_swin_bwd_block_limits(cuda_device):
    """`block_limits` gives the fp32 swin backward its own height: 32 rows
    for Swin3D's 31-row tables, two blocks per SM; the stratified bins keep
    theirs (64 rows for S3DIS's 40-row band slice, 32 for ScanNet's 48, one
    block per SM); the fast form's swin mode keeps the fast heights."""
    assert band_bwd_k.block_limits("band_attention_bwd", cuda_device,
                                   SWIN_NBINS, swin=True)[0] == 32
    assert band_bwd_k.blocks_per_sm(cuda_device, SWIN_NBINS,
                                    "swin_window") == 2
    for nb, rows in ((40, 64), (48, 32)):
        assert band_bwd_k.block_limits("band_attention_bwd", cuda_device,
                                       nb)[0] == rows
        assert band_bwd_k.blocks_per_sm(cuda_device, nb) == 1
    assert band_bwd_k.block_limits(
        "band_attention_bwd", cuda_device, SWIN_NBINS, fast=True,
        swin=True) == band_bwd_k.block_limits(
        "band_attention_bwd", cuda_device, SWIN_NBINS, fast=True)
    geom, qkv, g, tables, kw = _swin_bwd_case(cuda_device, "straddle")
    _, (_, dk_part, _, dt_part), _ = band_bwd_k.launch_args(
        *qkv, *geom, g, g, g[..., 0], g[..., 0], *tables, **kw)
    assert dk_part.shape[0] == dt_part.shape[0] == qkv[0].shape[0] // 32


@pytest.mark.cuda
@pytest.mark.parametrize("qgl", [SWIN_QGL, 20])
@pytest.mark.parametrize("case", ["straddle", "clip", "continuous", "no_key",
                                  "shifted"])
def test_swin_fwd_matches_plain_at_its_height(cuda_device, case, qgl):
    """The fp32 band forward in the swin mode (its own routine, 64-row
    blocks, 32-key chunks) against `band_attention_plain` on windows that
    straddle its blocks and key chunks, at the bins' edges and clip, off
    any lattice, with rows that see no key, and at the shifted parity, at
    Swin3D's 31 table rows and at 39 (windows of 20 quanta): one launch,
    phase 4's tolerances, and the empty triple (m = -1e30, den = 0, acc =
    0) for rows that see no key."""
    geom, qkv, _, tables, kw = _swin_bwd_case(cuda_device, case, qgl=qgl)
    assert tables[0].shape[0] == 2 * qgl - 1
    with torch.no_grad():
        before = band_k.KERNEL.launches
        got = band_k.band_attention(*qkv, *geom, *tables, **kw)
        want = plain.band_attention_plain(*qkv, *geom, *tables, **kw)
    torch.cuda.synchronize()
    assert band_k.KERNEL.launches == before + 1
    _assert_triple(got, want)
    if case == "no_key":
        acc, m, den = got
        assert bool((m[40:50] == -1e30).all())
        assert not bool(den[40:50].any()) and not bool(acc[40:50].any())


@pytest.mark.cuda
def test_swin_fwd_two_launches_are_bit_identical(cuda_device):
    """No float atomics and every sum in a fixed order: two launches of the
    fp32 swin forward on the same inputs give the same bits."""
    for case in ("straddle", "shifted"):
        geom, qkv, _, tables, kw = _swin_bwd_case(cuda_device, case)
        with torch.no_grad():
            runs = [band_k.band_attention(*qkv, *geom, *tables, **kw)
                    for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_swin_fwd_block_limits(cuda_device):
    """`block_limits` gives the fp32 swin forward its own limits: 64-row
    blocks, two per SM at Swin3D's 31 table rows, and room for every table
    the fp32 swin backward takes (up to 112 rows per axis: a forward at 111
    rows against the plain version); beyond its limit the wrapper raises
    the ValueError before any launch. The stratified fp32 form keeps its
    limits and two blocks per SM."""
    rows, max_nb = band_k.block_limits("band_attention", cuda_device,
                                       swin=True)
    assert rows == 64
    assert band_k.blocks_per_sm(cuda_device, SWIN_NBINS, "swin_window") == 2
    assert band_k.blocks_per_sm(cuda_device, 40) == 2
    bwd_max = band_bwd_k.block_limits("band_attention_bwd", cuda_device, 31,
                                      swin=True)[1]
    assert max_nb >= bwd_max >= 111
    geom, qkv, _, tables, kw = _swin_bwd_case(cuda_device, "continuous",
                                              qgl=56)
    with torch.no_grad():
        _assert_triple(band_k.band_attention(*qkv, *geom, *tables, **kw),
                       plain.band_attention_plain(*qkv, *geom, *tables,
                                                  **kw))
    qgl = (max_nb + 2) // 2             # 2 qgl - 1 > max_nb
    geom, qkv, _, tables, kw = _swin_bwd_case(cuda_device, "straddle",
                                              qgl=qgl)
    before = band_k.KERNEL.launches
    with pytest.raises(ValueError, match="table rows per axis"):
        band_k.band_attention(*qkv, *geom, *tables, **kw)
    assert band_k.KERNEL.launches == before


@pytest.mark.cuda
def test_swin_bins_on_the_card(cuda_device):
    """The swin `rel_bin_probe` on every integer ``rel`` in ``[-qgl-2,
    qgl+2]`` equals `swin_relative_position_index` (the clip at both
    ends)."""
    rel = torch.arange(-SWIN_QGL - 2, SWIN_QGL + 3, dtype=torch.float32)
    got = band_k.rel_bins(rel.to(cuda_device), SWIN_WS, SWIN_QS, SWIN_NBINS,
                          rpe_mode="swin_window").cpu().long()
    torch.testing.assert_close(got, plain.swin_relative_position_index(
        rel, SWIN_NBINS))
    assert int(got.min()) == 0 and int(got.max()) == SWIN_NBINS - 1


@pytest.mark.cuda
def test_swin_mode_refuses_a_table_slice(cuda_device):
    """The C entry points refuse the swin mode with a band slice of the
    table (the mode reads the whole table)."""
    geom, qkv, g, tables, kw = _swin_case(cuda_device, 6, False)
    args, outs, _ = band_k.launch_args(*qkv, *geom, *tables, **kw)
    args = list(args)
    # n, h, d, q_rs, k_rs, v_rs, tile, band, nb, bin_lo, nb_full, swin
    ints = len(args) - 16
    assert args[ints + 11] == 1 and args[ints + 9] == 0
    args[ints + 9] = 1                  # bin_lo 1: a slice
    with pytest.raises(RuntimeError, match="failed to launch"):
        band_k.KERNEL(*args)


@pytest.mark.cuda
def test_device_busy_times_the_queued_calls(cuda_device):
    """`chip_smoke.device_busy_ms` (the wrappers' device-busy time: calls
    queued behind a sleep kernel, CUDA events) reads the kernel's own time,
    not 0 and not the host's dispatch."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    geom, qkv, g, tables, kw = _swin_case(cuda_device, 7, False)
    args, _, _ = band_k.launch_args(*qkv, *geom, *tables, **kw)
    with torch.no_grad():
        busy = chip_smoke.device_busy_ms(
            lambda: band_k.band_attention(*qkv, *geom, *tables, **kw), 5)
    kernel = chip_smoke.cuda_time_ms(lambda: band_k.KERNEL(*args), 20)
    assert 0 < busy < 2 * kernel + 0.05


def _gather_case(dev, idx_dtype, c, seed=0, rows=3000, m=4000, k=34,
                 hub=0):
    """A collate-like gather: ``feats [rows, c]``, ``idx``/``mask [m, k]``
    with a third of the slots masked, the masked slots of even rows at row
    0 and of odd rows at the row's own index, every 7th row fully masked,
    and ``hub`` unmasked slots more at row 1 (a segment of many warps'
    width in the inverse map)."""
    gen = torch.Generator().manual_seed(seed)
    feats = torch.randn(rows, c, generator=gen)
    idx = torch.randint(0, rows, (m, k), generator=gen)
    mask = torch.rand(m, k, generator=gen) < 0.67
    mask[::7] = False
    own = torch.arange(m)[:, None].expand(m, k) % rows
    pad = torch.where(torch.arange(m)[:, None] % 2 == 0, 0, own)
    idx = torch.where(mask, idx, pad)
    idx.view(-1)[:hub] = 1
    mask.view(-1)[:hub] = True
    return feats.to(dev), idx.to(idx_dtype).to(dev), mask.to(dev)


def _assert_within_sum_order(got, g, idx, mask, rows):
    """fp32 sums of the same terms in another order: each row within
    ``(L - 1) 2^-24`` times the sum of its terms' magnitudes (the bound of
    L - 1 recursive fp32 additions) of the float64 sum, on the CPU."""
    g64 = g.double().cpu().reshape(-1, g.shape[-1])
    keep = mask.cpu().reshape(-1)
    ix = idx.cpu().reshape(-1).long()[keep]
    exact = torch.zeros(rows, g.shape[-1], dtype=torch.float64).index_add_(
        0, ix, g64[keep])
    mag = torch.zeros_like(exact).index_add_(0, ix, g64[keep].abs())
    n = torch.bincount(ix, minlength=rows).double()[:, None]
    bound = (n - 1).clamp_min(0) * 2.0 ** -24 * mag
    assert bool(((got.double().cpu() - exact).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("c, fill", [(12, 0.0), (96, -float("inf")),
                                     (6, 0.0)])
@pytest.mark.parametrize("rows", [3000, 150])
def test_gather_rows_kernels_match_plain(cuda_device, idx_dtype, c, fill,
                                         rows):
    """Forward bit for bit (a copy); backward within fp32 sum order of the
    float64 sum and equal to the plain version on the CPU, which adds each
    row in slot order as the kernel does; launch counts. C = 12 and 96 take
    the float4 path, 6 the scalar one. At 3000 rows a row holds ~30 slots
    (the warp's ordering) and one 1000 more; at 150 rows every row is long
    (~600: the blocks' merge sort)."""
    feats, idx, mask = _gather_case(cuda_device, idx_dtype, c, rows=rows,
                                    hub=1000)
    counts = (gather_k.FWD.launches, gather_k.MAP.launches,
              gather_k.BWD.launches)
    out = gather_k.gather_rows(feats, idx, mask, fill)
    assert torch.equal(out, gather_k.gather_rows_plain(feats, idx.long(),
                                                       mask, fill))
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)
                    ).to(cuda_device)
    rows = feats.shape[0]
    dfeats = gather_k.gather_rows_bwd(g, idx, mask, rows)
    torch.cuda.synchronize()
    assert (gather_k.FWD.launches, gather_k.MAP.launches,
            gather_k.BWD.launches) == tuple(n + 1 for n in counts)
    _assert_within_sum_order(dfeats, g, idx, mask, rows)
    cpu = gather_k.gather_rows_bwd_plain(g.cpu(), idx.cpu(), mask.cpu(),
                                         rows)
    assert torch.equal(dfeats.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [3000, 40])
def test_gather_rows_backward_is_deterministic(cuda_device, rows):
    """No float atomics: two backward launches on the same inputs agree bit
    for bit (the inverse map's placement order varies, its sorted segments
    do not), at short rows and a 5000-slot one, and at rows of ~2000."""
    feats, idx, mask = _gather_case(cuda_device, torch.int64, 48, seed=2,
                                    rows=rows, hub=5000)
    g = torch.randn(idx.shape + (48,), device=cuda_device)
    first = gather_k.gather_rows_bwd(g, idx, mask, feats.shape[0])
    second = gather_k.gather_rows_bwd(g, idx, mask, feats.shape[0])
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_gather_rows_reads_unaligned_rows_and_edges(cuda_device):
    """A feats view one float in (not on 16 bytes) takes the scalar path;
    out-of-range indices of unmasked slots read as masked; a gradient of
    slots that are all masked is 0."""
    feats, idx, mask = _gather_case(cuda_device, torch.int32, 8, seed=3,
                                    rows=500, m=300, k=9)
    base = torch.randn(feats.numel() + 1, device=cuda_device)
    view = base[1:].view(feats.shape)
    out = gather_k.gather_rows(view, idx, mask, 0.5)
    assert torch.equal(out, gather_k.gather_rows_plain(view, idx.long(),
                                                       mask, 0.5))
    bad = idx.clone()
    bad[0, 0], bad[1, 0] = -1, 500
    mask2 = mask.clone()
    mask2[:2, 0] = True
    out = gather_k.gather_rows(view, bad, mask2, 0.5)
    assert bool((out[:2, 0] == 0.5).all())
    g = torch.ones(out.shape, device=cuda_device)
    zero = gather_k.gather_rows_bwd(g, idx, torch.zeros_like(mask), 500)
    assert not bool(zero.any())


@pytest.mark.cuda
def test_gather_rows_function_backward_on_the_card(cuda_device):
    """`GatherRows` through autograd against autograd of the expression it
    replaces (whose CUDA backward adds in another order)."""
    feats, idx, mask = _gather_case(cuda_device, torch.int64, 12, seed=4)
    x = feats.clone().requires_grad_(True)
    y = feats.clone().requires_grad_(True)
    got = GatherRows.apply(x, idx, mask, -float("inf"))
    want = torch.where(mask[..., None], y[idx],
                       torch.full_like(y[idx], -float("inf")))
    assert torch.equal(got, want)
    g = torch.randn(got.shape, device=cuda_device)
    gx, = torch.autograd.grad(got, x, g)
    gy, = torch.autograd.grad(want, y, g)
    _assert_within_sum_order(gx, g, idx, mask, feats.shape[0])
    _assert_within_sum_order(gy, g, idx, mask, feats.shape[0])
