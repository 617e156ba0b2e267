"""The far-key CUDA kernel's own addressing, checked on the CPU.

``csrc/sparse_band_attention.cu`` takes q, k and v in small-window order:
query row r (large-window order) reads q row ``lw_map[r]`` and writes its
triple to row ``lw_map[r]``; aux slot p reads k/v row ``sb_src[p]`` where
``sb_src[p] >= 0``. Here that index arithmetic, driven through the plain
version's large-window core, must give exactly what the plain version's
gathers (`sparse_inputs`) and un-permute (``lw_unmap``) give.
"""

import numpy as np
import pytest
import torch

from stratified_transformer_torch.ops import attention as plain
from stratified_transformer_torch.ops import plan as plan_mod

torch.set_num_threads(1)

WS, QUANT, TILE, S_BAND = 0.5, 0.125, 32, 64


def _case(seed, shifted, n_pad=256, n_valid=230, h=2, d=8):
    rng = np.random.default_rng(seed)
    xyz = torch.from_numpy(rng.uniform(0, 2, (n_pad, 3)).astype(np.float32))
    batch = torch.from_numpy(np.concatenate([
        np.sort(rng.integers(0, 2, n_valid)),
        np.full(n_pad - n_valid, 2)]).astype(np.int32))
    valid = torch.arange(n_pad) < n_valid
    is_down = torch.from_numpy(rng.uniform(size=n_pad) < 0.4) & valid
    plan = plan_mod.build_attention_plan(xyz, batch, valid, WS,
                                         shifted=shifted, is_down=is_down,
                                         sparse_cap=16)
    nbins = 2 * int((2 * WS + 1e-4) // QUANT)
    q, k, v = (torch.from_numpy(rng.normal(size=(n_pad, h, d)).astype(
        np.float32)) for _ in range(3))
    tables = tuple(torch.from_numpy(
        (rng.normal(size=(nbins, h, d, 3)) * 0.05).astype(np.float32))
        for _ in range(3))
    return plan.sparse_band, (q, k, v), tables


def _kernel_reads(q, k, v, sb, scale):
    """q in lw order and k/v in aux order as the kernel reads them."""
    q_lw = q[sb.lw_map.long()] * scale
    k_aux = torch.zeros((sb.sb_src.shape[0],) + tuple(k.shape[1:]))
    v_aux = torch.zeros_like(k_aux)
    filled = sb.sb_src >= 0
    src = sb.sb_src[filled].long()
    k_aux[filled], v_aux[filled] = k[src], v[src]
    return q_lw, k_aux, v_aux


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_reads_equal_sparse_inputs(seed, shifted):
    sb, (q, k, v), _ = _case(seed, shifted)
    scale = q.shape[2] ** -0.5
    # an aux slot holds a point exactly where the plan marks it valid
    assert torch.equal(sb.sb_src >= 0, sb.sb_valid)
    for got, want in zip(_kernel_reads(q, k, v, sb, scale),
                         plain.sparse_inputs(q, k, v, sb, scale)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_writes_equal_the_unpermute(seed, shifted):
    """Writing row r of the large-window order to row lw_map[r] is the
    wrapper-side un-permute ``x[lw_unmap]``, and the whole far-key half
    through the kernel's reads and writes equals the plain version."""
    sb, (q, k, v), tables = _case(seed, shifted)
    lw_map, lw_unmap = sb.lw_map.long(), sb.lw_unmap.long()
    n = lw_map.shape[0]
    assert torch.equal(torch.sort(lw_map).values, torch.arange(n))
    assert torch.equal(lw_unmap[lw_map], torch.arange(n))
    kw = dict(window_size=WS, quant_size=QUANT, s_band=S_BAND, tile=TILE)
    scale = q.shape[2] ** -0.5
    triple_lw = plain.sparse_triple_lw(*_kernel_reads(q, k, v, sb, scale),
                                       sb, *tables, **kw)
    want = plain.sparse_band_attention_plain(q, k, v, sb, *tables, **kw,
                                             scale=scale)
    for t_lw, w in zip(triple_lw, want):
        got = torch.empty_like(t_lw)
        got[lw_map] = t_lw                  # the kernel's write
        assert torch.equal(got, w)
        assert torch.equal(got, t_lw[lw_unmap])
    assert float(want[2].max()) > 0         # rows see far keys
    assert bool((want[1] == plain.NEG_INF).any())  # and some see none
