"""Stratified window attention: cRPE bins and the plain PyTorch versions of
the two attention kernels.

Per query, one softmax spans two key sets (reference
``model/stratified_transformer.py:164-217``):
  * dense keys — the query's own small window, a contiguous segment
    ``[seg_start, seg_end)`` of the window-sorted order, visited through a
    band ``[t0 - band, t0 + tile + band)`` around the query's 128-row tile
    (`band_attention_plain`);
  * far keys — the downsampled points of the query's large window outside
    its small window, laid out by `ops.plan.SparseBandLayout`
    (`sparse_band_attention_plain`).

Logits are ``q·k + Σ_a q·T_q[bin_a] + Σ_a k·T_k[bin_a]`` over the 3 axes;
values are ``v + Σ_a T_v[bin_a]``. Each half returns the unnormalised
online-softmax triple ``(acc [N,h,d], m [N,h], den [N,h])``; `merge`
composes them. The backward of each half (`band_attention_bwd_plain`,
`sparse_band_attention_bwd_plain`) takes the cotangent and the MERGED
statistics and output, and returns the grads of q, k, v and the tables.
These are the arithmetic the CUDA kernels in
``reference/csrc`` implement: the tests hold them
against the JAX package's Pallas kernels, and the chip smoke run holds the
kernels against them.

``rpe_mode="swin_window"`` is Swin3D's form of the dense half (the JAX
package's ``ops/attention.py:59-72,461-465,513-515``): its coordinates are
the points' window-quantized positions, its bin
`swin_relative_position_index` of their difference, over the whole table of
``2*qgl - 1`` rows (no band slice), and there are no far keys.

``fast=True`` is the bf16 form that the shipped YAMLs select
(``rpe_precision``/``qk_precision: default``): each operand of a product
that the TPU kernels contract at DEFAULT precision (q·k, p·v, q·Tq, k·Tk,
mass·Tv and the backward's products) is rounded to bf16 (`bf16_round`)
and the products accumulate in fp32; the bins, masks, softmax statistics,
masses, merges and the sums of partials stay fp32. Where the TPU kernels'
roundings depend on how they cut the work, the fast forms cut it as the
CUDA kernels do: p is rounded at the row's running maximum over key
chunks of `FAST_CHUNK` from the window's first key (the TPU kernel's
``w_chunk`` chunks), and the backward's key masses are rounded per tile,
or per ``slice_rows`` query rows (the CUDA kernels' row slices, a kept
divergence: ROADMAP.md §3).
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30

# Tiles per vectorised step of the plain versions (forward and backward):
# bounds the [B, h, T, W] pair tensors to ~2**24 elements each.
_PAIR_BUDGET = 1 << 24

_INV_1E5 = float(np.float32(1e-5))


# keys per chunk of the fast forms' running maximum (the kernels' kFwdChunk)
FAST_CHUNK = 32


def bf16_round(t):
    """``t`` rounded to bf16 (to nearest, ties to even) and back to fp32: an
    operand of a bf16 product, whose products of two such values are exact
    in fp32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _rounding(fast):
    """The operand rounding of a form: ``fast`` True is bf16
    (`bf16_round`), a callable is that rounding (the benchmark's control
    passes one of a lower precision), False none."""
    if callable(fast):
        return fast
    return bf16_round if fast else (lambda t: t)


def _grad_rounding(fast):
    """The rounding of the backward's gradient operands (g, dl and their
    bin masses): the control's ``fast.grad`` where it has one, else as
    `_rounding`."""
    return getattr(fast, "grad", None) or _rounding(fast)


def _round_tables(tables, fast):
    return tuple(None if t is None else _rounding(fast)(t) for t in tables)


def bin_constants(window_size, quant_size):
    """The float32 constants of the division-free bin formula:
    ``(2*window - 1e-4, 1/quant)``. The kernels take the same two values."""
    return (float(np.float32(2.0 * float(window_size) - 1e-4)),
            float(np.float32(1.0 / float(quant_size))))


def relative_position_index(rel, window_size, quant_size, num_bins):
    """Quantized relative-position bin per axis.

    Mirrors ``model/stratified_transformer.py:186-190``: round to 1e-5
    (half to even), then ``floor((rel + 2*window - 1e-4) / quant)`` computed
    with the reciprocal constant, clipped to ``[0, num_bins)``. Only
    correctly rounded fp32 multiplies and adds are used, so every device and
    kernel gets the same bins.
    """
    off, inv_q = bin_constants(window_size, quant_size)
    rel = torch.round(rel.to(torch.float32) * 1e5) * _INV_1E5
    ridx = torch.floor((rel + off) * inv_q)
    return ridx.clamp(0, num_bins - 1).to(torch.int64)


def swin_relative_position_index(rel, num_bins):
    """Swin3D's window-quantized bin per axis (``rpe_mode="swin_window"``;
    the JAX package's ``ops/attention.py:59-72``).

    ``rel = u_i - u_j`` of two points' window-quantized positions ``u =
    floor(((xyz - origin + shift) mod window) / quant)`` (integer-valued
    floats, so the subtraction is exact); the bin is ``round(rel) + qgl -
    1`` (half to even) over ``num_bins = 2*qgl - 1`` table rows, clipped to
    ``[0, num_bins)``. The clip matters: ``mod`` followed by the division
    can reach ``qgl`` at a window's far edge.
    """
    qgl = (num_bins + 1) // 2
    return (torch.round(rel.to(torch.float32)).to(torch.int64)
            + (qgl - 1)).clamp(0, num_bins - 1)


def table_bins(rel, window_size, quant_size, num_bins, rpe_mode):
    """The bins of ``rel`` in ``rpe_mode``: "stratified"
    (`relative_position_index`) or "swin_window"
    (`swin_relative_position_index`)."""
    if rpe_mode == "swin_window":
        return swin_relative_position_index(rel, num_bins)
    if rpe_mode != "stratified":
        raise ValueError(f"rpe_mode {rpe_mode!r}: expected 'stratified' or "
                         "'swin_window'")
    return relative_position_index(rel, window_size, quant_size, num_bins)


def band_slice(num_bins_full, rpe_mode="stratified"):
    """``(bin_lo, nb)`` of the table rows the dense half reads: the band
    slice of the stratified bins (`band_table_slice`); the whole table of
    the swin bins, which span exactly the in-window range
    (``ops/attention.py:513-515`` of the JAX package)."""
    if not num_bins_full:
        return 0, 0
    if rpe_mode == "swin_window":
        return 0, num_bins_full
    return band_table_slice(num_bins_full)


def band_table_slice(num_bins_full):
    """``(bin_lo, nb)``: the table rows a band (same-window) pair can reach.

    Same-window pairs have per-axis ``|rel| < window``, so only the middle
    ~qgl+3 of the 2*qgl rows are reachable; rows are clipped into
    ``[bin_lo, bin_lo + nb)`` (``fused_attention.py:631-642``).
    """
    qgl = num_bins_full // 2
    bin_lo = max(qgl // 2 - 1, 0)
    nb = ((qgl + 3 + 7) // 8) * 8
    return bin_lo, min(num_bins_full - bin_lo, nb)


def num_bins(table_q, table_k, table_v):
    for t in (table_q, table_k, table_v):
        if t is not None:
            return t.shape[0]
    return 0


def _logits(q_t, x_t, k_b, x_b, mask, tables, *, window_size, quant_size,
            num_bins_full, bin_lo, nb, rpe_mode="stratified"):
    """Masked logits ``[B,h,T,W]`` of a batch of query tiles and the clamped
    per-axis bins ``[B,T,W,3]`` (None without tables).

    q_t ``[B,T,h,d]`` (pre-scaled), x_t ``[B,T,3]``, k_b ``[B,W,h,d]``,
    x_b ``[B,W,3]``, mask ``[B,T,W]``; tables ``(tq, tk, tv)`` each
    ``[nb,h,d,3]`` or None; ``rpe_mode`` the bins (`table_bins`).
    """
    tq, tk, _ = tables
    bsz, t, h, _ = q_t.shape
    w = k_b.shape[1]
    logits = torch.einsum("bthd,bwhd->bhtw", q_t, k_b)
    ridx = None
    if num_bins_full:
        rel = x_t[:, :, None, :] - x_b[:, None, :, :]             # [B,T,W,3]
        ridx = (table_bins(rel, window_size, quant_size, num_bins_full,
                           rpe_mode) - bin_lo).clamp(0, nb - 1)
    for a in range(3 if ridx is not None else 0):
        r_a = ridx[..., a]                                          # [B,T,W]
        if tq is not None:
            qproj = torch.einsum("bthd,lhd->bhtl", q_t, tq[..., a])
            logits = logits + qproj.gather(
                3, r_a[:, None].expand(bsz, h, t, w))
        if tk is not None:
            kproj = torch.einsum("bwhd,lhd->bhwl", k_b, tk[..., a])
            logits = logits + kproj[:, :, None].expand(
                bsz, h, t, w, nb).gather(
                4, r_a[:, None, :, :, None].expand(bsz, h, t, w, 1))[..., 0]
    return torch.where(mask[:, None], logits, NEG_INF), ridx


def _bin_mass(ridx_a, weights, nb):
    """``[B,h,T,nb]`` sums of ``weights [B,h,T,W]`` over the keys of each
    bin ``ridx_a [B,T,W]``."""
    bsz, h, t, w = weights.shape
    mass = torch.zeros(bsz, h, t, nb, dtype=weights.dtype,
                       device=weights.device)
    return mass.scatter_add_(3, ridx_a[:, None].expand(bsz, h, t, w),
                             weights)


def _chunk_max(logits, chunk):
    """``[B,h,T,W]``: each key's running row maximum of the masked
    ``logits [B,h,T,W]`` as of the end of its chunk (``chunk [B,W]``, the
    keys' chunk numbers, ascending along W)."""
    last = torch.searchsorted(chunk, chunk, right=True) - 1         # [B,W]
    run = logits.cummax(-1).values
    return run.gather(-1, last[:, None, None, :].expand_as(run))


def _triple(q_t, x_t, k_b, v_b, x_b, mask, tables, chunk=None, rnd=None,
            **bins):
    """Online-softmax triple ``(acc [B,T,h,d], m [B,T,h], den [B,T,h])``
    for a batch of query tiles (arguments as `_logits`). ``chunk [B,W]``
    (the fast form; None: fp32): the keys' chunk numbers. The caller has
    rounded q, k, v and the tables; p is rounded for p·v at the running
    maximum as of its chunk's end and carried to the final maximum in fp32,
    as an online softmax over those chunks does, and the bin masses are
    rounded for mass·Tv; den and the masses sum the fp32 p."""
    tv = tables[2]
    rnd = rnd or _rounding(chunk is not None)
    logits, ridx = _logits(q_t, x_t, k_b, x_b, mask, tables, **bins)
    mask_h = mask[:, None]
    m = logits.amax(-1).clamp_min(NEG_INF)                          # [B,h,T]
    p = torch.where(mask_h, torch.exp(logits - m[..., None]), 0.0)
    den = p.sum(-1)
    if chunk is not None:
        run = _chunk_max(logits, chunk)
        pv = torch.where(mask_h, rnd(torch.exp(logits - run))
                         * torch.exp(run - m[..., None]), 0.0)
    else:
        pv = p
    acc = torch.einsum("bhtw,bwhd->bthd", pv, v_b)
    if tv is not None and ridx is not None:
        for a in range(3):
            acc = acc + torch.einsum(
                "bhtl,lhd->bthd",
                rnd(_bin_mass(ridx[..., a], p, bins["nb"])), tv[..., a])
    return acc, m.transpose(1, 2), den.transpose(1, 2)


def _key_mass(ridx_a, dl, nb, slice_rows, rnd):
    """``[B,h,W,nb]``: each key's sums of ``dl [B,h,T,W]`` over the rows of
    each bin (``ridx_a [B,T,W]``), rounded by ``rnd`` per run of
    ``slice_rows`` rows (None: all T rows) and the runs added in fp32."""
    bsz, h, t, w = dl.shape
    rows = slice_rows or t
    if t % rows:
        raise ValueError(f"tile {t} is not a multiple of slice_rows {rows}")
    s = t // rows
    r_s = ridx_a.reshape(bsz * s, rows, w).transpose(1, 2)         # [BS,W,R]
    dl_s = dl.reshape(bsz, h, s, rows, w).transpose(1, 2).reshape(
        bsz * s, h, rows, w).transpose(2, 3)                      # [BS,h,W,R]
    return rnd(_bin_mass(r_s, dl_s, nb)).reshape(bsz, s, h, w, nb).sum(1)


def _triple_bwd(q_t, x_t, k_b, v_b, x_b, mask, tables, g_t, o_t, m_t, den_t,
                fast=False, slice_rows=None, **bins):
    """Backward of a batch of query tiles against the merged statistics
    (``fused_attention_bwd.py:5-15``): ``r = exp(l - m) / den`` and
    ``dl = r * (g·(v + ΣT_v[bin]) - g·o)``.

    g_t/o_t ``[B,T,h,d]``, m_t/den_t ``[B,T,h]``. Returns ``(dq_t
    [B,T,h,d]`` (w.r.t. the pre-scaled q), ``dk_w, dv_w [B,W,h,d]`` per key
    slot of each tile, ``(dtq, dtk, dtv)`` each ``[nb,h,d,3]`` summed over
    the batch or None). With ``fast`` the caller has rounded q, k, v and the
    tables; g is rounded here for its products (``g·o`` takes the fp32 g),
    and r, dl and the masses as operands of theirs, the key masses per run
    of ``slice_rows`` rows (`_key_mass`); g, dl and dl's masses by
    `_grad_rounding`.
    """
    tq, tk, tv = tables
    nb = bins["nb"]
    rnd, rnd_g = _rounding(fast), _grad_rounding(fast)
    logits, ridx = _logits(q_t, x_t, k_b, x_b, mask, tables, **bins)
    m = m_t.transpose(1, 2)[..., None]                              # [B,h,T,1]
    den = den_t.transpose(1, 2).clamp_min(1e-20)[..., None]
    r = torch.where(mask[:, None], torch.exp(logits - m) / den, 0.0)
    go = (g_t * o_t).sum(-1).transpose(1, 2)[..., None]            # [B,h,T,1]
    g_t = rnd_g(g_t)
    gv = torch.einsum("bthd,bwhd->bhtw", g_t, v_b)
    if tv is not None and ridx is not None:
        bsz, h, t, w = gv.shape
        for a in range(3):
            gproj = torch.einsum("bthd,lhd->bhtl", g_t, tv[..., a])
            gv = gv + gproj.gather(
                3, ridx[..., a][:, None].expand(bsz, h, t, w))
    dl = r * (gv - go)
    dl_c, r_c = rnd_g(dl), rnd(r)
    dq = torch.einsum("bhtw,bwhd->bthd", dl_c, k_b)
    dk = torch.einsum("bhtw,bthd->bwhd", dl_c, q_t)
    dv = torch.einsum("bhtw,bthd->bwhd", r_c, g_t)
    dtabs = [None if tb is None or ridx is None else torch.zeros_like(tb)
             for tb in tables]
    for a in range(3 if ridx is not None else 0):
        r_a = ridx[..., a]
        if tq is not None:
            dmq = rnd_g(_bin_mass(r_a, dl, nb))                   # [B,h,T,nb]
            dq = dq + torch.einsum("bhtl,lhd->bthd", dmq, tq[..., a])
            dtabs[0][..., a] = torch.einsum("bhtl,bthd->lhd", dmq, q_t)
        if tk is not None:
            dmk = _key_mass(r_a, dl, nb, slice_rows, rnd_g)
            dk = dk + torch.einsum("bhwl,lhd->bwhd", dmk, tk[..., a])
            dtabs[1][..., a] = torch.einsum("bhwl,bwhd->lhd", dmk, k_b)
        if tv is not None:
            dtabs[2][..., a] = torch.einsum(
                "bhtl,bthd->lhd", rnd(_bin_mass(r_a, r, nb)), g_t)
    return dq, dk, dv, tuple(dtabs)


def _tile_batches(nt, tile, w, h):
    step = max(1, _PAIR_BUDGET // max(tile * w * h, 1))
    return [(s, min(s + step, nt)) for s in range(0, nt, step)]


def band_attention_plain(q, k, v, xyz, seg_start, seg_end, valid,
                         table_q=None, table_k=None, table_v=None, *,
                         window_size, quant_size, scale, band, tile=128,
                         fast=False, rpe_mode="stratified"):
    """Dense (same-window) half over the window-sorted order.

    q/k/v ``[N,h,d]`` sorted; xyz ``[N,3]``; seg bounds ``[N]``; valid
    ``[N]`` bool; tables ``[2L,h,d,3]`` or None. A query in tile
    ``t0 = (row // tile) * tile`` sees keys ``[t0 - band, t0 + tile + band)
    ∩ [seg_start, seg_end)``, both ends valid. Returns the triple. ``fast``:
    the bf16 form (q rounded after the fp32 scaling, as the TPU kernel
    stages it, ``fused_attention.py:646-668``). ``rpe_mode``
    "swin_window": Swin3D's bins (`swin_relative_position_index`) of xyz,
    the points' window-quantized positions, over the whole table.
    """
    n, h, d = q.shape
    if n % tile:
        raise ValueError(f"N={n} is not a multiple of tile={tile}")
    nt = n // tile
    w = tile + 2 * band
    dev = q.device
    rnd = _rounding(fast)
    qf = rnd(q.to(torch.float32) * scale)
    kf, vf = rnd(k.to(torch.float32)), rnd(v.to(torch.float32))
    xf = xyz.to(torch.float32)
    num_bins_full = num_bins(table_q, table_k, table_v)
    bin_lo, nb = band_slice(num_bins_full, rpe_mode)
    tables = _round_tables(tuple(None if tb is None else
                                 tb.to(torch.float32)[bin_lo:bin_lo + nb]
                                 for tb in (table_q, table_k, table_v)), fast)

    acc = torch.empty(n, h, d, dtype=torch.float32, device=dev)
    m = torch.empty(n, h, dtype=torch.float32, device=dev)
    den = torch.empty(n, h, dtype=torch.float32, device=dev)
    for s, e in _tile_batches(nt, tile, w, h):
        rows = torch.arange(s * tile, e * tile, device=dev).view(e - s, tile)
        pos = (torch.arange(s, e, device=dev)[:, None] * tile - band
               + torch.arange(w, device=dev)[None])                 # [B,W]
        inside = (pos >= 0) & (pos < n)
        safe = pos.clamp(0, n - 1)
        val_t = valid[rows]
        mask = ((pos[:, None, :] >= seg_start[rows][..., None].long())
                & (pos[:, None, :] < seg_end[rows][..., None].long())
                & val_t[..., None] & (valid[safe] & inside)[:, None, :])
        # chunks counted from the window's first key, max(t0 - band, 0)
        chunk = (torch.div(pos - pos[:, :1].clamp_min(0), FAST_CHUNK,
                           rounding_mode="floor") if fast else None)
        a_, m_, d_ = _triple(
            qf[rows], xf[rows], kf[safe], vf[safe], xf[safe], mask, tables,
            chunk, rnd, window_size=window_size, quant_size=quant_size,
            num_bins_full=num_bins_full, bin_lo=bin_lo, nb=nb,
            rpe_mode=rpe_mode)
        acc[s * tile:e * tile] = a_.reshape(-1, h, d)
        m[s * tile:e * tile] = m_.reshape(-1, h)
        den[s * tile:e * tile] = d_.reshape(-1, h)
    return acc, m, den


def compose_band(part, band, tile, n):
    """Per-tile key-slot partials ``[nt, tile + 2*band, ...]`` -> ``[n, ...]``
    summed by absolute key position (slot ``s`` of tile ``t`` is key
    ``t*tile - band + s``). The slots are taken ``tile`` at a time: each such
    run over all tiles is one contiguous shifted add, for any ``band``
    (``fused_attention_bwd.py::diag_add`` needs ``band % tile == 0``)."""
    nt, w = part.shape[:2]
    rest = tuple(part.shape[2:])
    runs = -(-w // tile)
    if runs * tile != w:
        part = torch.cat([part, part.new_zeros((nt, runs * tile - w) + rest)],
                         1)
    total = part.new_zeros((n,) + rest)
    for j in range(runs):
        rows = part[:, j * tile:(j + 1) * tile].reshape((nt * tile,) + rest)
        shift = j * tile - band
        if abs(shift) >= n:
            continue                    # band wider than the whole input
        if shift >= 0:
            total[shift:] += rows[:n - shift]
        else:
            total[:n + shift] += rows[-shift:]
    return total


def place_table_grads(dtabs, bin_lo, num_bins_full):
    """Table-slice grads ``[nb,h,d,3]`` -> zero ``[L,h,d,3]`` with the slice
    at row ``bin_lo`` (None passing through)."""
    out = []
    for t in dtabs:
        if t is not None and t.shape[0] != num_bins_full:
            full = t.new_zeros((num_bins_full,) + tuple(t.shape[1:]))
            full[bin_lo:bin_lo + t.shape[0]] = t
            t = full
        out.append(t)
    return tuple(out)


def _sum_tables(acc, dt):
    return [a if b is None else (b if a is None else a + b)
            for a, b in zip(acc, dt)]


def band_attention_bwd_plain(q, k, v, xyz, seg_start, seg_end, valid, g, o,
                             m, den, table_q=None, table_k=None, table_v=None,
                             *, window_size, quant_size, scale, band,
                             tile=128, fast=False, slice_rows=None,
                             rpe_mode="stratified"):
    """Backward of the dense half w.r.t. ``(q, k, v, table_q/k/v)``.

    Arguments as `band_attention_plain`, plus the output cotangent ``g``
    ``[N,h,d]``, the normalised merged output ``o`` ``[N,h,d]`` and the
    statistics ``m``/``den`` ``[N,h]`` merged over BOTH halves. Returns
    ``(dq, dk, dv, dtq, dtk, dtv)``; a table's grad is None when the table
    is. dk/dv are composed from per-tile slots by absolute key position
    (`compose_band`), so any ``band`` works. ``fast``: the bf16 form;
    ``slice_rows``: round the key masses per that many rows of a tile, as
    the CUDA kernel's row slices do (None: per tile, as the TPU kernel);
    ``rpe_mode``: as `band_attention_plain` (the swin tables' grads cover
    every row).
    """
    n, h, d = q.shape
    if n % tile:
        raise ValueError(f"N={n} is not a multiple of tile={tile}")
    nt = n // tile
    w = tile + 2 * band
    dev = q.device
    rnd = _rounding(fast)
    qf = rnd(q.to(torch.float32) * scale)
    kf, vf = rnd(k.to(torch.float32)), rnd(v.to(torch.float32))
    gf, of = g.to(torch.float32), o.to(torch.float32)
    mf, denf = m.to(torch.float32), den.to(torch.float32)
    xf = xyz.to(torch.float32)
    num_bins_full = num_bins(table_q, table_k, table_v)
    bin_lo, nb = band_slice(num_bins_full, rpe_mode)
    tables = _round_tables(tuple(None if tb is None else
                                 tb.to(torch.float32)[bin_lo:bin_lo + nb]
                                 for tb in (table_q, table_k, table_v)), fast)

    dq = torch.empty(n, h, d, dtype=torch.float32, device=dev)
    dk_part = torch.empty(nt, w, h, d, dtype=torch.float32, device=dev)
    dv_part = torch.empty_like(dk_part)
    dtabs = [None, None, None]
    for s, e in _tile_batches(nt, tile, w, h):
        rows = torch.arange(s * tile, e * tile, device=dev).view(e - s, tile)
        pos = (torch.arange(s, e, device=dev)[:, None] * tile - band
               + torch.arange(w, device=dev)[None])                 # [B,W]
        inside = (pos >= 0) & (pos < n)
        safe = pos.clamp(0, n - 1)
        mask = ((pos[:, None, :] >= seg_start[rows][..., None].long())
                & (pos[:, None, :] < seg_end[rows][..., None].long())
                & valid[rows][..., None]
                & (valid[safe] & inside)[:, None, :])
        dq_, dk_part[s:e], dv_part[s:e], dt = _triple_bwd(
            qf[rows], xf[rows], kf[safe], vf[safe], xf[safe], mask, tables,
            gf[rows], of[rows], mf[rows], denf[rows], fast, slice_rows,
            window_size=window_size, quant_size=quant_size,
            num_bins_full=num_bins_full, bin_lo=bin_lo, nb=nb,
            rpe_mode=rpe_mode)
        dq[s * tile:e * tile] = dq_.reshape(-1, h, d)
        dtabs = _sum_tables(dtabs, dt)
    return (dq * scale, compose_band(dk_part, band, tile, n),
            compose_band(dv_part, band, tile, n)) + place_table_grads(
                dtabs, bin_lo, num_bins_full)


def sparse_inputs(q, k, v, sb, scale):
    """Queries in large-window order and keys/values in aux order — the
    gathers that sit outside the sparse kernel. Returns ``(q_lw, k_aux,
    v_aux)``; q is pre-scaled, empty aux slots are zero."""
    n = q.shape[0]
    q_lw = (q.to(torch.float32) * scale)[sb.lw_map.long()]
    src = sb.sb_src.clamp(0, n - 1).long()
    ok = sb.sb_valid[:, None, None]
    k_aux = torch.where(ok, k.to(torch.float32)[src], 0.0)
    v_aux = torch.where(ok, v.to(torch.float32)[src], 0.0)
    return q_lw, k_aux, v_aux


def sparse_window(sb, tile, s_band):
    """``(s, bases)``: the aux window width and each tile's first slot,
    ``((min(sb_start[t0], A - s)) // 16) * 16`` (``fused_attention.py:
    529-536``). Keys of a tile's segments beyond the window are dropped
    (capacity capping)."""
    a_sz = sb.sb_src.shape[0]
    s = min(s_band, a_sz)
    first = sb.sb_start[::tile].long()
    return s, (torch.clamp(first, max=a_sz - s) // 16) * 16


def sparse_band_attention_plain(q, k, v, sb, table_q=None, table_k=None,
                                table_v=None, *, window_size, quant_size,
                                scale, s_band=128, tile=128, fast=False):
    """Far-key half over the `SparseBandLayout` aux arrays.

    q/k/v ``[N,h,d]`` in small-window-sorted order. Each lw-ordered query
    tile reads ``s`` aux slots from its base; the mask is the query's aux
    segment ``[sb_start, sb_end)`` ∧ not its own small window ∧ valid. Bins
    span the full ±2·window range. Returns the triple in small-sorted order.
    ``fast``: the bf16 form (the TPU kernel stages fp32 and rounds in its
    DEFAULT products, ``fused_attention.py:494-499``).
    """
    if q.shape[0] % tile:
        raise ValueError(f"N={q.shape[0]} is not a multiple of tile={tile}")
    acc, m, den = sparse_triple_lw(
        *sparse_inputs(q, k, v, sb, scale), sb, table_q, table_k, table_v,
        window_size=window_size, quant_size=quant_size, s_band=s_band,
        tile=tile, fast=fast)
    u = sb.lw_unmap.long()
    return acc[u], m[u], den[u]


def sparse_triple_lw(q_lw, k_aux, v_aux, sb, table_q=None, table_k=None,
                     table_v=None, *, window_size, quant_size, s_band=128,
                     tile=128, fast=False):
    """The far-key triple in large-window order, from the pre-scaled
    queries ``q_lw [N,h,d]`` in lw order and the keys and values ``k_aux,
    v_aux [A,h,d]`` in aux order (as `sparse_inputs` gathers them)."""
    n, h, d = q_lw.shape
    nt = n // tile
    dev = q_lw.device
    rnd = _rounding(fast)
    q_lw, k_aux, v_aux = rnd(q_lw), rnd(k_aux), rnd(v_aux)
    s, bases = sparse_window(sb, tile, s_band)
    num_bins_full = num_bins(table_q, table_k, table_v)
    tables = _round_tables(tuple(None if tb is None else tb.to(torch.float32)
                                 for tb in (table_q, table_k, table_v)), fast)
    x_lw = sb.xyz_lw.to(torch.float32)
    x_aux = sb.sb_xyz.to(torch.float32)

    acc = torch.empty(n, h, d, dtype=torch.float32, device=dev)
    m = torch.empty(n, h, dtype=torch.float32, device=dev)
    den = torch.empty(n, h, dtype=torch.float32, device=dev)
    for s0, e0 in _tile_batches(nt, tile, s, h):
        rows = torch.arange(s0 * tile, e0 * tile, device=dev).view(
            e0 - s0, tile)
        pos = bases[s0:e0, None] + torch.arange(s, device=dev)[None]
        mask = ((pos[:, None, :] >= sb.sb_start[rows][..., None].long())
                & (pos[:, None, :] < sb.sb_end[rows][..., None].long())
                & (sb.sb_skey[pos][:, None, :]
                   != sb.q_skey_lw[rows][..., None])
                & sb.valid_lw[rows][..., None]
                & sb.sb_valid[pos][:, None, :])
        chunk = ((pos - pos[:, :1]) // FAST_CHUNK if fast else None)
        a_, m_, d_ = _triple(
            q_lw[rows], x_lw[rows], k_aux[pos], v_aux[pos], x_aux[pos],
            mask, tables, chunk, rnd, window_size=window_size,
            quant_size=quant_size, num_bins_full=num_bins_full, bin_lo=0,
            nb=num_bins_full)
        acc[s0 * tile:e0 * tile] = a_.reshape(-1, h, d)
        m[s0 * tile:e0 * tile] = m_.reshape(-1, h)
        den[s0 * tile:e0 * tile] = d_.reshape(-1, h)
    return acc, m, den


def sparse_bwd_finish(sb, dq_lw, dk_part, dv_part, bases):
    """The plain PyTorch around the sparse backward (``fused_attention_bwd.
    py:797-812``): dq from lw order back to small-window order; dk/dv from
    each tile's window ``[nt, s, h, d]`` scatter-added into aux slots, then
    into points through ``sb_src`` where ``sb_valid``."""
    n = dq_lw.shape[0]
    nt, s = dk_part.shape[:2]
    rest = tuple(dk_part.shape[2:])
    slots = (bases[:, None] + torch.arange(s, device=bases.device)[None]
             ).reshape(-1)
    src = sb.sb_src.clamp(0, n - 1).long()
    ok = sb.sb_valid.reshape((-1,) + (1,) * len(rest))
    out = []
    for part in (dk_part, dv_part):
        aux = part.new_zeros((sb.sb_src.shape[0],) + rest).index_add_(
            0, slots, part.reshape((nt * s,) + rest))
        out.append(part.new_zeros((n,) + rest).index_add_(
            0, src, torch.where(ok, aux, 0.0)))
    return dq_lw[sb.lw_unmap.long()], out[0], out[1]


def sparse_band_attention_bwd_plain(q, k, v, sb, g, o, m, den, table_q=None,
                                    table_k=None, table_v=None, *,
                                    window_size, quant_size, scale,
                                    s_band=128, tile=128, fast=False,
                                    slice_rows=None):
    """Backward of the far-key half w.r.t. ``(q, k, v, table_q/k/v)``.

    q/k/v/g/o ``[N,h,d]`` and m/den ``[N,h]`` in small-window-sorted order,
    the statistics merged over BOTH halves. Returns ``(dq, dk, dv, dtq, dtk,
    dtv)`` in small-window order; the tables' grads cover every bin.
    ``fast``, ``slice_rows``: as `band_attention_bwd_plain`.
    """
    n, h, d = q.shape
    if n % tile:
        raise ValueError(f"N={n} is not a multiple of tile={tile}")
    nt = n // tile
    dev = q.device
    rnd = _rounding(fast)
    q_lw, k_aux, v_aux = (rnd(t) for t in sparse_inputs(q, k, v, sb, scale))
    lw = sb.lw_map.long()
    g_lw, o_lw = g.to(torch.float32)[lw], o.to(torch.float32)[lw]
    m_lw, den_lw = m.to(torch.float32)[lw], den.to(torch.float32)[lw]
    s, bases = sparse_window(sb, tile, s_band)
    num_bins_full = num_bins(table_q, table_k, table_v)
    tables = _round_tables(tuple(None if tb is None else tb.to(torch.float32)
                                 for tb in (table_q, table_k, table_v)), fast)
    x_lw = sb.xyz_lw.to(torch.float32)
    x_aux = sb.sb_xyz.to(torch.float32)

    dq_lw = torch.empty(n, h, d, dtype=torch.float32, device=dev)
    dk_part = torch.empty(nt, s, h, d, dtype=torch.float32, device=dev)
    dv_part = torch.empty_like(dk_part)
    dtabs = [None, None, None]
    for s0, e0 in _tile_batches(nt, tile, s, h):
        rows = torch.arange(s0 * tile, e0 * tile, device=dev).view(
            e0 - s0, tile)
        pos = bases[s0:e0, None] + torch.arange(s, device=dev)[None]
        mask = ((pos[:, None, :] >= sb.sb_start[rows][..., None].long())
                & (pos[:, None, :] < sb.sb_end[rows][..., None].long())
                & (sb.sb_skey[pos][:, None, :]
                   != sb.q_skey_lw[rows][..., None])
                & sb.valid_lw[rows][..., None]
                & sb.sb_valid[pos][:, None, :])
        dq_, dk_part[s0:e0], dv_part[s0:e0], dt = _triple_bwd(
            q_lw[rows], x_lw[rows], k_aux[pos], v_aux[pos], x_aux[pos],
            mask, tables, g_lw[rows], o_lw[rows], m_lw[rows], den_lw[rows],
            fast, slice_rows, window_size=window_size, quant_size=quant_size,
            num_bins_full=num_bins_full, bin_lo=0, nb=num_bins_full)
        dq_lw[s0 * tile:e0 * tile] = dq_.reshape(-1, h, d)
        dtabs = _sum_tables(dtabs, dt)
    return sparse_bwd_finish(sb, dq_lw * scale, dk_part, dv_part,
                             bases) + tuple(dtabs)


def merge(parts):
    """Compose online-softmax triples ``[(acc, m, den), ...]`` into
    ``(normalised out, merged m, merged den)`` (``attention_fused.py:
    129-141``)."""
    m = parts[0][1]
    for p in parts[1:]:
        m = torch.maximum(m, p[1])
    m = m.clamp_min(NEG_INF)
    acc = 0.0
    den = 0.0
    for a, mi, di in parts:
        s = torch.exp(mi - m)
        acc = acc + a * s[..., None]
        den = den + di * s
    return acc / den.clamp_min(1e-20)[..., None], m, den
