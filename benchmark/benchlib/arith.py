"""The benchmark's frozen arithmetic: the card's peaks, the least operations
and bytes of the attention calls (copies of ``chip_smoke.py``'s
``least_ops``, ``least_ops_bwd``, ``ops_seconds`` and the pair counts
``band_pairs`` / ``sparse_pairs``), and the model FLOPs of an eval forward
or a train step, counted from the shapes and from the pair counts of the
reference's own plans. Nothing here imports the program."""

from __future__ import annotations

import torch

# H100 SXM (NVIDIA's data sheet, 700 W): fp32 outside the tensor cores,
# dense bf16 on the tensor cores, HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

# operations of one pair's bins on its three axes, shared by the heads
BIN_OPS = 24


def _table_ops(per_pair, pairs, nb, d, rows):
    """(products, other operations) of one table term at the cheaper of its
    per-pair form and its projection form."""
    if per_pair * pairs <= 6 * nb * d * rows + 3 * pairs:
        return per_pair * pairs, 0
    return 6 * nb * d * rows, 3 * pairs


def least_ops(pairs, n_q, n_k, h, d, nb, split=False, bin_ops=BIN_OPS):
    """Least operations of one attention half with cRPE tables on q, k and
    v over ``pairs`` unmasked pairs, ``n_q`` / ``n_k`` valid queries and
    keys in a pair, ``nb`` table rows per axis; with ``split`` as
    ``(products, other)``. Per pair and head: q·k and p·v (2d each), the
    online-softmax update (~5); per pair the bins; per table and head the
    cheaper of its per-pair form and its projection form."""
    parts = [(4 * d * pairs, 5 * pairs),
             _table_ops(6 * d, pairs, nb, d, n_q),
             _table_ops(6 * d, pairs, nb, d, n_k),
             _table_ops(3 * d, pairs, nb, d, n_q)]
    ops = (h * sum(p for p, _ in parts),
           h * sum(o for _, o in parts) + bin_ops * pairs)
    return ops if split else sum(ops)


def least_ops_bwd(pairs, n_q, n_k, h, d, nb, split=False, bin_ops=BIN_OPS):
    """Least operations of one backward half: per pair and head the
    recomputed q·k, g·v, dq, dk and dv products (10d), r and dl (~5); per
    query g·o (2d); the bins; eight table terms (the logit's Tq and Tk,
    gv's Tv, dq's Tq, dk's Tk and the grads dTq, dTk, dTv)."""
    parts = ([(10 * d * pairs, 5 * pairs + 2 * d * n_q)]
             + [_table_ops(6 * d, pairs, nb, d, n_q)] * 5
             + [_table_ops(6 * d, pairs, nb, d, n_k)] * 3)
    ops = (h * sum(p for p, _ in parts),
           h * sum(o for _, o in parts) + bin_ops * pairs)
    return ops if split else sum(ops)


def recomputed_ops(pairs, n_q, n_k, h, d, nb, bin_ops=BIN_OPS):
    """The part of `least_ops_bwd` that recomputes the forward's logits
    (q·k, the Tq and Tk terms, the bins): model FLOPs leave it out."""
    tq = _table_ops(6 * d, pairs, nb, d, n_q)
    tk = _table_ops(6 * d, pairs, nb, d, n_k)
    return h * (2 * d * pairs + sum(tq) + sum(tk)) + bin_ops * pairs


def ops_seconds(ops):
    """Least seconds of ``(products, other)``: the products at the bf16
    tensor-core peak and the rest at the fp32 peak, on units that may run
    together; a plain number is all fp32."""
    if isinstance(ops, tuple):
        return max(ops[0] / PEAK_BF16, ops[1] / PEAK_FP32)
    return ops / PEAK_FP32


def least_seconds(ops, nbytes):
    """The larger of the operations' and the bytes' least times."""
    return max(ops_seconds(ops), nbytes / PEAK_BYTES)


def band_pairs(plan, band, tile):
    """Unmasked (query, key) pairs of the dense half of ``plan``."""
    n = plan.seg_start.shape[0]
    dev = plan.seg_start.device
    rows = torch.arange(n, device=dev)
    t0 = (rows // tile) * tile
    lo = torch.maximum(plan.seg_start.long(), (t0 - band).clamp_min(0))
    hi = torch.minimum(plan.seg_end.long(), (t0 + tile + band).clamp_max(n))
    cum = torch.cat([torch.zeros(1, device=dev, dtype=torch.long),
                     plan.valid_sorted.long().cumsum(0)])
    cnt = (cum[hi.clamp_min(lo)] - cum[lo]) * plan.valid_sorted.long()
    return int(cnt.sum())


def sparse_pairs(plan, s_band, tile):
    """Unmasked pairs of the far-key half of ``plan``, and the queries and
    aux keys that take part in at least one."""
    sb = plan.sparse_band
    a_sz = sb.sb_src.shape[0]
    s = min(s_band, a_sz)
    first = sb.sb_start[::tile].long()
    bases = (torch.clamp(first, max=a_sz - s) // 16) * 16
    n = sb.sb_start.shape[0]
    pairs = queries = 0
    used = torch.zeros(a_sz, dtype=torch.bool, device=bases.device)
    step = max(1, (1 << 22) // (tile * s))
    for t0 in range(0, n // tile, step):
        t1 = min(t0 + step, n // tile)
        pos = bases[t0:t1, None] + torch.arange(s, device=bases.device)[None]
        rows = torch.arange(t0 * tile, t1 * tile,
                            device=bases.device).view(-1, tile)
        mask = ((pos[:, None, :] >= sb.sb_start[rows][..., None].long())
                & (pos[:, None, :] < sb.sb_end[rows][..., None].long())
                & (sb.sb_skey[pos][:, None, :]
                   != sb.q_skey_lw[rows][..., None])
                & sb.valid_lw[rows][..., None] & sb.sb_valid[pos][:, None, :])
        pairs += int(mask.sum())
        queries += int(mask.any(2).sum())
        used[pos[mask.any(1)]] = True
    return pairs, queries, int(used.sum())


def band_bytes(n, h, d, nb, tables):
    """Bytes one dense half must move: q, k, v, the points, their segment
    bounds and validity, the tables' band slices, read once; the triple
    written once (fp32, int32 and bool, as the model gives them)."""
    return (4 * (3 * n * h * d + 3 * n + 2 * n) + n
            + 4 * tables * nb * h * d * 3 + 4 * (n * h * d + 2 * n * h))


def sparse_bytes(n, a, h, d, nbf, tables):
    """Bytes one far-key half must move: q at the N queries, k and v at the
    A aux slots, the layout's per-query fields (coordinates, validity,
    small-window key, segment bounds, maps) and per-slot fields (source,
    key, coordinates, validity), the whole tables; the triple written."""
    return (4 * (n * h * d + 2 * a * h * d) + 4 * 8 * n + n
            + 4 * 5 * a + a + 4 * tables * nbf * h * d * 3
            + 4 * (n * h * d + 2 * n * h))


def band_bytes_bwd(n, h, d, nb, tables):
    """Bytes one dense backward must move: q, k, v, g, o, m, den and the
    layout read once; dq, dk, dv and the table slices' grads written."""
    return (4 * (5 * n * h * d + 2 * n * h + 5 * n) + n
            + 2 * 4 * tables * nb * h * d * 3 + 4 * 3 * n * h * d)


def sparse_bytes_bwd(n, a, h, d, nbf, tables):
    """Bytes one far-key backward must move (as `band_bytes_bwd`, with k
    and v at the aux slots and the whole tables)."""
    return (4 * (4 * n * h * d + 2 * a * h * d + 2 * n * h + 8 * n) + n
            + 4 * 5 * a + a + 2 * 4 * tables * nbf * h * d * 3
            + 4 * 3 * n * h * d)


def dense_flops(cfg, level_points, stem_pairs):
    """FLOPs of the forward's matrix products outside attention, over the
    valid points ``level_points[i]`` of each level and the stem's valid
    radius neighbours ``stem_pairs``: the blocks' qkv, proj, fc1 and fc2,
    the TransitionDown and Upsample projections, the head, and the KPConv
    stem (15 kernel points: the influence-weighted neighbour sums and the
    per-kernel-point weights; ScanNet's residual block's unaries too)."""
    c = cfg.channels
    n = level_points
    total = 0
    mlp = cfg.mlp_ratio
    for i in range(cfg.layer_start, cfg.num_layers):
        total += cfg.depths[i] * n[i] * 2 * c[i] * c[i] * (4 + 2 * mlp)
    for i in range(cfg.num_layers - 1):
        total += 2 * c[i] * c[i + 1] * n[i]                   # down
        total += 2 * c[i + 1] * c[i] * n[i + 1]               # up: linear2
        total += 2 * c[i] * c[i] * n[i]                       # up: linear1
    total += 2 * c[0] * c[0] * n[0] + 2 * c[0] * cfg.num_classes * n[0]
    p = 15
    total += 2 * p * cfg.in_channels * stem_pairs
    total += 2 * p * cfg.in_channels * c[0] * n[0]
    if not cfg.stem_transformer:
        q = c[0] // 4
        total += 2 * c[0] * q * n[0] + 2 * q * c[0] * n[0]
        total += 2 * p * q * stem_pairs + 2 * p * q * q * n[0]
    return total
