"""Truncation counters: how many attention pairs the static capacities drop
on the current batch (the JAX package's ``train/audit.py:33-175``).

Three capacities bound the attention layout:

  * the dense band: a query in tile ``t0`` sees keys only within ``[t0 -
    band, t0 + tile + band)`` of the window-sorted order;
  * the far-key band: a query tile reads one contiguous ``s_band``-wide
    window of the aux array of far keys;
  * ``sparse_cap``: at most that many members of a large window enter the
    aux array.

The training loop logs the drop fraction of each, per stage, every
``print_freq * audit_freq`` iterations (``truncation_audit``, default on),
so that a denser dataset cannot silently eat pairs. The counters come from
the plans the forward builds, over the levels of the batch's host pyramid,
on the batch's device.
"""

from __future__ import annotations

import torch

from stratified_transformer_torch.ops import sampling
from stratified_transformer_torch.ops.plan import build_attention_plan

FIELDS = ("band_dropped", "band_total", "sband_dropped", "sband_total",
          "cap_dropped", "cap_total")


def _dense_band_drops(plan, band, tile):
    """Dropped and total in-window dense pairs under the band layout."""
    s, e = plan.seg_start.long(), plan.seg_end.long()
    pos = torch.arange(s.shape[0], device=s.device)
    t0 = (pos // tile) * tile
    vis = (torch.minimum(e, t0 + tile + band)
           - torch.maximum(s, t0 - band)).clamp_min(0)
    tot = (e - s).clamp_min(0)
    v = plan.valid_sorted
    return (torch.where(v, tot - vis, 0).sum(),
            torch.where(v, tot, 0).sum())


def _sparse_band_drops(plan, s_band, tile):
    """Dropped and total far-key pairs under the ``s_band`` aux window
    (the tile base of ``sparse_band_attention``)."""
    sb = plan.sparse_band
    a_sz = sb.sb_src.shape[0]
    ws_band = min(s_band, a_sz)
    ks = sb.sb_start.long().reshape(-1, tile)
    ke = sb.sb_end.long().reshape(-1, tile)
    base = (torch.clamp_max(ks[:, 0], a_sz - ws_band) // 16) * 16
    vis = (torch.minimum(ke, (base + ws_band)[:, None])
           - torch.maximum(ks, base[:, None])).clamp_min(0)
    tot = (ke - ks).clamp_min(0)
    v = sb.valid_lw.reshape(-1, tile)
    return (torch.where(v, tot - vis, 0).sum(),
            torch.where(v, tot, 0).sum())


def _stage_stats(xyz, offsets, is_down, *, ws, band, tile, s_band,
                 sparse_cap, aux_pad):
    """The six counters of one stage over both shift parities, in
    `FIELDS` order."""
    n = xyz.shape[0]
    batch = sampling.offsets_to_batch(offsets, n)
    valid = sampling.offsets_to_valid(offsets, n)
    out = torch.zeros(6, dtype=torch.int64, device=xyz.device)
    for parity in (0, 1):
        plan = build_attention_plan(
            xyz, batch, valid, ws, shifted=bool(parity), is_down=is_down,
            sparse_cap=sparse_cap, aux_pad=aux_pad)
        out[0:2] += torch.stack(_dense_band_drops(plan, band, tile))
        out[2:4] += torch.stack(_sparse_band_drops(plan, s_band, tile))
        out[4] -= plan.sparse_band.sb_valid.sum()
    out[5] = 2 * (is_down & valid).sum()
    out[4] += out[5]
    return out


@torch.no_grad()
def audit_truncation_packed(cfg, batch):
    """The counters of every transformer stage of one batch with a host
    pyramid (``xyz``, ``offsets``, ``pyramid`` on one device) as ONE int64
    tensor ``[num_layers - layer_start, 6]`` on that device: row ``r`` is
    stage ``layer_start + r`` at pyramid level ``layer_start + r``, columns
    in `FIELDS` order. One tensor, one transfer when the loop reads it."""
    pyramid = batch["pyramid"]
    levels = [(batch["xyz"], batch["offsets"])]
    for lvl in pyramid["down"]:
        levels.append((levels[-1][0][lvl["idx"].long()], lvl["offsets"]))
    rows = []
    for r, i in enumerate(range(cfg.layer_start, cfg.num_layers)):
        lx, loff = levels[i]
        d_pad = lx.shape[0] // cfg.downsample_scale + cfg.num_scenes
        rows.append(_stage_stats(
            lx, loff.long(), pyramid["stage_down"][r]["is_down"],
            ws=cfg.window_sizes()[i], band=cfg.stage_band(i), tile=cfg.tile,
            s_band=cfg.s_band, sparse_cap=cfg.sparse_cap,
            aux_pad=((d_pad + 127) // 128) * 128))
    return torch.stack(rows)


def unpack_truncation(cfg, arr):
    """numpy ``[stages, 6]`` -> ``{stage_i: {field: int}}`` for the stages
    ``layer_start..num_layers-1``, the JAX package's ``audit_truncation``
    dict."""
    keys = [f"stage_{i}" for i in range(cfg.layer_start, cfg.num_layers)]
    return {k: {f: int(arr[si, fi]) for fi, f in enumerate(FIELDS)}
            for si, k in enumerate(sorted(keys))}


def format_truncation(stats) -> str:
    """One log line: per-stage drop fractions (b=band, s=s_band window,
    c=sparse_cap members)."""
    parts = []
    for k in sorted(stats):
        s = stats[k]

        def frac(d, t):
            d, t = int(d), int(t)
            return d / t if t else 0.0
        parts.append(
            f"{k.replace('stage_', 's')}: "
            f"b={frac(s['band_dropped'], s['band_total']):.4f} "
            f"s={frac(s['sband_dropped'], s['sband_total']):.4f} "
            f"c={frac(s['cap_dropped'], s['cap_total']):.4f}")
    return "pair-drop fractions [" + "; ".join(parts) + "]"
