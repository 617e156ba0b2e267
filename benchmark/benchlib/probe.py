"""The traced run's measurements, shared by the per-layer metric readers.

`Probe` holds the live objects of a cell after its window (the program's
configuration, one batch on the device, the call the window drives) and
measures on demand, once each: the profiler over a few steady calls (the
device-busy time of a call, its idle share), the attention calls
timed alone on the batch's own plans, the on-device geometry timed alone,
and the model FLOPs of a call from the reference's own plans. A reader
(``metrics/<name>.py``) takes what it needs and returns None where there
is nothing to read.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from benchlib import arith, devtime


def attention_launches():
    """Launches so far of the four attention kernels (fp32 and bf16 entry
    points), by source: the counts the program's wrappers keep."""
    from stratified_transformer_torch.kernels import (
        band_attention, band_attention_bwd, sparse_band_attention,
        sparse_band_attention_bwd)
    return {m.__name__.rsplit(".", 1)[1]:
            m.KERNEL.launches + m.KERNEL_FAST.launches
            for m in (band_attention, band_attention_bwd,
                      sparse_band_attention, sparse_band_attention_bwd)}


def stage_blocks(cfg, stage):
    """Blocks of ``stage`` on the unshifted and the shifted plan."""
    return {False: (cfg.depths[stage] + 1) // 2, True: cfg.depths[stage] // 2}


def levels_of(cfg, xyz, offsets, pyramid):
    """``[(xyz, offsets, is_down or None)]`` per level of a batch whose
    pyramid is ``pyramid`` (tensors or numpy arrays alike)."""
    out = []
    for i in range(cfg.num_layers):
        is_down = (pyramid["stage_down"][i - cfg.layer_start]["is_down"]
                   if i >= cfg.layer_start and cfg.use_stratified else None)
        out.append((xyz, offsets, is_down))
        if i < cfg.num_layers - 1:
            lvl = pyramid["down"][i]
            xyz, offsets = xyz[lvl["idx"]], lvl["offsets"]
    return out


def _plan(build, sampling, cfg, stage, level, shifted):
    xyz, offsets, is_down = level
    n = xyz.shape[0]
    d_pad = n // cfg.downsample_scale + cfg.num_scenes
    return build(xyz, sampling.offsets_to_batch(offsets, n),
                 sampling.offsets_to_valid(offsets, n),
                 cfg.window_sizes()[stage], shifted=shifted, is_down=is_down,
                 sparse_cap=cfg.sparse_cap,
                 aux_pad=((d_pad + 127) // 128) * 128
                 if is_down is not None else None)


def _tensor_levels(levels, device):
    def t(x):
        if x is None or torch.is_tensor(x):
            return x
        a = np.asarray(x)
        return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu"
                                else a).to(device)
    return [(t(x).to(device), t(o).to(device).long(),
             None if d is None else t(d).to(device)) for x, o, d in levels]


def attention_counts(ref_cfg, levels, device, fast):
    """From the reference's own plans of ``levels``: per call of a forward
    or train step, the attention's least seconds forward and backward, its
    model operations forward and backward (recomputation left out), and
    the valid points of each level. ``fast``: the products at the bf16
    peak, as the configuration runs them."""
    from reference.ops import attention as ref_attn
    from reference.ops import sampling
    from reference.ops.plan import build_attention_plan
    levels = _tensor_levels(levels, device)
    out = {"least_fwd_s": 0.0, "least_bwd_s": 0.0, "ops_fwd": 0.0,
           "ops_bwd": 0.0,
           "points": [int(o[-1]) for _, o, _ in levels]}
    for i in range(ref_cfg.layer_start, ref_cfg.num_layers):
        h = ref_cfg.num_heads[i]
        d = ref_cfg.channels[i] // h
        ws, qs = ref_cfg.window_sizes()[i], ref_cfg.quant_sizes()[i]
        nbf = 2 * int((2 * ws + 1e-4) // qs)
        nb = ref_attn.band_slice(nbf)[1]
        band = ref_cfg.stage_band(i)
        n = levels[i][0].shape[0]
        for shifted, blocks in stage_blocks(ref_cfg, i).items():
            if not blocks:
                continue
            plan = _plan(build_attention_plan, sampling, ref_cfg, i,
                         levels[i], shifted)
            nq = int(plan.valid_sorted.sum())
            bp = arith.band_pairs(plan, band, ref_cfg.tile)
            halves = [(bp, nq, nq, nb, arith.band_bytes(n, h, d, nb, 3),
                       arith.band_bytes_bwd(n, h, d, nb, 3))]
            if plan.sparse_band is not None:
                a = plan.sparse_band.sb_src.shape[0]
                sp, sq, sk = arith.sparse_pairs(plan, ref_cfg.s_band,
                                                ref_cfg.tile)
                halves.append((sp, sq, sk, nbf,
                               arith.sparse_bytes(n, a, h, d, nbf, 3),
                               arith.sparse_bytes_bwd(n, a, h, d, nbf, 3)))
            for pairs, nq_, nk_, rows, fb, bb in halves:
                fo = arith.least_ops(pairs, nq_, nk_, h, d, rows, split=fast)
                bo = arith.least_ops_bwd(pairs, nq_, nk_, h, d, rows,
                                         split=fast)
                out["least_fwd_s"] += blocks * arith.least_seconds(fo, fb)
                out["least_bwd_s"] += blocks * arith.least_seconds(bo, bb)
                out["ops_fwd"] += blocks * arith.least_ops(
                    pairs, nq_, nk_, h, d, rows)
                out["ops_bwd"] += blocks * (
                    arith.least_ops_bwd(pairs, nq_, nk_, h, d, rows)
                    - arith.recomputed_ops(pairs, nq_, nk_, h, d, rows))
    return out


def attention_device_ms(cfg, levels, device, backward, seed=0):
    """Device ms per call (a forward, or a train step's forward and
    backward) of the program's public attention Function alone, on the
    program's plans of ``levels`` with the cell's block shapes and random
    q, k, v and tables: each (stage, parity) timed by `device_busy_ms`
    and counted once per block. Returns ``(forward ms, backward ms)``."""
    from stratified_transformer_torch.ops import sampling
    from stratified_transformer_torch.ops.attention_fused import (
        stratified_attention_fused)
    from stratified_transformer_torch.ops.plan import build_attention_plan
    levels = _tensor_levels(levels, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    fwd = bwd = 0.0
    for i in range(cfg.layer_start, cfg.num_layers):
        h = cfg.num_heads[i]
        d = cfg.channels[i] // h
        ws, qs = cfg.window_sizes()[i], cfg.quant_sizes()[i]
        nbf = 2 * int((2 * ws + 1e-4) // qs)
        n = levels[i][0].shape[0]
        q, k, v = (torch.randn(n, h, d, generator=gen, device=device)
                   .requires_grad_(backward) for _ in range(3))
        tables = [(torch.randn(nbf, h, d, 3, generator=gen, device=device)
                   * 0.02).requires_grad_(backward) for _ in range(3)]
        for shifted, blocks in stage_blocks(cfg, i).items():
            if not blocks:
                continue
            plan = _plan(build_attention_plan, sampling, cfg, i, levels[i],
                         shifted)
            call = functools.partial(
                stratified_attention_fused, q, k, v, plan.xyz_sorted,
                plan.seg_start, plan.seg_end, plan.valid_sorted,
                plan.sparse_band, *tables, window_size=ws, quant_size=qs,
                scale=d ** -0.5, band=cfg.stage_band(i), tile=cfg.tile,
                s_band=cfg.s_band, plain=cfg.attn_impl == "reference",
                fast=cfg.fast, rpe_mode=cfg.rpe_mode)

            def forward():
                with torch.no_grad():
                    call()
            fwd += blocks * devtime.device_busy_ms(forward, 3)
            if backward:
                out = call()
                g = torch.randn(out.shape, generator=gen, device=device)
                inputs = [q, k, v] + tables
                bwd += blocks * devtime.device_busy_ms(
                    lambda: torch.autograd.grad(out, inputs, g,
                                                retain_graph=True), 3)
                del out
    return fwd, bwd


class Probe:
    """The traced run's measurements of one cell (see the module's
    docstring). ``call`` is what the window drives (a train step on the
    next pooled batch, or one ``predict_probs``); ``levels`` the
    batch's levels as the program builds them (train: its host pyramid)
    and ``ref_levels_list`` ``(levels, stem pairs)`` of a few batches as
    the reference builds them; ``geometry`` the
    on-device geometry alone (None where the cell has none)."""

    def __init__(self, *, kind, cfg, ref_cfg, device, window, call,
                 call_ms, levels, ref_levels_list, launches,
                 geometry=None, profile_reps=3):
        self.kind = kind
        self.cfg = cfg
        self.ref_cfg = ref_cfg
        self.device = device
        self.window = window
        self.call_ms = call_ms
        self.call = call
        self.levels = levels
        self.ref_levels_list = ref_levels_list
        self.launches = launches
        self.geometry = geometry
        self.profile_reps = profile_reps

    @functools.cached_property
    def profile(self):
        return devtime.profile_window(self.call, self.profile_reps,
                                      self.launches)

    @property
    def busy_ms(self):
        """Device-busy ms of one call: the union of the device's activity
        over the profiled calls, per call. (A train step launches ~4500
        kernels, more than the card's launch queue holds, so behind a
        sleep kernel the host blocks before it has queued the step, and
        `devtime.device_busy_ms` reads nothing.)"""
        return self.profile["busy_s"] / self.profile_reps * 1e3

    def idle_share(self):
        """1 - the profiled calls' busy time per call over the window's
        wall time of such a call (``call_ms``: the window ran without the
        profiler, whose host overhead would stretch the wall)."""
        return 1.0 - self.busy_ms / self.call_ms

    @functools.cached_property
    def batch_counts(self):
        """`attention_counts` of each ``(levels, stem pairs)`` in
        ``ref_levels_list``, each with its dense FLOPs (``dense``); the
        first is the batch that `attention_ms` times."""
        out = []
        for lv, stem in self.ref_levels_list:
            c = attention_counts(self.ref_cfg, lv, self.device, self.cfg.fast)
            c["dense"] = arith.dense_flops(self.ref_cfg, c["points"], stem)
            out.append(c)
        return out

    @functools.cached_property
    def attention_ms(self):
        return attention_device_ms(self.cfg, self.levels, self.device,
                                   self.kind == "train")

    def flops_per_point(self):
        """Model FLOPs per valid input point over `batch_counts`: a train
        step's dense products three times (forward, and the input and
        weight gradients) and its attention forward and backward; an eval
        forward's once."""
        flops = sum(3 * c["dense"] + c["ops_fwd"] + c["ops_bwd"]
                    if self.kind == "train" else c["dense"] + c["ops_fwd"]
                    for c in self.batch_counts)
        return flops / sum(c["points"][0] for c in self.batch_counts)

    def mfu(self):
        """The window's model FLOPs over its wall time and the dense bf16
        peak."""
        w = self.window
        return (self.flops_per_point() * w["points"]
                / (w["wall_s"] * arith.PEAK_BF16))

    def attention_roofline(self):
        """The timed batch's attention least seconds over its device
        seconds, forward and (train) backward together (the first of
        `batch_counts` is the timed batch)."""
        c = self.batch_counts[0]
        fwd_ms, bwd_ms = self.attention_ms
        least = c["least_fwd_s"] + (c["least_bwd_s"] if self.kind == "train"
                                    else 0.0)
        return least * 1e3 / (fwd_ms + bwd_ms)

    @functools.cached_property
    def geometry_profile(self):
        """The profiler over two calls of the on-device geometry alone,
        held complete as calls of the same work (`devtime.profile_window`).
        (The geometry waits for the card, so behind a sleep kernel
        `devtime.device_busy_ms` reads nothing.)"""
        return devtime.profile_window(self.geometry, 2, self.launches,
                                      same_work=True)

    def geometry_ms(self):
        """Device ms of one call of the on-device geometry alone: the
        device time of its operations (`geometry_profile`)."""
        return sum(self.geometry_profile["ops"].values()) / 2 * 1e3
