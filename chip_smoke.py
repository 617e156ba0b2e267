#!/usr/bin/env python3
"""Drive the PyTorch port's evaluation forward, training step, whole-scene
evaluation and training loop, for the S3DIS and ScanNet families, and its
two probes, on an NVIDIA GPU.

Run from the repository root with no arguments (needs one CUDA card):

    python3 chip_smoke.py

``python3 chip_smoke.py --fwd-only`` builds the two forward kernels and
runs phase 4 alone; ``--bwd-only`` builds the two backward kernels and runs
phase 7 alone; ``--scene-only`` builds the two forward kernels and runs
phase 10 alone; ``--loop-only`` builds the four attention kernels and runs
phase 11 alone; ``--scannet-only`` builds the four attention kernels and
runs phase 12 alone; ``--iou-only`` builds the two forward kernels and
times the train and eval steps' IoU counters (`iou_phase`). Each prints its
times as one JSON line (``--fwd-only`` also per stage and parity). Copied into another checkout (say a parent commit
unpacked beside the tree) and run from there, it times that checkout's
kernels and wrappers the same way, so two versions can be compared in
turns on one card.

Phases, each fatal on failure:
  1. device: card name, power limit, CUDA version; builds the six kernels
     from ``stratified_transformer_torch/csrc`` with nvcc (in parallel);
  2. host tier and plans: the S3DIS batch (N=40960, 2 scenes), and every
     attention plan built on the card bit-identical to the CPU plan;
  3. bins: the kernels' device bin function against
     ``relative_position_index`` on the CPU over a boundary-dense sweep;
  4. the forward kernels against their plain PyTorch versions at every
     stage's real shapes and plans: errors, CUDA-event times of the bare
     launch, the public wrapper's device-busy time from the profiler,
     bounds;
  5. the full-width S3DIS eval step (channels 48/96/192/384, heads
     3/6/12/24, depths 2/2/6/2) on 3 synthetic batches, with random weights
     scaled for O(1) activations: each batch's pairs per stage
     (``[pairs]``), finite loss, 12 + 12 kernel launches per forward,
     logits equal to the same forward through the plain versions;
  6. one profiled forward: device time by kernel and the busy share;
  7. the two backward kernels against their plain versions at every stage's
     real shapes and plans (cotangent and merged residuals of the forward):
     errors, CUDA-event times of the bare launch and of the public wrapper
     (its input copies, zeroed partials and the sums around the launch),
     the wrapper's device-busy time from the profiler, bounds;
  8. three full-width training steps after one warm-up step (AdamW, the
     YAML's schedule, drop-path 0.3 from a seeded generator, augmented
     synthetic batches, whose pairs per stage it logs):
     finite loss, 12 launches of each of the four kernels per step, every
     parameter's gradient after step 1 and the 3-step loss trajectory equal
     to the same steps through the plain versions; one profiled step;
  9. the probes (``stratified_transformer_torch/tools``): the bin-math
     kernel equal to its plain version on the CPU on all 65536 sweep values
     (``[probe]`` line with the probe's counts), and the cache-key probe run
     twice in fresh processes, both reporting the same keys as this process
     and every library reused; both probe kernels timed;
 10. whole-scene evaluation (``test.py``'s protocol, no host pyramid):
     (a) at phase 2's batch, the on-device stem radius neighbours and
     geometry pyramid (every sampling, kNN, 3-NN and member mask) and FPS
     and blocked FPS once, bit-identical between the card and the CPU;
     (b) one full-width forward without a pyramid through the kernels (12
     + 12 launches), logits equal to the plain-version forward's; (c) the
     full protocol (7 TTA passes x vote chunks x sphere crops) on one
     300000-point synthetic scene at ``n_pad`` 400000 in 5 crops: seconds,
     forwards, points per second, launches, peak memory, the first TTA
     pass's accumulated probabilities against the plain-version path's,
     and one profiled 400000-point forward with the device time of its
     on-device pyramid and of the attention kernels;
 11. the training driver's epoch loop (``train/driver.py::run``) at full
     width on the YAML's own batch shape (140000 points in 8 scene slots),
     fed by the ordered prefetch loader from synthetic rooms: 2 epochs of 4
     steps with validation and the truncation audit; 12 launches of each
     attention kernel per step and 12 forward, 0 backward per validation
     forward, finite losses; step walls, load-wait / upload / step-block
     seconds, points per second, points and scenes per batch, the audit's
     drop fractions, validation time, peak memory; the same loop with the
     batches built inline; the first loader batch's gradients against the
     plain-version step; the last checkpoint restored into a fresh model
     giving bit-identical logits; one profiled loader-fed step;
 12. the ScanNet family (``configs/scannetv2_stratified.yaml``: the
     KPConvRes stem and ``stem_down`` level, transformer stages 1-4 with
     depths 3/9/3/3, 80 cRPE table rows per axis, ignore label -100) at
     full width on the YAML's batch shape (n_pad 250112, 2 scene slots,
     synthetic rooms voxelized at 0.02 m and cropped to ``voxel_max``
     120000): (a) the four attention kernels against their plain versions
     at every transformer stage's real plans, with times and bounds; (b)
     three eval forwards, 18 + 18 launches each, logits against the
     plain-version forward, one profiled; (c) three training steps after a
     warm-up (the YAML's AdamW groups and warm-up schedule, drop-path 0.3),
     18 launches of each kernel per step, step-1 gradients and the loss
     trajectory against the plain versions, one profiled; (d) the training
     driver's loop for 1 epoch of 2 steps with validation and the audit of
     stages 1-4; (e) the on-device pyramid at (a)'s batch bit-identical to
     the CPU's, then ``test.py``'s protocol at its ScanNet operating point
     (``n_pad`` 600000 in 5 crops, 5 TTA passes, colours in [-1, 1]) on one
     200000-point synthetic room of 5 m, the stem search's largest cell key
     held below ``DENSE_KEYS``, the first pass against the plain path.

Prints a ``kernels`` JSON line, the card's name and power limit, and as its
last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when no CUDA card is present.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "s3dis_stratified.yaml")
SCANNET_CONFIG = os.path.join(REPO, "configs", "scannetv2_stratified.yaml")
N_PAD, SCENES = 40960, 2
EVAL_BATCHES = 3
TRAIN_STEPS = 3
# the synthetic train set's iterations per epoch (train.py's BatchLoader
# over 32 synthetic scenes in batches of 2): epoch-stepped schedules read it
TRAIN_ITERS_PER_EPOCH = 16
# H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the tensor cores
# and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# kernel vs plain version, both fp32: sums in another order (per-key online
# softmax vs two-pass, per-pair table terms vs per-bin mass)
RTOL, ATOL = 2e-4, 2e-5
# logits after 12 attention blocks and the U-Net: the same reorderings
# compounded through the layers
LOGIT_RTOL, LOGIT_ATOL = 1e-3, 1e-4
# backward kernel vs plain version: |err| <= BWD_RTOL |want| + BWD_FLOOR
# max|want| per tensor. dk/dv sum a key's queries over row slices and
# tiles; the table grads sum ~1e5-1e6 pair terms per entry through bin
# masses (per row, per key) and their products with q, k and g, in another
# order than the plain version, and cancel, so near-zero entries of a large
# sum carry the sum's own rounding (a floor of 1e-5 of its largest entry)
BWD_RTOL, BWD_FLOOR = 5e-4, 1e-5
# one training step, kernels vs plain versions (same weights, batch and
# drop-path masks): each parameter's gradient within 1e-3 relative L2 over
# the tensor plus an fp32 noise floor of 1e-6 per entry, which decides only
# the five biases whose gradient is 0 in exact arithmetic (a constant shift
# of the head's input is removed by the training-mode BatchNorm). Two fp32
# backward passes through 12 blocks whose sums run in other orders.
GRAD_REL_L2, GRAD_FLOOR = 1e-3, 1e-6
# the 3-step loss trajectories: the same grads through AdamW's sign-like
# first steps
LOSS_RTOL = 1e-3
# whole-scene evaluation (phase 10): test.py's operating point with the
# S3DIS YAML (batch_size_test 5 x voxel_max 80000 = n_pad 400000) on one
# synthetic scene of this many points (seed 999, as test.py's)
SCENE_POINTS = 300000
# the first TTA pass's accumulated probabilities, kernels vs plain
# versions: softmaxes of logits within LOGIT_RTOL / LOGIT_ATOL (phase 5
# sees ~5e-6), summed per point over its vote chunks and normalised, so
# equal to ~1e-5; 1e-4 per entry leaves an order of magnitude. Labels must
# agree wherever the plain path's top two differ by more than 2e-4.
SCENE_PROB_ATOL, SCENE_MARGIN = 1e-4, 2e-4
# phase 11: the training driver's epoch loop (train.py::main) on the YAML's
# own batch shape (max_batch_points 140000 in batch_size 8 scene slots,
# voxel_max 80000) over synthetic rooms of 60000 raw points in 6 m (about
# 40000-46000 after the 0.04 m voxels, so 3 scenes and ~125000 valid points
# fit a batch): 32 rooms are 4 iterations per epoch, 2 epochs, validation
# after each (4 forwards), the audit on each epoch's first iteration
LOOP_OVERRIDES = [
    "data_name", "synthetic", "max_batch_points", "140000", "batch_size", "8",
    "voxel_max", "80000", "synthetic_points", "60000", "synthetic_scenes",
    "32", "epochs", "2", "evaluate", "True", "print_freq", "1",
    "use_tensorboard", "False", "n_devices", "1"]
# the same loop with the batches built inline, for one epoch
LOOP_SYNC_OVERRIDES = ["prefetch", "False", "epochs", "1", "evaluate",
                       "False"]
# phase 12: ScanNet's host batches at the YAML's shape (max_batch_points
# 250000 -> n_pad 250112, batch_size 2): synthetic rooms of 200000 raw
# points in 4 m voxelized at 0.02 m (about 142000-144000 voxels) and
# cropped to voxel_max 120000, so ~240000 valid points per batch
SCANNET_ROOMS = dict(voxel_size=0.02, extent=4.0, points=200000,
                     voxel_max=120000, ignore_label=-100)
# (d): the training driver's loop on the ScanNet YAML, 2 steps of 2 rooms
# of 160000 raw points in 6 m (the synthetic set's room size; ~140000
# voxels, cropped to 120000), validation over 2 rooms of seed 10000
SCANNET_LOOP_OVERRIDES = [
    "data_name", "synthetic", "synthetic_points", "160000",
    "synthetic_scenes", "4", "epochs", "1", "evaluate", "True",
    "print_freq", "1", "use_tensorboard", "False", "n_devices", "1"]
# (e): test.py's ScanNet operating point (batch_size_test 5 x voxel_max
# 120000 = n_pad 600000) on one room of this many points in 5 m (seed 999):
# a 5 m room's crops keep the stem search's cell keys (0.05 m cells, 5
# slots) below DENSE_KEYS, a 6 m room's would not
SCANNET_SCENE = dict(points=200000, extent=5.0)
TPU_KERNELS = {
    "band_attention": "stratified_transformer_tpu/ops/pallas/"
                      "fused_attention.py:50",
    "sparse_band_attention": "stratified_transformer_tpu/ops/pallas/"
                             "fused_attention.py:253",
    "band_attention_bwd": "stratified_transformer_tpu/ops/pallas/"
                          "fused_attention_bwd.py:53",
    "sparse_band_attention_bwd": "stratified_transformer_tpu/ops/pallas/"
                                 "fused_attention_bwd.py:428",
    "bin_math_probe": "tools/bin_math_probe.py:54",
    "cache_key_probe": "tools/cache_key_probe.py:33",
}
FWD_KERNELS = ("band_attention", "sparse_band_attention")
BWD_KERNELS = ("band_attention_bwd", "sparse_band_attention_bwd")
PROBE_KERNELS = ("bin_math_probe", "cache_key_probe")


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` calls after one warm-up,
    from CUDA events."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def max_errors(got, want):
    """(max abs error, max rel error) over finite reference entries."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    rel = diff / want.abs().clamp_min(1e-12)
    return float(diff.max()), float(rel[want.abs() > 1e-3].max()
                                    if (want.abs() > 1e-3).any() else 0.0)


def assert_close(name, got, want, rtol, atol):
    bad = (got - want).abs() > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} entries outside "
            f"rtol {rtol} / atol {atol}; max abs err "
            f"{max_errors(got, want)[0]:.3e}")


def stage_levels(cfg, hb):
    """(xyz, offsets, is_down) of each level, from the host pyramid; a
    level without a transformer stage (the ScanNet family's stem level) has
    no member mask (None)."""
    pyr = hb["pyramid"]
    xyz, off = hb["xyz"], hb["offsets"]
    out = []
    for i in range(cfg.num_layers):
        out.append((xyz, off, pyr["stage_down"][i - cfg.layer_start][
            "is_down"] if i >= cfg.layer_start else None))
        if i < cfg.num_layers - 1:
            xyz, off = xyz[pyr["down"][i]["idx"]], pyr["down"][i]["offsets"]
    return out


def stages(cfg):
    """The transformer stages."""
    return range(cfg.layer_start, cfg.num_layers)


def attention_blocks(cfg):
    """Attention blocks of a forward: one launch of each forward kernel
    per block (12 for S3DIS, 18 for ScanNet, whose stage 0 has none)."""
    return sum(cfg.depths[cfg.layer_start:])


def build_plan(cfg, stage, level, shifted, device):
    from stratified_transformer_torch.ops import sampling
    from stratified_transformer_torch.ops.plan import build_attention_plan
    xyz, off, is_down = level
    n = len(xyz)
    toff = torch.from_numpy(np.asarray(off, np.int64)).to(device)
    d_pad = n // cfg.downsample_scale + cfg.num_scenes
    return build_attention_plan(
        torch.from_numpy(xyz).to(device),
        sampling.offsets_to_batch(toff, n), sampling.offsets_to_valid(toff, n),
        cfg.window_sizes()[stage], shifted=shifted,
        is_down=torch.from_numpy(is_down).to(device),
        sparse_cap=cfg.sparse_cap, aux_pad=((d_pad + 127) // 128) * 128)


def plan_fields(plan):
    yield from ((f, getattr(plan, f)) for f in plan._fields
                if f != "sparse_band")
    yield from (("sparse_band." + f, getattr(plan.sparse_band, f))
                for f in plan.sparse_band._fields)


def band_pairs(plan, band, tile):
    """Unmasked (query, key) pairs of the dense half for this plan."""
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
    """Unmasked (query, key) pairs of the far-key half for this plan, and
    the queries and aux keys that take part in at least one."""
    from stratified_transformer_torch.ops.attention import sparse_window
    sb = plan.sparse_band
    s, bases = sparse_window(sb, tile, s_band)
    n = sb.sb_start.shape[0]
    pos = bases[:, None] + torch.arange(s, device=bases.device)[None]
    rows = torch.arange(n, device=bases.device).view(-1, tile)
    mask = ((pos[:, None, :] >= sb.sb_start[rows][..., None].long())
            & (pos[:, None, :] < sb.sb_end[rows][..., None].long())
            & (sb.sb_skey[pos][:, None, :] != sb.q_skey_lw[rows][..., None])
            & sb.valid_lw[rows][..., None] & sb.sb_valid[pos][:, None, :])
    used = torch.zeros(sb.sb_valid.shape[0], dtype=torch.bool,
                       device=bases.device)
    used[pos[mask.any(1)]] = True
    return int(mask.sum()), int(mask.any(2).sum()), int(used.sum())


def log_pairs(label, cfg, hb, dev):
    """Logs the unmasked pairs of the dense and far-key halves per forward
    (all blocks of a stage) for the host batch ``hb``, stage by stage, with
    the plans a forward builds from it."""
    levels = stage_levels(cfg, hb)
    parts = []
    for i in stages(cfg):
        band = far = 0
        for shifted in (False, True):
            blocks = (cfg.depths[i] + (0 if shifted else 1)) // 2
            plan = build_plan(cfg, i, levels[i], shifted, dev)
            band += blocks * band_pairs(plan, cfg.stage_band(i), cfg.tile)
            far += blocks * sparse_pairs(plan, cfg.s_band, cfg.tile)[0]
        valid = int(levels[i][1][-1])
        parts.append(f"stage {i}: {valid} points, band {band}, sparse {far}")
    log(f"[pairs] {label}: " + "; ".join(parts))


def least_ops(pairs, n_q, n_k, h, d, nb):
    """Least fp32 operations of one attention call with cRPE tables on q, k
    and v over ``pairs`` unmasked pairs, ``n_q`` valid queries and ``n_k``
    valid keys, ``nb`` table rows per axis. Per pair and head: q·k (2d),
    p·v (2d) and the online-softmax update (~5). Per pair, shared by the
    heads: the three axes' bin arithmetic (~24). Per table and head, the
    cheaper of its per-pair form (three d-long dot products for Tq and Tk,
    three d-long adds for Tv) and the TPU kernel's form: each query (Tq),
    key (Tk) or row's bin mass (Tv) projected once onto all 3·nb table rows
    (2d each), then 3 lookups or mass adds per pair."""
    def table(per_pair, rows):
        return min(per_pair * pairs, 6 * nb * d * rows + 3 * pairs)
    per_head = ((4 * d + 5) * pairs + table(6 * d, n_q) + table(6 * d, n_k)
                + table(3 * d, n_q))
    return h * per_head + 24 * pairs


def least_ops_bwd(pairs, n_q, n_k, h, d, nb):
    """Least fp32 operations of one backward call (both table sets present)
    over ``pairs`` unmasked pairs, ``n_q`` valid queries, ``n_k`` valid
    keys, ``nb`` table rows per axis. Per pair and head: the recomputed q·k
    (2d), g·v (2d), r and dl (~5), dq += dl k, dk += dl q, dv += r g (2d
    each). Per query and head: g·o (2d). Per pair, shared by the heads: the
    bins (~24). Eight table terms, each at the cheaper of its per-pair form
    (three d-long dot products or axpys, 6d) and the projection form (3
    lookups or mass adds per pair, then 6·nb·d per query or key): the
    logit's Tq (queries) and Tk (keys), gv's Tv (queries), dq's Tq
    (queries), dk's Tk (keys) and the grads dTq (queries), dTk (keys) and
    dTv (queries)."""
    def table(rows):
        return min(6 * d * pairs, 6 * nb * d * rows + 3 * pairs)
    per_head = ((10 * d + 5) * pairs + 2 * d * n_q
                + 5 * table(n_q) + 3 * table(n_k))
    return h * per_head + 24 * pairs


def new_report(names):
    return {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "max_abs_err": 0.0, "bound_by": {}} for k in names}


def add_timing(report, name, blocks, ms, plain_ms, t_bytes, t_ops, err):
    """Adds one plan's launch to the kernel's per-step sums in ``report``
    (``blocks`` launches of the step use this plan); returns (bound,
    bound_by)."""
    bound = max(t_bytes / PEAK_BYTES, t_ops / PEAK_FP32) * 1e3
    by = ("bytes" if t_bytes / PEAK_BYTES >= t_ops / PEAK_FP32
          else "operations")
    r = report[name]
    r["ms"] += blocks * ms
    r["plain_ms"] += blocks * plain_ms
    r["bound_ms"] += blocks * bound
    r["bound_by"][by] = r["bound_by"].get(by, 0) + blocks * bound
    r["max_abs_err"] = max(r["max_abs_err"], err)
    return bound, by


def grads_close(name, got, want):
    """Backward-kernel tolerance (BWD_RTOL, BWD_FLOOR); returns the max abs
    error."""
    floor = BWD_FLOOR * float(want.abs().max())
    bad = (got - want).abs() > floor + BWD_RTOL * want.abs()
    err = float((got - want).abs().max())
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} entries outside "
            f"rtol {BWD_RTOL} / floor {floor:.3e}; max abs err {err:.3e}")
    return err


def check_grads(label, grads_k, grads_p):
    """Every parameter's gradient through the kernels within GRAD_REL_L2
    relative L2 (+ GRAD_FLOOR per entry) of the plain versions'; returns
    the largest relative L2 among the gradients above the floor."""
    worst = (0.0, "")
    for name, gp in grads_p.items():
        gk = grads_k[name]
        err = float((gk - gp).norm())
        bound = (GRAD_REL_L2 * float(gp.norm())
                 + GRAD_FLOOR * gp.numel() ** 0.5)
        if not err <= bound:
            raise AssertionError(f"{label} grad {name}: |kernel - plain| "
                                 f"{err:.3e} > {bound:.3e} (|plain| "
                                 f"{float(gp.norm()):.3e})")
        if float(gp.norm()) > 1e3 * GRAD_FLOOR * gp.numel() ** 0.5:
            worst = max(worst, (err / float(gp.norm()), name))
    return worst


def o1_weights(model, seed):
    """Replace every weight and statistic with random values from ``seed``
    that keep activations O(1) through the layers (fan_in^-0.5 matrices,
    0.05 cRPE tables, norm scales and BatchNorm statistics away from 1 and
    0), so that a wrong kernel term moves the logits well beyond the
    comparison's tolerance. Initial weights (0.02 matrices) leave logits of
    ~0.04 that attention moves by ~1e-4."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel_weights" or (leaf == "weight" and t.dim() == 2):
            fan_in = t.shape[1] if t.dim() == 2 else t.shape[0] * t.shape[1]
            w = torch.randn(t.shape, generator=gen) * fan_in ** -0.5
        elif leaf.endswith("_table"):
            w = torch.randn(t.shape, generator=gen) * 0.05
        elif leaf == "weight":
            w = 0.8 + 0.4 * torch.rand(t.shape, generator=gen)
        elif leaf in ("bias", "mean"):
            w = torch.randn(t.shape, generator=gen) * 0.1
        elif leaf == "var":
            w = 0.5 + torch.rand(t.shape, generator=gen)
        else:
            raise KeyError(name)
        state[name] = w.to(t.dtype)
    model.load_state_dict(state, strict=True)


def device_kernels(fn):
    """One profiled call of ``fn``: its wall time (ms, profiler on) and
    ``{name: (device ms, count)}`` of the device kernels and copies it
    ran."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        # device kernels and copies; a user annotation's range (AdamW's
        # step) overlaps the kernels it encloses
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    return wall_ms, by_name


def device_busy_ms(fn, reps):
    """Device time of ``fn()`` per call, summed over the device kernels and
    copies of ``reps`` profiled calls after one warm-up: unlike
    `cuda_time_ms`, it leaves out the device's idle gaps while the host
    dispatches."""
    fn()
    by_name = device_kernels(lambda: [fn() for _ in range(reps)])[1]
    return sum(ms for ms, _ in by_name.values()) / reps


def profile_call(label, fn):
    """One profiled call of ``fn``: device time by kernel and the device's
    busy share of the (profiled) wall time."""
    wall_ms, by_name = device_kernels(fn)
    rows = [(name, ms, count) for name, (ms, count) in by_name.items()]
    busy_ms = sum(r[1] for r in rows)
    log(f"[profile] {label} wall {wall_ms:.1f} ms (profiler on), device busy "
        f"{busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f}% ; "
        f"{sum(r[2] for r in rows)} device kernels")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"[profile]   {ms:8.3f} ms  x{count:<5d} {key[:90]}")
    return wall_ms, busy_ms, by_name


def probe_phase(dev, report):
    """Phase 9: the two probes through their entry points, then their
    kernels timed against the plain versions (and ``torch.mul`` for
    ``x * 2``). Fills ``report``; returns each probe kernel's launches by
    its entry point."""
    from stratified_transformer_torch.kernels import build, ptr, stream_of
    from stratified_transformer_torch.tools import bin_math_probe as bin_p
    from stratified_transformer_torch.tools import cache_key_probe as key_p
    for m_ in (bin_p, key_p):
        m_.KERNEL.launches = 0
    counts = bin_p.probe(dev)
    log(f"[probe] bin_math_probe: {json.dumps(counts)}")
    if counts["kernel_vs_cpu"] or counts["values"] != 65536:
        raise AssertionError("bin-math kernel differs from its plain version "
                             f"on the CPU on {counts['kernel_vs_cpu']} values")
    y = key_p.times_two(torch.ones(128, 128, device=dev))
    if float(y.sum()) != 32768.0:
        raise AssertionError(f"times_two sum {float(y.sum())}")
    launched = {"bin_math_probe": bin_p.KERNEL.launches,
                "cache_key_probe": key_p.KERNEL.launches}
    runs = []
    for _ in range(2):
        out = subprocess.run(
            [sys.executable, "-m",
             "stratified_transformer_torch.tools.cache_key_probe"],
            cwd=REPO, timeout=120, capture_output=True, text=True)
        if out.returncode != 0:
            raise AssertionError(f"cache_key_probe failed:\n{out.stderr}")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    keys = [{n: r["key"] for n, r in run["sources"].items()} for run in runs]
    here = {n: build.cache_key(build.key_components(n))
            for n in build.sources()}
    built = [n for run in runs for n, r in run["sources"].items()
             if r["built_by"] != "reused"]
    if keys[0] != keys[1] or keys[0] != here or built or any(
            run["sum"] != 32768.0 for run in runs):
        raise AssertionError(f"cache_key_probe: keys {keys} vs {here}, "
                             f"rebuilt {built}, sums "
                             f"{[run['sum'] for run in runs]}")
    nvcc = build.nvcc_version().strip().splitlines()[-1]
    log(f"[probe] cache_key_probe: two fresh processes, identical keys for "
        f"all {len(here)} sources ({json.dumps(keys[0])}), every library "
        f"reused, sum 32768; {nvcc}")

    # timing: the bare launches, the plain versions, the library call
    x = torch.from_numpy(bin_p.sweep()).to(dev)
    bins = torch.empty(x.shape, dtype=torch.int32, device=dev)
    two_ws, qs = float(np.float32(2 * bin_p.WS)), float(np.float32(bin_p.QS))
    xr = torch.randn(128, 128,
                     generator=torch.Generator().manual_seed(0)).to(dev)
    doubled = torch.empty_like(xr)
    cases = {
        "bin_math_probe": (
            lambda: bin_p.KERNEL(ptr(x), ptr(bins), x.numel(), two_ws, qs,
                                 stream_of(dev)),
            lambda: bin_p.bin_formula_plain(x, bin_p.WS, bin_p.QS), None,
            x.numel() * 8,
            lambda: float((bin_p.bin_formula(x, bin_p.WS, bin_p.QS).cpu()
                           - bin_p.bin_formula_plain(x.cpu(), bin_p.WS,
                                                     bin_p.QS)).abs().max())),
        "cache_key_probe": (
            lambda: key_p.KERNEL(ptr(xr), ptr(doubled), xr.numel(),
                                 stream_of(dev)),
            lambda: key_p.times_two_plain(xr), lambda: torch.mul(xr, 2),
            xr.numel() * 8,
            lambda: float((key_p.times_two(xr) - key_p.times_two_plain(
                xr)).abs().max())),
    }
    for name, (kern, plain_fn, lib_fn, n_bytes, err_fn) in cases.items():
        r = report[name]
        r["max_abs_err"] = err_fn()
        r["ms"] = cuda_time_ms(kern, 200)
        r["plain_ms"] = cuda_time_ms(plain_fn, 200)
        r["library_ms"] = None if lib_fn is None else cuda_time_ms(lib_fn,
                                                                   200)
        r["bound_ms"] = n_bytes / PEAK_BYTES * 1e3
        r["bound_by"] = {"bytes": r["bound_ms"]}
        log(f"[probe] {name}: {r['ms'] * 1e3:.2f} us per launch (plain "
            f"{r['plain_ms'] * 1e3:.2f} us, library "
            + ("none" if lib_fn is None else f"{r['library_ms'] * 1e3:.2f} us")
            + f", bound {r['bound_ms'] * 1e3:.3f} us by bytes); max abs err "
            f"{r['max_abs_err']}")
    log("[probe] library_ms: null for bin_math_probe — no single PyTorch call "
        "computes the bin formula (round, divide, add, divide, floor); "
        "torch.mul(x, 2) for cache_key_probe")
    return launched


def fwd_bytes(name, inputs, outs, sb):
    """Bytes a forward call must move: what its kernel reads (``inputs``
    of ``launch_args``: q, k, v, the plan's fields, the tables or their
    band slices) once and the triple written once; the far-key half needs
    k and v only at its A aux slots' points, not at all N."""
    total = nbytes(inputs + outs)
    if name == "sparse_band_attention":
        k, v = inputs[1], inputs[2]
        total += (sb.sb_src.shape[0] - k.shape[0]) * (
            nbytes([k]) + nbytes([v])) // k.shape[0]
    return total


def fwd_phase(cfg, levels, plans, dev, report):
    """Phase 4: both forward kernels against their plain versions at every
    stage's plans, with random q/k/v and tables from seed 0. Adds each
    kernel's per-step times, bounds and errors to ``report``, and the public
    wrapper's device-busy time under ``wrapper_busy_ms``; returns one row
    per (kernel, stage, parity)."""
    from stratified_transformer_torch.kernels import band_attention as band_k
    from stratified_transformer_torch.kernels import (
        sparse_band_attention as sparse_k)
    from stratified_transformer_torch.ops import attention as plain
    gen = torch.Generator(device="cpu").manual_seed(0)
    for name in FWD_KERNELS:
        report[name]["wrapper_busy_ms"] = 0.0
    rows_out = []
    for i in stages(cfg):
        h, d = cfg.num_heads[i], cfg.channels[i] // cfg.num_heads[i]
        ws, qs = cfg.window_sizes()[i], cfg.quant_sizes()[i]
        nbf = 2 * int((2 * ws + 1e-4) // qs)
        band = cfg.stage_band(i)
        n = len(levels[i][0])
        q, k, v = (torch.randn(n, h, d, generator=gen).to(dev)
                   for _ in range(3))
        tables = tuple((torch.randn(nbf, h, d, 3, generator=gen) * 0.05
                        ).to(dev) for _ in range(3))
        kw = dict(window_size=ws, quant_size=qs, scale=d ** -0.5)
        for shifted in (False, True):
            blocks = (cfg.depths[i] + (0 if shifted else 1)) // 2
            plan = plans[i, shifted]
            pargs = (q, k, v, plan.xyz_sorted, plan.seg_start, plan.seg_end,
                     plan.valid_sorted) + tables
            sb = plan.sparse_band
            bkw = dict(kw, band=band, tile=cfg.tile)
            skw = dict(kw, s_band=cfg.s_band, tile=cfg.tile)
            n_q = int(plan.valid_sorted.sum())
            s_pairs, s_q, s_k = sparse_pairs(plan, cfg.s_band, cfg.tile)
            nb = plain.band_table_slice(nbf)[1]
            with torch.no_grad():
                # name: (module, launch_args for timing, public wrapper,
                #        plain version, pairs, queries and keys in a pair,
                #        table rows per axis); every valid point is its
                #        own band key
                runs = {
                    "band_attention": (
                        band_k, band_k.launch_args(*pargs, **bkw),
                        lambda: band_k.band_attention(*pargs, **bkw),
                        lambda: plain.band_attention_plain(*pargs, **bkw),
                        band_pairs(plan, band, cfg.tile), n_q, n_q, nb),
                    "sparse_band_attention": (
                        sparse_k, sparse_k.launch_args(
                            q, k, v, sb, *tables, **skw),
                        lambda: sparse_k.sparse_band_attention(
                            q, k, v, sb, *tables, **skw),
                        lambda: plain.sparse_band_attention_plain(
                            q, k, v, sb, *tables, **skw),
                        s_pairs, s_q, s_k, nbf),
                }
                triples = {}
                for name, (mod, (args, outs, inputs), wrapper, plain_fn,
                           pairs, nq, nk, rows) in runs.items():
                    got = wrapper()
                    want = plain_fn()
                    torch.cuda.synchronize()
                    triples[name] = (got, want)
                    errs = []
                    for tn, g, w in zip(("acc", "m", "den"), got, want):
                        assert_close(f"{name} stage {i} shifted={shifted} "
                                     f"{tn}", g, w, RTOL, ATOL)
                        errs.append(max_errors(g, w))
                    ms = cuda_time_ms(lambda: mod.KERNEL(*args), 20)
                    busy_ms = device_busy_ms(wrapper, 3)
                    report[name]["wrapper_busy_ms"] += blocks * busy_ms
                    plain_ms = cuda_time_ms(plain_fn, 3)
                    t_ops = least_ops(pairs, nq, nk, h, d, rows)
                    bound, by = add_timing(report, name, blocks, ms,
                                           plain_ms,
                                           fwd_bytes(name, inputs, outs, sb),
                                           t_ops, max(e[0] for e in errs))
                    rows_out.append({
                        "kernel": name, "stage": i, "shifted": int(shifted),
                        "blocks": blocks, "n": n, "h": h, "pairs": pairs,
                        "ops_per_pair_head": t_ops / max(pairs, 1) / h,
                        "ms": ms, "wrapper_busy_ms": busy_ms,
                        "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": by})
                    log(f"[kernel] {name} stage {i} shifted={int(shifted)} "
                        f"N={n} h={h} d={d} pairs={pairs} "
                        f"ops/pair/head={t_ops / max(pairs, 1) / h:.1f}: "
                        f"{ms:.4f} ms (wrapper device busy {busy_ms:.4f} ms; "
                        f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms by "
                        f"{by}); max abs/rel err acc {errs[0][0]:.2e}/"
                        f"{errs[0][1]:.2e} m {errs[1][0]:.2e}/{errs[1][1]:.2e}"
                        f" den {errs[2][0]:.2e}/{errs[2][1]:.2e}")
                out_k = plain.merge([triples[n_][0] for n_ in FWD_KERNELS])[0]
                out_p = plain.merge([triples[n_][1] for n_ in FWD_KERNELS])[0]
                assert_close(f"merged stage {i}", out_k, out_p, RTOL, ATOL)
                e = max_errors(out_k, out_p)
                log(f"[kernel] merged output stage {i} shifted={int(shifted)}"
                    f": max abs/rel err {e[0]:.2e}/{e[1]:.2e}")
    log("[kernel] library_ms: null for both kernels — no single PyTorch call "
        "computes attention with per-pair cRPE table terms on q, k and v "
        "(scaled_dot_product_attention takes one additive bias and no value "
        "term)")
    for name in FWD_KERNELS:
        r = report[name]
        log(f"[kernel] {name}: {r['ms']:.3f} ms per eval forward (wrapper "
            f"device busy {r['wrapper_busy_ms']:.3f} ms; bound "
            f"{r['bound_ms']:.3f} ms)")
    return rows_out


def bwd_phase(cfg, levels, plans, dev, report):
    """Phase 7: both backward kernels against their plain versions at every
    stage's plans, with random q/k/v/g and tables from seed 0 and the merged
    forward residuals of the plain versions. Adds each kernel's per-step
    times, bounds and errors to ``report``, and the public wrapper's time
    under ``wrapper_ms``."""
    from stratified_transformer_torch.kernels import (
        band_attention_bwd as band_bwd_k)
    from stratified_transformer_torch.kernels import (
        sparse_band_attention_bwd as sparse_bwd_k)
    from stratified_transformer_torch.ops import attention as plain
    gen = torch.Generator(device="cpu").manual_seed(0)
    grad_names = ("dq", "dk", "dv", "dtq", "dtk", "dtv")
    for name in BWD_KERNELS:
        report[name]["wrapper_ms"] = report[name]["wrapper_busy_ms"] = 0.0
    for i in stages(cfg):
        h, d = cfg.num_heads[i], cfg.channels[i] // cfg.num_heads[i]
        ws, qs = cfg.window_sizes()[i], cfg.quant_sizes()[i]
        nbf = 2 * int((2 * ws + 1e-4) // qs)
        band = cfg.stage_band(i)
        n = len(levels[i][0])
        q, k, v, g = (torch.randn(n, h, d, generator=gen).to(dev)
                      for _ in range(4))
        tables = tuple((torch.randn(nbf, h, d, 3, generator=gen) * 0.05
                        ).to(dev) for _ in range(3))
        kw = dict(window_size=ws, quant_size=qs, scale=d ** -0.5)
        for shifted in (False, True):
            blocks = (cfg.depths[i] + (0 if shifted else 1)) // 2
            plan = plans[i, shifted]
            geom = (plan.xyz_sorted, plan.seg_start, plan.seg_end,
                    plan.valid_sorted)
            sb = plan.sparse_band
            bkw = dict(kw, band=band, tile=cfg.tile)
            skw = dict(kw, s_band=cfg.s_band, tile=cfg.tile)
            with torch.no_grad():
                # the merged forward's residuals, as the autograd Function
                # saves them
                out, m, den = plain.merge([
                    plain.band_attention_plain(q, k, v, *geom, *tables,
                                               **bkw),
                    plain.sparse_band_attention_plain(q, k, v, sb, *tables,
                                                      **skw)])
                res = (g, out, m, den)
                n_q = int(plan.valid_sorted.sum())
                s_pairs, s_q, s_k = sparse_pairs(plan, cfg.s_band, cfg.tile)
                nb = plain.band_table_slice(nbf)[1]
                runs = {
                    "band_attention_bwd": (
                        band_bwd_k, band_bwd_k.launch_args(
                            q, k, v, *geom, *res, *tables, **bkw),
                        lambda: band_bwd_k.band_attention_bwd(
                            q, k, v, *geom, *res, *tables, **bkw),
                        lambda: plain.band_attention_bwd_plain(
                            q, k, v, *geom, *res, *tables, **bkw),
                        band_pairs(plan, band, cfg.tile), n_q, n_q, nb),
                    "sparse_band_attention_bwd": (
                        sparse_bwd_k, sparse_bwd_k.launch_args(
                            q, k, v, sb, *res, *tables, **skw),
                        lambda: sparse_bwd_k.sparse_band_attention_bwd(
                            q, k, v, sb, *res, *tables, **skw),
                        lambda: plain.sparse_band_attention_bwd_plain(
                            q, k, v, sb, *res, *tables, **skw),
                        s_pairs, s_q, s_k, nbf),
                }
                for name, (mod, (args, outs, inputs), wrapper, plain_fn,
                           pairs, nq, nk, rows) in runs.items():
                    got = wrapper()
                    want = plain_fn()
                    torch.cuda.synchronize()
                    errs = [grads_close(f"{name} stage {i} shifted="
                                        f"{int(shifted)} {gn}", a, b)
                            for gn, a, b in zip(grad_names, got, want)]
                    ms = cuda_time_ms(lambda: mod.KERNEL(*args), 10)
                    wrapper_ms = cuda_time_ms(wrapper, 10)
                    busy_ms = device_busy_ms(wrapper, 3)
                    report[name]["wrapper_ms"] += blocks * wrapper_ms
                    report[name]["wrapper_busy_ms"] += blocks * busy_ms
                    plain_ms = cuda_time_ms(plain_fn, 2)
                    # the function's bytes: its inputs (as the kernel takes
                    # them) read once, the six grads written once
                    t_ops = least_ops_bwd(pairs, nq, nk, h, d, rows)
                    bound, by = add_timing(report, name, blocks, ms,
                                           plain_ms,
                                           nbytes(inputs + tuple(got)),
                                           t_ops, max(errs))
                    log(f"[bwd] {name} stage {i} shifted={int(shifted)} "
                        f"N={n} h={h} d={d} pairs={pairs} "
                        f"ops/pair/head={t_ops / pairs / h:.1f}: {ms:.4f} ms "
                        f"(wrapper {wrapper_ms:.4f} ms, device busy "
                        f"{busy_ms:.4f} ms; plain {plain_ms:.3f} ms, bound "
                        f"{bound:.4f} ms by {by}); dk/dv partials "
                        f"{nbytes(outs[1:3]) / 2 ** 20:.0f} MiB; max abs err "
                        + " ".join(f"{gn} {e:.2e}"
                                   for gn, e in zip(grad_names, errs))
                        + " (of max |grad| "
                        + " ".join(f"{float(w.abs().max()):.2e}"
                                   for w in want) + ")")
    log("[bwd] library_ms: null for both backward kernels — no single "
        "PyTorch call computes the gradients of attention with per-pair cRPE "
        "table terms on q, k and v")
    for name in BWD_KERNELS:
        r = report[name]
        log(f"[bwd] {name}: {r['ms']:.3f} ms per train step (wrapper "
            f"{r['wrapper_ms']:.3f} ms, of which the device is busy "
            f"{r['wrapper_busy_ms']:.3f} ms; bound {r['bound_ms']:.3f} ms)")


def tree_leaves(prefix, x):
    """``(path, tensor)`` of every leaf of nested dicts, tuples and lists."""
    if isinstance(x, dict):
        for k in sorted(x):
            yield from tree_leaves(f"{prefix}.{k}", x[k])
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from tree_leaves(f"{prefix}[{i}]", v)
    else:
        yield prefix, x


def assert_same_leaves(label, got, want):
    """Every leaf of ``got`` (on the card) equal to ``want``'s (on the CPU),
    dtype and bits; returns the number of leaves."""
    pairs = list(zip(tree_leaves(label, got), tree_leaves(label, want)))
    for (name, a), (_, b) in pairs:
        if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
            bad = int((a.cpu() != b).sum()) if a.shape == b.shape else -1
            raise AssertionError(f"{name} differs between the card and the "
                                 f"CPU ({bad} entries)")
    return len(pairs)


def geometry_check(cfg, hb, dev, names=None):
    """Phase 10 (a), 12 (e): at the host batch ``hb``, the stem radius
    neighbours and geometry pyramid the forward computes when it gets none,
    and FPS and blocked FPS at stage 0 (``names``: a subset, default all
    four), bit-identical between the card and the CPU. Returns the card's
    seconds per function."""
    from stratified_transformer_torch.models.stratified import (
        geometry_pyramid, stem_neighbors)
    from stratified_transformer_torch.ops import sampling
    xyz = torch.from_numpy(hb["xyz"])
    off = torch.from_numpy(np.asarray(hb["offsets"], np.int64))
    n, scale = len(xyz), cfg.downsample_scale
    d_off = sampling.counts_to_offsets(sampling.floor_ratio_counts(
        off - sampling.scene_starts(off), 1.0 / scale))
    d_pad = n // scale + cfg.num_scenes
    cases = {
        "stem_neighbors": lambda x, o, d: stem_neighbors(cfg, x, o),
        "geometry_pyramid": lambda x, o, d: geometry_pyramid(cfg, x, o),
        "farthest_point_sampling": lambda x, o, d: (
            sampling.farthest_point_sampling(x, o, d, d_pad)),
        "blocked_fps": lambda x, o, d: sampling.blocked_fps(
            x, o, d, d_pad, cfg.window_sizes()[0] * 4.0),
    }
    secs = {}
    for name in names or cases:
        fn = cases[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(xyz.to(dev), off.to(dev), d_off.to(dev))
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = fn(xyz, off, d_off)
        cpu_s = time.perf_counter() - t0
        leaves = assert_same_leaves(name, got, want)
        log(f"[scene] {name}: {leaves} tensors bit-identical between the "
            f"card and the CPU (N={n}, {cfg.num_scenes} scenes; card "
            f"{secs[name]:.3f} s, CPU {cpu_s:.3f} s, first call)")
    return secs


def nopyramid_check(model, ref_model, hb, dev, counts, reset):
    """Phase 10 (b): one forward of the batch ``hb`` without stem neighbours
    or pyramid through the kernels (one launch of each forward kernel per
    block, 12 + 12 at full depth; no backward), logits within LOGIT_RTOL /
    LOGIT_ATOL of the plain-version forward's."""
    feats, xyz, off = (torch.from_numpy(np.asarray(hb[k])).to(dev)
                       for k in ("feats", "xyz", "offsets"))
    off = off.long()
    with torch.no_grad():
        reset()
        logits = model(feats, xyz, off)[0]
        torch.cuda.synchronize()
        launches = counts()
        ref_logits = ref_model(feats, xyz, off)[0]
    blocks = attention_blocks(model.cfg)
    want = {"band_attention": blocks, "sparse_band_attention": blocks,
            "band_attention_bwd": 0, "sparse_band_attention_bwd": 0}
    if launches != want:
        raise AssertionError(f"no-pyramid forward launches {launches}, "
                             f"expected {want}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits without a pyramid")
    assert_close("no-pyramid logits", logits, ref_logits, LOGIT_RTOL,
                 LOGIT_ATOL)
    e = max_errors(logits, ref_logits)
    log(f"[scene] no-pyramid full-width forward (N={len(xyz)}): launches "
        f"{launches}; logits vs plain-version forward max abs/rel err "
        f"{e[0]:.2e}/{e[1]:.2e}")
    return e[0]


def stem_key_bound(cfg, xyz, offsets):
    """The largest cell key the stem's radius search (``ops/neighbors.py::
    grid_knn`` with 2.5 grid cells) can form on a batch: slots x the cells
    of the batch's bounding box, less one. A key at or beyond
    ``DENSE_KEYS`` finds no row of the dense key map, silently, in the JAX
    package and the port alike."""
    from stratified_transformer_torch.ops import hashing, sampling
    n = xyz.shape[0]
    valid = sampling.offsets_to_valid(offsets, n)
    x = xyz[valid]
    # cells are monotonic in the coordinate: the largest is the maximum's
    hi = hashing.window_cells(x.max(0).values[None],
                              2.5 * cfg.grid_size * cfg.sigma,
                              start=x.min(0).values)[0] + 1
    slots = int(sampling.offsets_to_batch(offsets, n)[valid].max()) + 1
    return slots * int(hi.long().prod()) - 1


def scene_protocol(model, ref_model, dev, counts, reset, yaml_path=CONFIG,
                   room=None):
    """Phase 10 (c), 12 (e): `evaluate_scene` over one synthetic scene
    (``room``: SyntheticRooms' ``points`` and ``extent``, default
    SCENE_POINTS in 6 m), kernels on the card, at the whole-scene operating
    point of the YAML ``yaml_path``, as the eval driver passes its
    ``data_name`` (ScanNet's: 5 TTA passes, colours in [-1, 1], here the
    room's mapped so); the stem search's largest cell key of every forward
    held below ``DENSE_KEYS``; then the first TTA pass against the
    plain-version path, and one profiled forward. Returns the phase's
    numbers."""
    from stratified_transformer_torch.data.datasets import SyntheticRooms
    from stratified_transformer_torch.eval import voting
    from stratified_transformer_torch.eval.driver import (
        eval_config, make_predict_probs)
    from stratified_transformer_torch.models.stratified import (
        geometry_pyramid, stem_neighbors)
    from stratified_transformer_torch.ops.neighbors import DENSE_KEYS
    from stratified_transformer_torch.utils.config import load_cfg
    yaml_cfg = load_cfg(yaml_path)
    cfg = eval_config(yaml_cfg)
    data_name = yaml_cfg["data_name"]
    coord, feat, _ = SyntheticRooms(num_scenes=1, seed=999, **(
        room or {"points": SCENE_POINTS})).raw_scene(0)
    if data_name == "scannetv2":
        feat = feat / np.float32(127.5) - np.float32(1.0)
    n_scene = len(coord)        # the generator rounds its boxes' share down
    passes = len(voting.tta_transforms(data_name))
    kw = dict(data_name=data_name, voxel_size=float(yaml_cfg["voxel_size"]),
              voxel_max=int(yaml_cfg["voxel_max"]),
              batch_size_test=cfg.num_scenes, n_pad=cfg.n_pad,
              num_scenes=cfg.num_scenes, concat_xyz=cfg.concat_xyz)
    predict = make_predict_probs(model)
    fwd_s, fwd_points, first, keys = [], [], [], []

    def timed(feats, xyz, offsets):
        if not first:
            first.append((feats, xyz, offsets))
        keys.append(stem_key_bound(cfg, torch.from_numpy(xyz),
                                   torch.from_numpy(offsets).long()))
        t0 = time.perf_counter()
        probs = predict(feats, xyz, offsets)        # synchronizes (.cpu())
        fwd_s.append(time.perf_counter() - t0)
        fwd_points.append(int(offsets[-1]))
        return probs

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    _, probs_all = voting.evaluate_scene(timed, coord, feat, cfg.num_classes,
                                         **kw)
    scene_s = time.perf_counter() - t0
    launches = counts()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    forwards = len(fwd_s)
    blocks = attention_blocks(cfg)
    want = {"band_attention": blocks * forwards,
            "sparse_band_attention": blocks * forwards,
            "band_attention_bwd": 0, "sparse_band_attention_bwd": 0}
    if launches != want:
        raise AssertionError(f"whole-scene launches {launches}, expected "
                             f"{want} over {forwards} forwards")
    if not (np.isfinite(probs_all).all() and probs_all.shape
            == (n_scene, cfg.num_classes)):
        raise AssertionError("whole-scene probabilities not finite or of "
                             f"shape {probs_all.shape}")
    out = {
        "points": n_scene, "n_pad": cfg.n_pad,
        "crops_per_forward": cfg.num_scenes, "seconds": scene_s,
        "forwards": forwards, "scene_points_per_s": n_scene / scene_s,
        "model_points_per_s": sum(fwd_points) / sum(fwd_s),
        "forward_s_median": float(np.median(fwd_s)),
        "forward_s_total": sum(fwd_s), "host_s": scene_s - sum(fwd_s),
        "valid_points_per_forward_mean": float(np.mean(fwd_points)),
        "launches": launches, "max_memory_allocated_mib": peak_mib,
        "stem_key_max": max(keys), "dense_keys": DENSE_KEYS}
    log(f"[scene] stem search: largest cell key of any forward {max(keys)} "
        f"of DENSE_KEYS {DENSE_KEYS} ({100 * max(keys) / DENSE_KEYS:.1f}%)")
    if max(keys) >= DENSE_KEYS:
        raise AssertionError(f"stem cell keys up to {max(keys)} reach "
                             f"DENSE_KEYS {DENSE_KEYS}: neighbours are lost")
    log(f"[scene] protocol: {n_scene} points, {passes} TTA passes, "
        f"{forwards} forwards of n_pad {cfg.n_pad} in {cfg.num_scenes} crops "
        f"({out['valid_points_per_forward_mean']:.0f} valid points on "
        f"average) in {scene_s:.1f} s: {out['scene_points_per_s']:.0f} scene "
        f"points/s, {out['model_points_per_s']:.0f} model points/s; "
        f"forwards {sum(fwd_s):.1f} s (median {out['forward_s_median']:.3f} "
        f"s), host protocol {out['host_s']:.1f} s; launches {launches}; "
        f"max_memory_allocated {peak_mib:.0f} MiB")

    # the first TTA pass through the kernels and the plain versions
    one = dict(kw, transforms=[None])
    pred_k, prob_k = voting.evaluate_scene(predict, coord, feat,
                                           cfg.num_classes, **one)
    pred_p, prob_p = voting.evaluate_scene(make_predict_probs(ref_model),
                                           coord, feat, cfg.num_classes,
                                           **one)
    err = float(np.abs(prob_k - prob_p).max())
    top2 = np.sort(prob_p, -1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > SCENE_MARGIN
    differ = int((pred_k != pred_p)[clear].sum())
    out.update(first_pass_max_abs_err=err,
               first_pass_labels_differ=int((pred_k != pred_p).sum()),
               first_pass_labels_differ_beyond_margin=differ)
    log(f"[scene] first TTA pass, kernels vs plain versions: accumulated "
        f"probabilities max abs err {err:.2e}; labels differ at "
        f"{out['first_pass_labels_differ']} of {n_scene} points, "
        f"{differ} of them with a top-two margin above {SCENE_MARGIN}")
    if err > SCENE_PROB_ATOL or differ:
        raise AssertionError("first TTA pass: kernels and plain versions "
                             f"disagree (max abs err {err:.2e}, {differ} "
                             "clear labels)")

    # one 400000-point forward: memory, and where its device time goes
    feats, xyz, offsets = first[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    predict(feats, xyz, offsets)
    out["forward_max_memory_allocated_mib"] = (
        torch.cuda.max_memory_allocated() / 2 ** 20)
    wall, busy, by_name = profile_call(
        f"whole-scene forward (n_pad {cfg.n_pad}, {int(offsets[-1])} valid "
        f"points in {cfg.num_scenes} crops)",
        lambda: predict(feats, xyz, offsets))
    x, o = torch.from_numpy(xyz).to(dev), torch.from_numpy(offsets).to(
        dev, torch.int64)
    with torch.inference_mode():
        parts = {"stem_neighbors": lambda: stem_neighbors(cfg, x, o),
                 "geometry_pyramid": lambda: geometry_pyramid(cfg, x, o)}
        busy_of = {k: sum(ms for ms, _ in device_kernels(f)[1].values())
                   for k, f in parts.items()}
    if busy <= 0:
        raise AssertionError("the profiled forward ran nothing on the card")
    # device ms of each forward kernel in the profiled forward (the far-key
    # kernel's name contains the band kernel's)
    kernel_ms = {k: 0.0 for k in FWD_KERNELS}
    for name, (ms, _) in by_name.items():
        if "band_attention" in name:
            kernel_ms["sparse_band_attention" if "sparse_band_attention"
                      in name else "band_attention"] += ms
    attn = sum(kernel_ms.values())
    pyr = sum(busy_of.values())
    out.update(profiled_wall_ms=wall, profiled_busy_ms=busy,
               attention_kernels_ms=attn, kernel_ms_per_forward=kernel_ms,
               on_device_pyramid_ms=pyr,
               stem_neighbors_ms=busy_of["stem_neighbors"])
    log(f"[scene] profiled forward: device busy {busy:.1f} ms of a "
        f"{wall:.1f} ms wall; on-device pyramid {pyr:.1f} ms "
        f"({100 * pyr / busy:.1f}%; stem radius neighbours "
        f"{busy_of['stem_neighbors']:.1f} ms, the rest "
        f"{busy_of['geometry_pyramid']:.1f} ms, each profiled alone), "
        f"attention kernels {attn:.1f} ms ({100 * attn / busy:.1f}%: "
        f"{json.dumps(kernel_ms)}), the rest {busy - pyr - attn:.1f} ms; "
        f"forward peak memory "
        f"{out['forward_max_memory_allocated_mib']:.0f} MiB")
    return out


def scene_phase(cfg, hb, model, ref_model, dev, kernel_mods,
                yaml_path=CONFIG, room=None, geometry=None):
    """Phase 10: (a) `geometry_check` (of the functions ``geometry``), (b)
    `nopyramid_check` with the phase-5 models, (c) `scene_protocol` with
    their weights in the whole-scene configuration of ``yaml_path`` on
    ``room``. Phase 12 (e) runs it on ScanNet's. Returns the numbers of (c)
    with the seconds of (a) and the error of (b)."""
    from stratified_transformer_torch.eval.driver import eval_config
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.utils.config import load_cfg

    def counts():
        return {k: m_.KERNEL.launches for k, m_ in kernel_mods.items()}

    def reset():
        for m_ in kernel_mods.values():
            m_.KERNEL.launches = 0

    geo_s = geometry_check(cfg, hb, dev, geometry)
    err = nopyramid_check(model, ref_model, hb, dev, counts, reset)
    scfg = eval_config(load_cfg(yaml_path))
    scene_models = []
    for impl, src in (("fused", model), ("reference", ref_model)):
        m_ = build_model(dataclasses.replace(scfg, attn_impl=impl), "cuda")
        m_.load_state_dict(src.state_dict())
        scene_models.append(m_)
    out = scene_protocol(*scene_models, dev, counts, reset, yaml_path, room)
    out.update(geometry_card_s=geo_s, nopyramid_logits_max_abs_err=err)
    return out


def train_phase(tag, cfg, yaml_cfg, init_state, batches, kernel_mods):
    """Phases 8 and 12 (c): training steps over ``batches`` from the
    weights ``init_state``, AdamW with the YAML's groups, weight decay and
    schedule, drop-path from a generator seeded per step, the YAML's ignore
    label. One step of a throwaway copy first; then the steps through the
    kernels (one launch of each of the four per attention block and step),
    and through the plain versions: every step-1 gradient within
    GRAD_REL_L2 / GRAD_FLOOR, the loss trajectories within LOSS_RTOL; one
    profiled step. Logs with ``tag``; returns the numbers."""
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.train import schedulers
    from stratified_transformer_torch.train.state import make_optimizer
    from stratified_transformer_torch.train.step import make_train_step
    schedule = schedulers.from_config(yaml_cfg, TRAIN_ITERS_PER_EPOCH)[0]
    train_step = make_train_step(int(yaml_cfg["ignore_label"]),
                                 cfg.num_classes)
    blocks = attention_blocks(cfg)

    def counts():
        return {k: m_.KERNEL.launches for k, m_ in kernel_mods.items()}

    def trainer(impl):
        m_ = build_model(dataclasses.replace(cfg, attn_impl=impl), "cuda",
                         seed=0, train=True)
        m_.load_state_dict(init_state)
        opt = make_optimizer(
            m_, schedule, weight_decay=float(yaml_cfg["weight_decay"]),
            transformer_lr_scale=float(yaml_cfg["transformer_lr_scale"]))
        return m_, opt

    def run_steps(m_, opt, via_kernels):
        losses, times, grads = [], [], None
        for step, b in enumerate(batches):
            gen_s = torch.Generator(device="cuda").manual_seed(1000 + step)
            before = counts()
            t0 = time.perf_counter()
            stats = train_step(m_, opt, b, gen_s)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            per_step = {k_: counts()[k_] - before[k_] for k_ in before}
            want_n = blocks if via_kernels else 0
            if any(c != want_n for c in per_step.values()):
                raise AssertionError(f"kernel launches in train step {step}: "
                                     f"{per_step}, expected {want_n} each")
            if not bool(torch.isfinite(stats["loss"])):
                raise AssertionError(f"non-finite loss at train step {step}")
            losses.append(float(stats["loss"]))
            if step == 0:
                grads = {n_: p_.grad.clone()
                         for n_, p_ in m_.named_parameters()}
        return losses, times, grads

    # one step of a throwaway copy pays the backward's one-time set-up
    # (cuBLAS, autograd, AdamW state) outside the timed steps
    model_w, opt_w = trainer("fused")
    train_step(model_w, opt_w, batches[0],
               torch.Generator(device="cuda").manual_seed(999))
    torch.cuda.synchronize()
    del model_w, opt_w
    model_k, opt_k = trainer("fused")
    for m_ in kernel_mods.values():
        m_.KERNEL.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses_k, times_k, grads_k = run_steps(model_k, opt_k, True)
    launches = counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for step in range(len(batches)):
        log(f"{tag} step {step}: loss {losses_k[step]:.5f}, "
            f"{times_k[step]:.1f} ms (host clock, synchronized)")
    log(f"{tag} launches over {len(batches)} steps: {launches}; "
        f"max_memory_allocated {peak_mb:.0f} MiB")

    model_p, opt_p = trainer("reference")
    losses_p, times_p, grads_p = run_steps(model_p, opt_p, False)
    worst = check_grads("train step 1", grads_k, grads_p)
    log(f"{tag} step-1 grads of all {len(grads_p)} parameters within "
        f"{GRAD_REL_L2} relative L2 (+{GRAD_FLOOR}/entry) of the plain-version"
        f" step; largest relative L2 {worst[0]:.2e} ({worst[1]})")
    np.testing.assert_allclose(losses_k, losses_p, rtol=LOSS_RTOL,
                               err_msg="loss trajectory")
    log(f"{tag} loss trajectory kernels {losses_k} vs plain {losses_p}; "
        f"plain-version step median {float(np.median(times_p)):.1f} ms")
    step_ms = float(np.median(times_k))
    log(f"{tag} full-width train step median {step_ms:.1f} ms over "
        f"{len(batches)} steps")
    del model_p, opt_p, grads_p, grads_k
    wall, busy, by_name = profile_call(f"{tag[1:-1]} step", lambda: (
        train_step(model_k, opt_k, batches[0],
                   torch.Generator(device="cuda").manual_seed(2000))))
    return {"step_ms": step_ms, "step_ms_all": times_k, "losses": losses_k,
            "plain_losses": losses_p, "launches": launches,
            "max_memory_allocated_mib": peak_mb,
            "grad_worst_rel_l2": worst[0], "grad_worst": worst[1],
            "profiled_wall_ms": wall, "profiled_busy_ms": busy,
            "profiled_kernels": by_name}


def scannet_loop(dev, kernel_mods, blocks):
    """Phase 12 (d): the training driver's loop (``train/driver.py::run``)
    on the ScanNet YAML with SCANNET_LOOP_OVERRIDES: one launch of each
    attention kernel per block and train step, of each forward kernel per
    block and validation forward, finite losses, the audit of stages 1-4.
    Returns the loop's numbers."""
    import tempfile

    from stratified_transformer_torch.train import audit, driver
    from stratified_transformer_torch.utils.config import (
        load_cfg, merge_cfg_from_list)
    marks = []

    def counts():
        return {k: m_.KERNEL.launches for k, m_ in kernel_mods.items()}

    def loop_log(msg):
        log(f"[scannet] loop: {msg[:400]}")
        if msg.startswith("Epoch ["):
            marks.append(("step", counts(), 0))
        elif msg.startswith("Val epoch"):
            marks.append(("val", counts(), None))

    with tempfile.TemporaryDirectory() as tmp:
        yaml_cfg = merge_cfg_from_list(
            load_cfg(SCANNET_CONFIG),
            SCANNET_LOOP_OVERRIDES + ["save_path", os.path.join(tmp, "run")])
        for m_ in kernel_mods.values():
            m_.KERNEL.launches = 0
        t0 = time.perf_counter()
        _, summary = driver.run(yaml_cfg, "cuda", log=loop_log)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    val_forwards = iter(t["val_forwards"] for t in summary["timing"])
    marks = [(kind, now, next(val_forwards) if kind == "val" else 0)
             for kind, now, _ in marks]
    steps, vals = launch_deltas(marks, kernel_mods, blocks)
    if (steps, vals) != (summary["steps"], summary["val_forwards"]) or not (
            steps and vals):
        raise AssertionError(f"logged {steps} steps and {vals} validation "
                             f"forwards, the loop took {summary['steps']} "
                             f"and {summary['val_forwards']}")
    losses = [r["loss"] for r in summary["iters"]]
    audited = [r["audit"] for r in summary["iters"] if "audit" in r]
    if not (np.isfinite(losses).all() and all(
            np.isfinite(v) for r in summary["records"] for v in r.values())):
        raise AssertionError(f"non-finite loop losses {losses} or records "
                             f"{summary['records']}")
    if not audited or sorted(audited[-1]) != [
            f"stage_{i}" for i in range(1, 5)]:
        raise AssertionError(f"the audit did not cover stages 1-4: {audited}")
    out = {"loop_s": loop_s, "steps": steps, "val_forwards": vals,
           "launches": counts(), "losses": losses,
           "step_wall_ms": [1e3 * r["wall_s"] for r in summary["iters"]],
           "valid_points": [r["points"] for r in summary["iters"]],
           "timing": summary["timing"], "audit": audited[-1]}
    log(f"[scannet] loop: {steps} steps and {vals} validation forwards in "
        f"{loop_s:.1f} s, launches {out['launches']} ({blocks} of each "
        f"kernel per step, {blocks} forward and 0 backward per validation "
        f"forward); losses {losses}; valid points {out['valid_points']}; "
        f"{audit.format_truncation(audited[-1])}")
    return out


def scannet_phase(dev, kernel_mods):
    """Phase 12: the ScanNet family at full width on its YAML's batch shape
    (module docstring). Returns the numbers of (a)-(e) and each attention
    kernel's report of (a) under ``report``."""
    from stratified_transformer_torch.config import load_config
    from stratified_transformer_torch.data.loader import host_batch, to_device
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.train.step import make_eval_step
    from stratified_transformer_torch.utils.config import load_cfg
    t_phase = time.time()
    yaml_cfg = load_cfg(SCANNET_CONFIG)
    cfg = load_config(SCANNET_CONFIG)
    blocks = attention_blocks(cfg)

    def counts():
        return {k: m_.KERNEL.launches for k, m_ in kernel_mods.items()}

    t0 = time.time()
    hbs = [host_batch(cfg, seed=s, **SCANNET_ROOMS)
           for s in range(EVAL_BATCHES)]
    out = {"n_pad": cfg.n_pad, "blocks": blocks,
           "host_batch_s": (time.time() - t0) / len(hbs),
           "valid_points": [int(hb["offsets"][-1]) for hb in hbs]}
    log(f"[scannet] {len(hbs)} host batches (n_pad {cfg.n_pad}, "
        f"{cfg.num_scenes} slots, rooms {json.dumps(SCANNET_ROOMS)}): valid "
        f"points {out['valid_points']}, {out['host_batch_s']:.2f} s each")

    # (a) the four attention kernels at every stage's real plans
    levels = stage_levels(cfg, hbs[0])
    plans = {(i, sh): build_plan(cfg, i, levels[i], sh, dev)
             for i in stages(cfg) for sh in (False, True)}
    log_pairs("scannet batch 0", cfg, hbs[0], dev)
    report = new_report(FWD_KERNELS + BWD_KERNELS)
    fwd_phase(cfg, levels, plans, dev, report)
    bwd_phase(cfg, levels, plans, dev, report)
    out["report"] = report
    del plans

    # (b) three eval forwards
    model = build_model(cfg, "cuda", seed=0)
    o1_weights(model, seed=0)
    ref_model = build_model(dataclasses.replace(cfg, attn_impl="reference"),
                            "cuda")
    ref_model.load_state_dict(model.state_dict())
    eval_step = make_eval_step(int(yaml_cfg["ignore_label"]),
                               cfg.num_classes)
    batches = [to_device(hb, dev) for hb in hbs]
    eval_step(model, batches[0])                # first call: lazy set-up
    torch.cuda.synchronize()
    for m_ in kernel_mods.values():
        m_.KERNEL.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, logits_k = [], []
    for j, b in enumerate(batches):
        before = counts()
        t0 = time.perf_counter()
        logits, _, stats = eval_step(model, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per = {k: counts()[k] - before[k] for k in before}
        want = {k: blocks if k in FWD_KERNELS else 0 for k in before}
        if per != want:
            raise AssertionError(f"scannet forward {j} launches {per}, "
                                 f"expected {want}")
        if not (bool(torch.isfinite(logits).all())
                and bool(torch.isfinite(stats["loss"]))):
            raise AssertionError("non-finite scannet logits or loss")
        logits_k.append(logits)
    eval_launches = counts()
    eval_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    errs = []
    for j, b in enumerate(batches):
        want = eval_step(ref_model, b)[0]
        assert_close(f"scannet logits batch {j}", logits_k[j], want,
                     LOGIT_RTOL, LOGIT_ATOL)
        errs.append(max_errors(logits_k[j], want)[0])
    del logits_k
    _, busy, _ = profile_call("scannet forward",
                              lambda: eval_step(model, batches[0]))
    out["eval"] = {"forward_ms": times,
                   "forward_ms_median": float(np.median(times)),
                   "launches": eval_launches,
                   "max_memory_allocated_mib": eval_peak,
                   "profiled_busy_ms": busy, "logits_max_abs_err": errs}
    log(f"[scannet] eval forward median {out['eval']['forward_ms_median']:.1f}"
        f" ms ({', '.join(f'{t:.1f}' for t in times)}; host clock, "
        f"synchronized); launches over {len(batches)} forwards "
        f"{eval_launches}; logits vs plain-version forward max abs err "
        f"{max(errs):.2e}; max_memory_allocated {eval_peak:.0f} MiB; "
        f"profiled device busy {busy:.2f} ms")

    # (c) training steps: the YAML has aug False, so the eval batches
    log(f"[scannet] train: drop-path {cfg.drop_path_rate}, base_lr "
        f"{yaml_cfg['base_lr']} ({yaml_cfg['scheduler']}, warm-up "
        f"{yaml_cfg['warmup_iters']} steps), weight decay "
        f"{yaml_cfg['weight_decay']}, x{yaml_cfg['transformer_lr_scale']} on "
        f"blocks, ignore label {yaml_cfg['ignore_label']}")
    init_state = {k_: v_.clone() for k_, v_ in model.state_dict().items()}
    train = train_phase("[scannet]", cfg, yaml_cfg, init_state, batches,
                        kernel_mods)
    by_name = train.pop("profiled_kernels")
    gather_ms = sum(ms for name, (ms, _) in by_name.items()
                    if "indexing_backward" in name)
    train["indexing_backward_ms"] = gather_ms
    log(f"[scannet] profiled step: indexing_backward_kernel {gather_ms:.2f} "
        f"ms of {train['profiled_busy_ms']:.2f} ms device busy "
        f"({100 * gather_ms / train['profiled_busy_ms']:.1f}%; "
        f"{cfg.n_pad - out['valid_points'][0]} pad rows)")
    out["train"] = train
    del init_state, batches

    # (d) the training loop
    out["loop"] = scannet_loop(dev, kernel_mods, blocks)

    # (e) the on-device pyramid and whole-scene evaluation
    out["scene"] = scene_phase(cfg, hbs[0], model, ref_model, dev,
                               kernel_mods, yaml_path=SCANNET_CONFIG,
                               room=SCANNET_SCENE,
                               geometry=("geometry_pyramid",))
    out["seconds"] = time.time() - t_phase
    log(f"[scannet] phase 12 in {out['seconds']:.0f} s")
    return out


def attention_kernel_modules():
    """The four attention kernels' wrapper modules by kernel name."""
    from stratified_transformer_torch.kernels import (
        band_attention, band_attention_bwd, sparse_band_attention,
        sparse_band_attention_bwd)
    return {"band_attention": band_attention,
            "sparse_band_attention": sparse_band_attention,
            "band_attention_bwd": band_attention_bwd,
            "sparse_band_attention_bwd": sparse_band_attention_bwd}


def launch_deltas(marks, kernel_mods, blocks):
    """Per-step and per-validation launches from the counts read at each
    logged iteration (``step``) and validation (``val``) line, in order;
    raises unless every train step launched 12 of each attention kernel and
    every validation pass 12 forward launches per forward and no
    backward (``blocks`` = 12 attention blocks)."""
    prev = {k: 0 for k in kernel_mods}
    steps = vals = 0
    for kind, now, forwards in marks:
        delta = {k: now[k] - prev[k] for k in now}
        prev = now
        if kind == "step":
            want = {k: blocks for k in kernel_mods}
            steps += 1
        else:
            want = {k: blocks * forwards if k in FWD_KERNELS else 0
                    for k in kernel_mods}
            vals += forwards
        if delta != want:
            raise AssertionError(f"loop {kind} after {steps} steps: "
                                 f"launches {delta}, expected {want}")
    return steps, vals


def loop_phase(dev, kernel_mods):
    """Phase 11: the training driver's epoch loop (``train/driver.py::run``,
    the function its CLI runs) on ``configs/s3dis_stratified.yaml`` at full
    width with LOOP_OVERRIDES, fed by the ordered prefetch loader (2
    workers): 12 launches of each attention kernel per train step, 12
    forward and no backward launches per validation forward, finite losses;
    the step walls, load-wait / upload / step-block seconds, points per
    second, valid points and scenes per batch, the audit's drop fractions,
    validation seconds and peak memory. Then the same loop for one epoch
    with the batches built inline (``prefetch: false``); the first loader
    batch's train step through the kernels against the plain versions
    (gradients within GRAD_REL_L2 / GRAD_FLOOR, at `o1_weights`); the last
    checkpoint restored into a fresh model giving bit-identical logits on a
    validation batch; and one profiled loader-fed step. Returns the phase's
    numbers."""
    import tempfile

    from stratified_transformer_torch.config import from_cfg
    from stratified_transformer_torch.data.loader import (
        BatchLoader, build_dataset, to_device)
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.train import audit, checkpoint, driver
    from stratified_transformer_torch.train.metrics import memory_use
    from stratified_transformer_torch.train.step import (
        make_eval_step, make_train_step, pack_stats)
    from stratified_transformer_torch.utils.config import (
        load_cfg, merge_cfg_from_list)

    def counts():
        return {k: m_.KERNEL.launches for k, m_ in kernel_mods.items()}

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        yaml_cfg = merge_cfg_from_list(load_cfg(CONFIG), LOOP_OVERRIDES + [
            "save_path", os.path.join(tmp, "run")])
        cfg = from_cfg(yaml_cfg)
        seed = int(yaml_cfg["manual_seed"])
        marks = []

        def loop_log(msg):
            log(f"[loop] {msg[:400]}")
            if msg.startswith("Epoch ["):
                marks.append(("step", counts(), 0))
            elif msg.startswith("Val epoch"):
                marks.append(("val", counts(), None))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for m_ in kernel_mods.values():
            m_.KERNEL.launches = 0
        t0 = time.perf_counter()
        model, summary = driver.run(yaml_cfg, "cuda", log=loop_log)
        torch.cuda.synchronize()
        out["loop_s"] = time.perf_counter() - t0
        out["launches"] = counts()
        out["peak_gib"] = memory_use()["cuda:0"]["peak_bytes_gb"]
        val_forwards = iter(t["val_forwards"] for t in summary["timing"])
        marks = [(kind, now, next(val_forwards) if kind == "val" else 0)
                 for kind, now, _ in marks]
        steps, vals = launch_deltas(marks, kernel_mods,
                                    attention_blocks(cfg))
        if (steps, vals) != (summary["steps"], summary["val_forwards"]):
            raise AssertionError(f"logged {steps} steps and {vals} validation"
                                 f" forwards, the loop took {summary['steps']}"
                                 f" and {summary['val_forwards']}")
        losses = [r["loss"] for r in summary["iters"]]
        if not (np.isfinite(losses).all() and all(
                np.isfinite(v) for r in summary["records"]
                for v in r.values())):
            raise AssertionError(f"non-finite loop losses {losses} or records"
                                 f" {summary['records']}")
        walls = [1e3 * r["wall_s"] for r in summary["iters"]]
        points = [r["points"] for r in summary["iters"]]
        scenes = [r["scenes"] for r in summary["iters"]]
        train_wall = sum(t["wall_s"] for t in summary["timing"])
        audited = [r["audit"] for r in summary["iters"] if "audit" in r]
        out.update(
            steps=steps, val_forwards=vals, step_wall_ms=walls,
            step_wall_ms_median=float(np.median(walls)),
            step_wall_ms_median_after_first=float(np.median(walls[1:])),
            timing=summary["timing"], records=summary["records"],
            points_per_s=sum(points) / train_wall,
            valid_points=points, scenes=scenes, audit=audited[-1],
            val_s_per_forward=sum(t["val_s"] for t in summary["timing"])
            / vals)
        log(f"[loop] launches over {steps} train steps and {vals} validation "
            f"forwards: {out['launches']} (12 of each kernel per step, 12 "
            f"forward and 0 backward per validation forward)")
        log(f"[loop] step wall median {out['step_wall_ms_median']:.1f} ms "
            f"over {steps} loader-fed steps "
            f"({out['step_wall_ms_median_after_first']:.1f} ms without the "
            "first); walls " + ", ".join(f"{w:.0f}" for w in walls) + " ms")
        for t in summary["timing"]:
            log(f"[loop] epoch {t['epoch']}: wall {t['wall_s']:.2f} s, "
                f"load-wait {t['load_wait_s']:.2f} s, upload "
                f"{t['upload_s']:.2f} s, step-block {t['step_block_s']:.2f} s"
                f", {t['points']} points; validation {t.get('val_s', 0):.2f} "
                f"s for {t.get('val_forwards', 0)} forwards")
        log(f"[loop] points/s {out['points_per_s']:.0f} over the train "
            f"epochs' wall; valid points per batch {points}; scenes per "
            f"batch {scenes}")
        log(f"[loop] audit (last): {audit.format_truncation(audited[-1])}")
        log(f"[loop] peak memory {out['peak_gib']:.2f} GiB "
            f"(max_memory_allocated)")

        # the same loop with the batches built inline
        t0 = time.perf_counter()
        sync_cfg = merge_cfg_from_list(yaml_cfg, LOOP_SYNC_OVERRIDES + [
            "save_path", os.path.join(tmp, "sync")])
        _, sync = driver.run(sync_cfg, "cuda", log=lambda msg: None)
        sync_walls = [1e3 * r["wall_s"] for r in sync["iters"]]
        out["sync"] = {"loop_s": time.perf_counter() - t0,
                       "step_wall_ms": sync_walls,
                       "step_wall_ms_median": float(np.median(sync_walls)),
                       "timing": sync["timing"]}
        t = sync["timing"][0]
        log(f"[loop] prefetch false: step wall median "
            f"{out['sync']['step_wall_ms_median']:.1f} ms (walls "
            + ", ".join(f"{w:.0f}" for w in sync_walls) + f" ms); epoch wall "
            f"{t['wall_s']:.2f} s, load-wait {t['load_wait_s']:.2f} s, upload "
            f"{t['upload_s']:.2f} s, step-block {t['step_block_s']:.2f} s")

        # the first loader batch's step, kernels against plain versions
        train_loader = BatchLoader(build_dataset(yaml_cfg, "train"), cfg,
                                   yaml_cfg, shuffle=True, seed=seed)
        itr = iter(train_loader)
        batch = to_device(next(itr), dev)
        itr.close()
        o1 = build_model(cfg, "cuda", seed=0)
        o1_weights(o1, seed=0)
        init_state = o1.state_dict()
        train_step = make_train_step(int(yaml_cfg["ignore_label"]),
                                     cfg.num_classes)

        def first_step(impl):
            m_ = build_model(dataclasses.replace(cfg, attn_impl=impl), "cuda",
                             seed=0, train=True)
            m_.load_state_dict(init_state)
            opt = driver.build_optimizer(m_, yaml_cfg,
                                         train_loader.batches_per_epoch)
            stats = train_step(m_, opt, batch,
                               driver.drop_path_generator(dev, seed, 0))
            return ({n_: p_.grad.clone() for n_, p_ in m_.named_parameters()},
                    float(stats["loss"]))

        grads_k, loss_k = first_step("fused")
        grads_p, loss_p = first_step("reference")
        worst = check_grads("first loader-fed step", grads_k, grads_p)
        out.update(grad_worst_rel_l2=worst[0], grad_worst=worst[1],
                   first_step_loss=(loss_k, loss_p),
                   grad_check_points=int(batch["offsets"][-1]))
        log(f"[loop] first loader batch ({out['grad_check_points']} valid "
            f"points, n_pad {cfg.n_pad}): step-1 grads of all "
            f"{len(grads_p)} parameters within {GRAD_REL_L2} relative L2 "
            f"(+{GRAD_FLOOR}/entry) of the plain-version step; largest "
            f"{worst[0]:.2e} ({worst[1]}); loss {loss_k:.5f} vs {loss_p:.5f}")
        del grads_k, grads_p, o1, batch

        # the last checkpoint into a fresh model: the same logits
        val_loader = BatchLoader(build_dataset(yaml_cfg, "val"), cfg,
                                 yaml_cfg, shuffle=False, seed=0)
        itr = iter(val_loader)
        vbatch = to_device(next(itr), dev)
        itr.close()
        eval_step = make_eval_step(int(yaml_cfg["ignore_label"]),
                                   cfg.num_classes)
        model.eval()
        logits = eval_step(model, vbatch)[0]
        fresh = build_model(cfg, "cuda", seed=1)
        _, epoch, _ = checkpoint.restore(os.path.join(tmp, "run", "ckpt"),
                                         fresh)
        if epoch != 2 or not torch.equal(eval_step(fresh, vbatch)[0], logits):
            raise AssertionError(f"the restored epoch-{epoch} checkpoint "
                                 "gives other logits than the trained model")
        fwd = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eval_step(model, vbatch)
            torch.cuda.synchronize()
            fwd.append(1e3 * (time.perf_counter() - t0))
        out["val_forward_ms"] = float(np.median(fwd))
        log(f"[loop] checkpoint of epoch {epoch} restored into a fresh model:"
            f" logits bit-identical on a validation batch "
            f"({int(vbatch['offsets'][-1])} valid points); validation forward"
            f" {out['val_forward_ms']:.1f} ms (median of 3, synchronized)")
        del fresh, vbatch, logits

        # one profiled loader-fed step: dispatch, next host batch, stats
        # read, upload
        model.train()
        opt = driver.build_optimizer(model, yaml_cfg,
                                     train_loader.batches_per_epoch)
        itr = iter(BatchLoader(build_dataset(yaml_cfg, "train"), cfg,
                               yaml_cfg, shuffle=True, seed=seed))
        cur = [to_device(next(itr), dev)]

        def fed_step():
            packed = pack_stats(train_step(model, opt, cur[0],
                                           driver.drop_path_generator(
                                               dev, seed, 0)))
            host = next(itr)
            packed.cpu()
            cur[0] = to_device(host, dev)

        fed_step()                  # AdamW's state and the first backward
        wall, busy, _ = profile_call("loader-fed train step (N "
                                     f"{cfg.n_pad}, 8 slots)", fed_step)
        itr.close()
        out.update(profiled_wall_ms=wall, profiled_busy_ms=busy,
                   profiled_busy_share=busy / wall)
    return out


def bincount_iou(pred, target, num_classes, ignore_label, valid=None):
    """`metrics.intersection_and_union` with ``torch.bincount`` histograms,
    its form before the training loop: on the card ``bincount`` reads its
    input's maximum on the host, so each call waits for the device."""
    mask = target != ignore_label
    if valid is not None:
        mask = mask & valid
    pred = torch.where(mask, pred, num_classes)
    target = torch.where(mask, target, num_classes)
    inter = torch.where(pred == target, pred, num_classes)

    def hist(x):
        return torch.bincount(x.long(), minlength=num_classes + 1)[
            :num_classes]

    area_inter, area_pred, area_target = hist(inter), hist(pred), hist(target)
    return area_inter, area_pred + area_target - area_inter, area_target


def iou_phase(cfg, hb, dev, reps=50, rounds=6):
    """``--iou-only``: the IoU counters of the train and eval steps,
    `metrics.intersection_and_union` (scatter-add histograms, no host sync)
    against `bincount_iou`, on random predictions and labels (10% ignored,
    the last 15% of rows padding) at phase 2's N and at phase 11's: equal
    counts, the synchronized host wall per call (median of ``reps``) and the
    device time per call (`device_busy_ms`). Then phase 5's eval forward
    (phase 2's batch, full width) with each form, in turns over ``rounds``
    rounds, synchronized host wall per forward."""
    from stratified_transformer_torch.config import from_cfg
    from stratified_transformer_torch.data.loader import to_device
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.train import metrics
    from stratified_transformer_torch.train.step import make_eval_step
    from stratified_transformer_torch.utils.config import (
        load_cfg, merge_cfg_from_list)

    forms = {"scatter_add": metrics.intersection_and_union,
             "bincount": bincount_iou}
    loop_n = from_cfg(merge_cfg_from_list(load_cfg(CONFIG),
                                          LOOP_OVERRIDES)).n_pad
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"counters": {}}
    for n in (cfg.n_pad, loop_n):
        target = torch.randint(0, cfg.num_classes, (n,), generator=gen,
                               device=dev)
        target[torch.rand(n, generator=gen, device=dev) < 0.1] = 255
        pred = torch.where(
            torch.rand(n, generator=gen, device=dev) < 0.6, target.clamp_max(
                cfg.num_classes - 1), torch.randint(
                0, cfg.num_classes, (n,), generator=gen, device=dev))
        valid = torch.arange(n, device=dev) < int(0.85 * n)
        args = (pred, target, cfg.num_classes, 255, valid)
        want = [t.cpu() for t in bincount_iou(*args)]
        row = {}
        for name, fn in forms.items():
            got = [t.cpu() for t in fn(*args)]
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"N {n}: {name} counts differ")
            walls = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(*args)
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
            row[name] = {"host_ms": float(np.median(walls)),
                         "device_ms": device_busy_ms(lambda: fn(*args), 20)}
        out["counters"][str(n)] = row
        log(f"[iou] N {n}: " + "; ".join(
            f"{k} host {v['host_ms']:.3f} ms, device {v['device_ms']:.4f} ms"
            for k, v in row.items()) + " per call (counts equal)")

    model = build_model(cfg, "cuda", seed=0)
    eval_step = make_eval_step(255, cfg.num_classes)
    batch = to_device(hb, dev)
    fwd = {name: [] for name in forms}
    try:
        for name in forms:              # first calls: lazy set-up
            metrics.intersection_and_union = forms[name]
            eval_step(model, batch)
        for _ in range(rounds):
            for name, fn in forms.items():
                metrics.intersection_and_union = fn
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eval_step(model, batch)
                torch.cuda.synchronize()
                fwd[name].append(1e3 * (time.perf_counter() - t0))
    finally:
        metrics.intersection_and_union = forms["scatter_add"]
    out["eval_forward_ms"] = fwd
    log("[iou] eval forward (N " f"{cfg.n_pad}, synchronized, in turns): " +
        "; ".join(f"{k} median {float(np.median(v)):.1f} ms (" +
                  ", ".join(f"{w:.1f}" for w in v) + ")"
                  for k, v in fwd.items()))
    return out


def phase_only(flag):
    """``--fwd-only`` / ``--bwd-only`` / ``--scene-only`` / ``--loop-only``
    / ``--scannet-only`` / ``--iou-only``: phase 1's build of the kernels
    the phase runs, and phase 4 (the forward kernels, with phase 2's host
    batch and plans on the card), phase 7 (the backward kernels, likewise),
    phase 10 (whole-scene evaluation, with phase 5's full-width models),
    phase 11 (the training loop), phase 12 (ScanNet) or `iou_phase`; prints
    one JSON line."""
    sys.path.insert(0, REPO)
    from stratified_transformer_torch.config import load_config
    from stratified_transformer_torch.data.loader import host_batch
    from stratified_transformer_torch.kernels import build
    names = PHASE_ONLY[flag]
    dev = torch.device("cuda")
    build.build_all(list(names))
    ptxas = [f"{name}: {line.strip()}"
             for name, text in build.build_logs.items()
             for line in text.splitlines()
             if "registers" in line or "spill" in line]
    if flag in ("--loop-only", "--scannet-only"):
        phase = loop_phase if flag == "--loop-only" else scannet_phase
        out = {"card": card_line(), "repo": REPO,
               flag[2:-5]: phase(dev, attention_kernel_modules()),
               "ptxas": ptxas}
        print(json.dumps(out))
        return 0
    cfg = load_config(CONFIG, n_pad=N_PAD, num_scenes=SCENES)
    hb = host_batch(cfg, seed=0)
    out = {"card": card_line(), "repo": REPO}
    if flag == "--iou-only":
        out["iou"] = iou_phase(cfg, hb, dev)
        print(json.dumps(out))
        return 0
    if flag == "--scene-only":
        from stratified_transformer_torch.models.stratified import (
            build_model)
        model = build_model(cfg, "cuda", seed=0)
        o1_weights(model, seed=0)
        ref_model = build_model(
            dataclasses.replace(cfg, attn_impl="reference"), "cuda")
        ref_model.load_state_dict(model.state_dict())
        out["scene"] = scene_phase(cfg, hb, model, ref_model, dev,
                                   attention_kernel_modules())
        print(json.dumps(out))
        return 0
    levels = stage_levels(cfg, hb)
    plans = {(i, shifted): build_plan(cfg, i, levels[i], shifted, dev)
             for i in range(cfg.num_layers) for shifted in (False, True)}
    report = new_report(names)
    if flag == "--fwd-only":
        out["stages"] = fwd_phase(cfg, levels, plans, dev, report)
        out["ms_per_eval_forward"] = report
    else:
        bwd_phase(cfg, levels, plans, dev, report)
        out["ms_per_train_step"] = report
    out["ptxas"] = ptxas
    print(json.dumps(out))
    return 0


# the kernels each phase run alone builds
PHASE_ONLY = {"--fwd-only": FWD_KERNELS, "--bwd-only": BWD_KERNELS,
              "--scene-only": FWD_KERNELS,
              "--loop-only": FWD_KERNELS + BWD_KERNELS,
              "--scannet-only": FWD_KERNELS + BWD_KERNELS,
              "--iou-only": FWD_KERNELS}


def parse_args(argv):
    """The flag of the phase to run alone (a key of ``PHASE_ONLY``), None
    for the whole run; raises ValueError on anything else."""
    if not argv:
        return None
    if len(argv) == 1 and argv[0] in PHASE_ONLY:
        return argv[0]
    raise ValueError(f"unknown arguments {argv}; give none or one of "
                     + ", ".join(PHASE_ONLY))


def main(argv):
    t_start = time.time()
    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        only = parse_args(argv)
    except ValueError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if only is not None:
        return phase_only(only)
    sys.path.insert(0, REPO)
    from stratified_transformer_torch.config import load_config
    from stratified_transformer_torch.data.loader import host_batch, to_device
    from stratified_transformer_torch.kernels import band_attention as band_k
    from stratified_transformer_torch.kernels import (
        band_attention_bwd as band_bwd_k)
    from stratified_transformer_torch.kernels import build
    from stratified_transformer_torch.kernels import (
        sparse_band_attention as sparse_k)
    from stratified_transformer_torch.kernels import (
        sparse_band_attention_bwd as sparse_bwd_k)
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.ops import attention as plain
    from stratified_transformer_torch.train.step import make_eval_step
    from stratified_transformer_torch.utils.config import load_cfg

    dev = torch.device("cuda")
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"count {torch.cuda.device_count()}")
    t0 = time.time()
    build.build_all(list(TPU_KERNELS))
    log(f"[device] built the {len(TPU_KERNELS)} kernels with nvcc for "
        f"sm_90a in "
        f"{time.time() - t0:.1f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {name}: {line.strip()}")

    # ---- 2. host tier and plans on the card ------------------------------
    cfg = load_config(CONFIG, n_pad=N_PAD, num_scenes=SCENES)
    t0 = time.time()
    hb = host_batch(cfg, seed=0)
    log(f"[host] S3DIS batch N={N_PAD}, {SCENES} scenes, "
        f"{int(hb['offsets'][-1])} valid points, built in "
        f"{time.time() - t0:.2f} s")
    levels = stage_levels(cfg, hb)
    plans = {}
    for i in range(cfg.num_layers):
        for shifted in (False, True):
            on_card = build_plan(cfg, i, levels[i], shifted, dev)
            on_cpu = build_plan(cfg, i, levels[i], shifted, "cpu")
            for (name, a), (_, b) in zip(plan_fields(on_card),
                                         plan_fields(on_cpu)):
                if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
                    raise AssertionError(
                        f"stage {i} shifted={shifted}: plan field {name} "
                        "differs between the card and the CPU")
            plans[i, shifted] = on_card
    log(f"[plans] {len(plans)} plans (4 stages x 2 parities) bit-identical "
        "between the card and the CPU")

    # ---- 3. bins ---------------------------------------------------------
    rng = np.random.default_rng(0)
    n_bins = 0
    for i in range(cfg.num_layers):
        ws, qs = cfg.window_sizes()[i], cfg.quant_sizes()[i]
        nbf = 2 * int((2 * ws + 1e-4) // qs)
        bounds = (np.arange(nbf) * qs - 2 * ws + 1e-4).astype(np.float32)
        lattice = np.round(rng.uniform(-2 * ws, 2 * ws, 1 << 16) * 1e5) / 1e5
        rel = np.concatenate([
            lattice.astype(np.float32), bounds,
            np.nextafter(bounds, np.float32(-np.inf)),
            np.nextafter(bounds, np.float32(np.inf)),
            (bounds + np.float32(1e-5)).astype(np.float32)])
        rel_t = torch.from_numpy(rel)
        want = plain.relative_position_index(rel_t, ws, qs, nbf)
        got = band_k.rel_bins(rel_t.to(dev), ws, qs, nbf).cpu().long()
        got_plain = plain.relative_position_index(
            rel_t.to(dev), ws, qs, nbf).cpu()
        lo, nb = plain.band_table_slice(nbf)
        got_band = band_k.rel_bins(rel_t.to(dev), ws, qs, nbf, lo, nb).cpu()
        if not (torch.equal(got, want) and torch.equal(got_plain, want)
                and torch.equal(got_band.long(),
                                (want - lo).clamp(0, nb - 1))):
            raise AssertionError(
                f"stage {i}: device bins differ from the CPU on "
                f"{int((got != want).sum())} of {len(rel)} sweep values")
        n_bins += len(rel)
    log(f"[bins] kernel bin function == relative_position_index (CPU) on "
        f"{n_bins} boundary-dense sweep values over 4 stages")

    # ---- 4. kernels against their plain versions --------------------------
    report = new_report(TPU_KERNELS)
    fwd_phase(cfg, levels, plans, dev, report)

    # ---- 5. full-width eval step ------------------------------------------
    model = build_model(cfg, "cuda", seed=0)
    o1_weights(model, seed=0)
    eval_step = make_eval_step(int(load_cfg(CONFIG)["ignore_label"]),
                               cfg.num_classes)
    eval_hbs = [host_batch(cfg, seed=s) for s in range(EVAL_BATCHES)]
    batches = [to_device(hb, dev) for hb in eval_hbs]
    for j, hb in enumerate(eval_hbs):
        log_pairs(f"eval batch {j}", cfg, hb, dev)
    eval_step(model, batches[0])                # first call: lazy set-up
    torch.cuda.synchronize()
    kernel_mods = {"band_attention": band_k, "sparse_band_attention": sparse_k,
                   "band_attention_bwd": band_bwd_k,
                   "sparse_band_attention_bwd": sparse_bwd_k}

    def counts():
        return {k: m_.KERNEL.launches for k, m_ in kernel_mods.items()}

    for m_ in kernel_mods.values():
        m_.KERNEL.launches = 0
    torch.cuda.reset_peak_memory_stats()
    outputs, times = [], []
    for b in batches:
        before = (band_k.KERNEL.launches, sparse_k.KERNEL.launches)
        t0 = time.perf_counter()
        logits, _, stats = eval_step(model, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_fwd = (band_k.KERNEL.launches - before[0],
                   sparse_k.KERNEL.launches - before[1])
        if per_fwd != (12, 12):
            raise AssertionError(f"kernel launches per forward {per_fwd}, "
                                 "expected (12, 12)")
        if logits.shape != (N_PAD, cfg.num_classes):
            raise AssertionError(f"logits shape {tuple(logits.shape)}")
        if not (bool(torch.isfinite(logits).all())
                and bool(torch.isfinite(stats["loss"]))):
            raise AssertionError("non-finite logits or loss")
        outputs.append((logits, stats))
    launches = counts()
    if launches["band_attention_bwd"] or launches["sparse_band_attention_bwd"]:
        raise AssertionError(f"the eval forward launched a backward kernel: "
                             f"{launches}")
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for j, (logits, stats) in enumerate(outputs):
        log(f"[eval] batch {j}: loss {float(stats['loss']):.4f}, "
            f"{int(stats['points'])} points, forward {times[j]:.1f} ms "
            "(host clock, synchronized)")
    log(f"[eval] launches over {EVAL_BATCHES} forwards: {launches}; "
        f"max_memory_allocated {peak_mb:.0f} MiB")

    ref_model = build_model(dataclasses.replace(cfg, attn_impl="reference"),
                            "cuda", seed=0)
    ref_model.load_state_dict(model.state_dict())
    for j, b in enumerate(batches):
        ref_logits, _, ref_stats = eval_step(ref_model, b)
        log(f"[eval] batch {j}: logits max |x| "
            f"{float(ref_logits.abs().max()):.3f}, std "
            f"{float(ref_logits.std()):.3f}")
        assert_close(f"logits batch {j}", outputs[j][0], ref_logits,
                     LOGIT_RTOL, LOGIT_ATOL)
        e = max_errors(outputs[j][0], ref_logits)
        log(f"[eval] batch {j}: logits vs plain-version forward max abs/rel "
            f"err {e[0]:.2e}/{e[1]:.2e}; loss {float(ref_stats['loss']):.4f}")
    if counts() != launches:
        raise AssertionError("the plain-version forward launched a kernel")
    fwd_ms = float(np.median(times))
    log(f"[eval] full-width forward median {fwd_ms:.1f} ms over "
        f"{EVAL_BATCHES} batches")

    # ---- 6. where the forward's time goes ----------------------------------
    profile_call("forward", lambda: eval_step(model, batches[0]))

    # ---- 7. backward kernels against their plain versions -----------------
    bwd_phase(cfg, levels, plans, dev, report)

    # ---- 8. full-width training steps -------------------------------------
    yaml_cfg = load_cfg(CONFIG)
    t0 = time.time()
    train_hbs = [host_batch(cfg, seed=10 + s, train=True,
                            rng=np.random.default_rng(100 + s), aug=yaml_cfg)
                 for s in range(TRAIN_STEPS)]
    train_batches = [to_device(hb, dev) for hb in train_hbs]
    log(f"[train] {TRAIN_STEPS} augmented S3DIS batches (N={N_PAD}, "
        f"{SCENES} scenes) built in {time.time() - t0:.2f} s; drop-path "
        f"{cfg.drop_path_rate}, base_lr {yaml_cfg['base_lr']}, weight decay "
        f"{yaml_cfg['weight_decay']}, x{yaml_cfg['transformer_lr_scale']} "
        "on blocks")
    for j, hb in enumerate(train_hbs):
        log_pairs(f"train batch {j}", cfg, hb, dev)
    init_state = {k_: v_.clone() for k_, v_ in model.state_dict().items()}
    train = train_phase("[train]", cfg, yaml_cfg, init_state, train_batches,
                        kernel_mods)
    train_ms, train_launches = train["step_ms"], train["launches"]
    train_peak_mb = train["max_memory_allocated_mib"]
    del init_state

    # ---- 9. the probes -----------------------------------------------------
    probe_launches = probe_phase(dev, report)

    # ---- 10. whole-scene evaluation --------------------------------------
    del train_batches
    scene = scene_phase(cfg, hb, model, ref_model, dev, kernel_mods)

    # ---- 11. the training loop, fed by the loader -------------------------
    del model, ref_model
    loop = loop_phase(dev, kernel_mods)

    # ---- 12. the ScanNet family -------------------------------------------
    scannet = scannet_phase(dev, kernel_mods)
    log(f"[run] total {time.time() - t_start:.0f} s")

    kernels = []
    for name, path in TPU_KERNELS.items():
        r = report[name]
        entry = {
            "name": name, "route": "cuda",
            "source": f"stratified_transformer_torch/csrc/{name}.cu",
            "replaces": path, "launches": train_launches.get(name, 0),
            "eval_launches": launches.get(name, 0),
            "scene_launches": scene["launches"].get(name, 0),
            "loop_launches": loop["launches"].get(name, 0),
            "scene_ms_per_forward": scene["kernel_ms_per_forward"].get(
                name, 0.0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": max(r["bound_by"], key=r["bound_by"].get),
            "library_ms": r.get("library_ms")}
        for key in ("wrapper_ms", "wrapper_busy_ms"):
            if key in r:
                entry[key] = r[key]
        if name in scannet["report"]:
            sr = scannet["report"][name]
            entry.update(
                scannet_launches=scannet["train"]["launches"][name],
                scannet_eval_launches=scannet["eval"]["launches"][name],
                scannet_ms=sr["ms"], scannet_plain_ms=sr["plain_ms"],
                scannet_bound_ms=sr["bound_ms"],
                scannet_max_abs_err=sr["max_abs_err"])
        if name in PROBE_KERNELS:
            entry["probe_launches"] = probe_launches[name]
            entry["times_per"] = "one launch of the probe"
        kernels.append(entry)
    print(json.dumps({
        "kernels": kernels,
        "times_per": "one full-width training step (12 launches of each "
                     "attention kernel; a forward kernel's time is also one "
                     "eval forward's); a probe's: one launch, and its "
                     "launches on the train step are 0",
        "launches_over_train_steps": TRAIN_STEPS,
        "eval_launches_over_forwards": EVAL_BATCHES,
        "train_step_ms": train_ms,
        "train_max_memory_allocated_mib": train_peak_mb,
        "eval_forward_ms": fwd_ms,
        "eval_max_memory_allocated_mib": peak_mb,
        "scene_launches_over_forwards": scene["forwards"],
        "scene": scene,
        "loop_launches_over": {"train_steps": loop["steps"],
                               "val_forwards": loop["val_forwards"]},
        "loop": loop,
        "scannet_times_per": "one ScanNet training step (18 launches of "
                             "each attention kernel at phase 12 (a)'s "
                             "plans); scannet_launches over its "
                             f"{TRAIN_STEPS} steps",
        "scannet": {k: v for k, v in scannet.items() if k != "report"}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
