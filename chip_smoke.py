#!/usr/bin/env python3
"""Drive the PyTorch port's evaluation forward, training step, whole-scene
evaluation (sharded too) and training loop, for the S3DIS, ScanNet, DCF
and Swin3D families, the DCF family's box-mAP and layout-removal drivers,
its two probes, the shipped YAMLs' bf16 fast mode, and ScanNet's offline
preparation from raw scans with the legacy dense-batch ops, on an NVIDIA
GPU.

Run from the repository root with no arguments (needs one CUDA card):

    python3 chip_smoke.py

``python3 chip_smoke.py --fwd-only`` builds the two forward kernels and
runs phase 4 alone; ``--bwd-only`` builds the two backward kernels and runs
phase 7 alone; ``--scene-only`` builds the two forward kernels and runs
phase 10 alone; ``--loop-only`` builds the four attention kernels and runs
phase 11 alone; ``--scannet-only`` builds the four attention kernels and
runs phase 12 alone (``--scannet-kernels-only``: its (a) alone, the
four kernels at ScanNet's plans); ``--dcf-only`` builds the four
attention kernels and runs phase 13 alone; ``--fast-only`` builds the four
attention kernels (their sources hold the fp32 and the fast forms) and
runs phase 14 alone;
``--swin-only`` builds the two band kernels and runs phase 15 alone;
``--dp-only`` builds the four attention kernels and runs phase 16 alone;
``--halo-only`` builds the two forward kernels and runs phase 17 alone;
``--prep-only`` builds the two forward kernels and runs phase 18 alone;
``--bwd-phases`` builds the two backward kernels and variants of them
without one phase of the fast form's block routine each, and times them
at phase 14's S3DIS and ScanNet plans (`bwd_phases`);
``--iou-only`` builds the two forward kernels and times the train and eval
steps' IoU counters (`iou_phase`). Each prints its
times as one JSON line (``--fwd-only`` also per stage and parity). Copied into another checkout (say a parent commit
unpacked beside the tree) and run from there, it times that checkout's
kernels and wrappers the same way, so two versions can be compared in
turns on one card.

Phases 2-13, 15 (but its (f)) and 16 pin ``rpe_precision``/``qk_precision`` to
"highest" (the fp32 kernels, `PIN_NOTE`), so that their gates and times
stay comparable with the runs before the fast forms; phases 14 and 18 run
the YAMLs as shipped (the Swin YAMLs ship "highest").

Phases, each fatal on failure:
  1. device: card name, power limit, CUDA version; builds the six kernels
     from ``stratified_transformer_torch/csrc`` with nvcc (in parallel);
  2. host tier and plans: the S3DIS batch (N=40960, 2 scenes), and every
     attention plan built on the card bit-identical to the CPU plan;
  3. bins: the kernels' device bin function against
     ``relative_position_index`` on the CPU over a boundary-dense sweep;
  4. the forward kernels against their plain PyTorch versions at every
     stage's real shapes and plans: errors, CUDA-event times of the bare
     launch, the public wrapper's device-busy time (CUDA events behind a
     sleep kernel, `device_busy_ms`), bounds;
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
     the wrapper's device-busy time (`device_busy_ms`), bounds;
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
     held below ``DENSE_KEYS``, the first pass against the plain path;
 13. the DCF family (``configs/dcf_stratified.yaml``: the S3DIS backbone
     with the offset head, 18 classes) at full width on fabricated cube
     scenes (the fork's cube files are not in the repository), read by the
     port's ``DCF`` reader through the loader at the YAML's batch shape
     (n_pad 140032, 8 slots): (a) three eval forwards, 12 + 12 launches
     each, logits and offsets against the plain-version forward, one
     profiled; three training steps with the L1 offset loss, 12 launches of
     each kernel per step, step-1 gradients (the head's included), the
     loss and offset-loss trajectories against the plain versions, one
     profiled; (b) the training driver's loop for 1 epoch with validation,
     ``loss_offset`` in ``metrics.jsonl``, the checkpoint restored giving
     bit-identical logits and offsets; (c) ``test_iou.py``'s protocol
     (``eval/iou_driver.py``) on one 200000-point scene at n_pad 320000 in 4
     slots: launches, seconds of forwards and of host post-processing,
     crops, objects before and after the merge, TP/FP/FN and peak memory;
     the first crop batch against the plain versions; the protocol again
     giving identical boxes; the host steps on stand-in offsets; (d) the
     layout-removal driver's two ``.ply`` files read back;
 14. the shipped YAMLs' fast mode (``rpe_precision``/``qk_precision:
     default``): (a) the bf16 forms of the four attention kernels against
     their plain fast versions at phase 2's S3DIS batch and every stage's
     plans (output within FAST_OUT_REL_L2, gradients within
     FAST_GRAD_REL_L2 relative L2, and each fp32 form beyond those gates
     from the same plain fast versions), their times, bounds (products at
     the bf16 tensor-core peak) and the fp32 forms' times on the same
     inputs; (b) ``configs/s3dis_stratified.yaml`` as shipped at full
     width: three eval forwards, 12 launches of each fast forward kernel
     and none of the fp32 ones, logits against the plain fast versions'
     (the fp32 kernels' logits beyond the gate); one training step, 12
     launches of each fast kernel, step-1 gradients and loss against the
     plain fast step (the fp32 kernels' step beyond the gate), and three
     steps of each kind timed in turns; (c) the four fast kernels at
     ScanNet's 80-row tables on phase 12's plans of one batch, and the
     shipped ScanNet YAML's full-width eval forward on that batch, fast and
     pinned to fp32, three of each in turns;
 15. the Swin3D family (``configs/s3dis_swin3d.yaml`` and
     ``configs/scannetv2_swin3d.yaml``: ``arch: swin3d_transformer``, no far
     keys, window-quantized cRPE bins over 31 table rows, through the band
     kernels' swin mode; the YAMLs' ``attn_impl: reference`` runs the main
     path, as ``config.from_cfg`` reads it): (a) at phase 2's batch, every
     stage's and parity's quantized positions bit-identical between the
     card and the CPU, and the swin bin probe on every integer ``rel`` in
     ``[-qgl-2, qgl+2]`` equal to ``swin_relative_position_index``; (b) the
     band forward and backward kernels in the swin mode against their plain
     versions at every block's plan (phase 4's and 7's gates), with times,
     bounds and plain times; (c) the full-width S3DIS Swin3D: three eval
     forwards (12 band launches each, none else) and three training steps
     (12 of each band kernel per step) against the plain-version model
     (phases 5 and 8's gates); (d) the same at ScanNet's Swin3D (n_pad
     250112 in 2 slots, stages 1-4, 18 blocks), one forward and one step,
     then (b) and (f)'s kernel checks and times at its batch's plans;
     (e) the shipped S3DIS Swin YAML through the training driver (1 epoch of
     2 steps with validation) and the eval driver (one 40000-point room at
     the YAML's test shape); (f) the fast forms against their plain fast
     versions at (b)'s plans (phase 14's kernel gates with their fp32
     controls), and the YAML at ``default`` precision through one forward
     and one training step on the bf16 band kernels;
 16. data-parallel training (``parallel/``, SyncBN, the per-rank loader,
     the training driver's rank function), fp32 kernels: (a) two S3DIS
     steps at phase 2's batch shape through every collective of the DP
     step (SyncBN, the gradient average, the packed statistics) in a
     one-rank NCCL group, bit-identical to the one-device steps
     (deterministic algorithms); (b) two ranks on the one card over gloo (NCCL refuses two
     ranks on one device) at the shipped S3DIS YAML's DP shape (phase 11's
     140000 points in 8 slots split into 2 x n_pad 70016 in 4 slots): on
     identical batches the one-device step's parameters; on distinct
     batches the ranks bit-identical, every attention kernel launched on
     every rank, the gradients against the plain versions'; the DP step's
     wall per rank and the gradient all-reduce's share; (c) the training
     driver's rank function on two ranks for one epoch of 2 steps with
     validation on rank 0, the ranks in one state, rank 0's checkpoint
     restored into a one-device model bit for bit, step walls and the
     all-reduce's share;
 17. sharded whole-scene inference (``parallel/halo.py``,
     ``evaluate_scene_sharded``, the eval driver's ``sharded*`` keys),
     fp32 kernels: (a) the first vote chunk of phase 10's room at full
     width through host replication and both halo exchanges in a one-rank
     NCCL group (every collective forced), against the whole-chunk
     forward at one capacity; (b) the JAX test's corridor
     (``tests/test_halo.py:79-115``, heads (1, 2)) on four gloo ranks on
     the card: host replication, ``ppermute`` and ``allgather`` against
     the whole-scene forward through the kernels, the sub-window controls,
     no halo point dropped, every block forward against the plain
     versions; (c) the eval driver with ``sharded: true`` on two gloo
     ranks on phase 10's room (HALO_PASSES TTA passes), capacities at the
     largest chunk and slab: nothing truncated, dropped or re-run, one
     launch of each forward kernel per block and block forward, the
     driver's lines; the first chunk against the whole-chunk forward with
     each block's and the chunk's truncation audit; seconds, forwards per
     rank, the collectives' ms per chunk, the host's share; the serial
     sphere-crop protocol on the same passes and the two labelings'
     agreement; (d) the YAML's own capacities on one pass: every chunk
     whose halo overflows ``halo_cap`` re-run through host replication and
     logged; (e) ``python -m stratified_transformer_torch.eval.driver
     --config configs/s3dis_stratified.yaml sharded true`` as a user runs
     it (the card, the YAML's fast mode) on one S3DIS-format room;
 18. ScanNet from raw scans (``tools/prepare_scannet.py`` of the port,
     ``ops/legacy.py``): (a) PREP_SCANS scans in ScanNet's raw layout
     (binary ``_vh_clean_2.ply`` and ``.labels.ply`` of 200000 vertices
     and about 400000 faces in a 5 m room, segs and aggregation JSON with
     every benchmark class and some unmapped nyu40 ids) through the port's
     preparation tool with ``--gt_txt_out``, its seconds per scene; (b)
     ``scannet_scenes`` and ``Scannetv2(split="val")`` read the ``.pth``
     files back, labels, centred coordinates, colours and the GT txt equal
     to the scans'; (c) one eval forward per prepared scene of
     ``configs/scannetv2_stratified.yaml`` as shipped (fast kernels,
     through the validation loader's batches): 18 launches of each fast
     forward kernel per forward and no other, logits within
     FAST_LOGITS_REL_L2 of the plain fast versions', the forward's ms; (d)
     every legacy dense-batch op, ``subtraction`` and ``aggregation`` (with
     their gradients) and ``divide2patch`` on the card and the CPU at
     LEGACY's sizes, integers equal, floats within LEGACY_RTOL /
     LEGACY_ATOL.

Prints a ``kernels`` JSON line, the card's name and power limit, and as its
last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when no CUDA card is present.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import types
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "s3dis_stratified.yaml")
SCANNET_CONFIG = os.path.join(REPO, "configs", "scannetv2_stratified.yaml")
N_PAD, SCENES = 40960, 2
EVAL_BATCHES = 3
TRAIN_STEPS = 3
# phase 14 (b): train steps of each kind (fast, fp32 kernels) timed in turns
STEP_TIMINGS = 3
# the synthetic train set's iterations per epoch (train.py's BatchLoader
# over 32 synthetic scenes in batches of 2): epoch-stepped schedules read it
TRAIN_ITERS_PER_EPOCH = 16
# H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the tensor cores,
# dense bf16 on the tensor cores and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
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
# phase 14, the fast (bf16) kernels against their plain fast versions,
# which round the same operands at the same maxima (p at the running row
# maximum of 32-key chunks counted from the window's first key) and, given
# the kernels' row slices (`slice_rows`), sum the key masses over the same
# rows: what is left is fp32 sums in another order, whose last-bit
# differences flip a bf16 rounding of p, dl or a mass here and there.
# Relative L2 over each tensor, not per entry, for those flips. Each gate
# must fail the fp32 form (control): every fast kernel's fp32 form is held
# against the same plain fast version and must land beyond the gate, else
# the gate could not tell a kernel that does not round from one that does
# (the fp32 forms differ from the plain fast versions by the fast mode's
# own rounding). On an H100 at S3DIS's and ScanNet's plans: outputs 2.6e-8
# to 6.5e-5 (fp32 forms 2.4e-3 to 4.0e-3), gradients 3.5e-8 to 9.1e-5
# (fp32 forms 2.3e-3 to 6.0e-3). m and den sum fp32 values of the same
# rounded products and keep the fp32 tolerance (RTOL / ATOL).
FAST_OUT_REL_L2, FAST_GRAD_REL_L2 = 2e-4, 5e-4
# The full-width fast model (b), kernels against the plain fast versions
# in the kernels' row slices (same weights, batch and drop-path masks): each
# block's kernel-vs-plain difference (1e-8 to 6.5e-5 relative L2 at (a)'s
# inputs on an H100) enters the next block, whose bf16 staging rounds it
# again, so the model reads more than one kernel: logits 1.73e-4, step-1
# gradients 3.4e-3 all together (on an H100; the kernels are deterministic,
# so a reading repeats from run to run). The gates sit at 1.5-2x those
# readings, below the fp32 kernels' 5.8e-4 and 7.2e-3 (controls, which must
# fail them). Each parameter's gradient within FAST_STEP_GRAD_REL_L2
# relative L2 (+ GRAD_FLOOR per entry) checks the wiring, not the rounding:
# a bias's gradient sums tens of thousands of terms that cancel, so its
# relative L2 carries their flips (1.15e-2 at most), as the fp32 kernels'
# (1.9e-2).
FAST_LOGITS_REL_L2 = 3e-4
FAST_STEP_GRAD_REL_L2, FAST_STEP_ALL_REL_L2 = 3e-2, 5e-3
# Phase 15 (f), the fast Swin3D model the same way: its logits read
# 2.12e-4 (fp32 kernels 6.79e-4) and are held to FAST_LOGITS_REL_L2; its
# step-1 gradients read 4.96e-3 to 5.02e-3 in three runs on an H100, at
# FAST_STEP_ALL_REL_L2 itself, with the fp32 kernels' step at 8.42e-3, so
# its gate sits between the two (their geometric mean), and the control
# must fail it
FAST_SWIN_STEP_ALL_REL_L2 = 6.5e-3
# phases 2-13 run the fp32 kernels, whatever the YAML selects, so that their
# gates and times stay comparable with the runs before the fast forms
FP32 = dict(rpe_precision="highest", qk_precision="highest")
HIGHEST = [x for item in FP32.items() for x in item]   # as YAML overrides
PIN_NOTE = ("rpe_precision/qk_precision pinned to highest: the fp32 "
            "kernels (the YAML's fast forms run in phase 14)")
# the DCF step's L1 offset loss before any update: the mean over ~3e5
# terms |shift - target| of two fp32 forwards within LOGIT_RTOL of each
# other, so equal to ~1e-5
OFFSET_LOSS_RTOL = 1e-4
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
# phase 13: the DCF family (configs/dcf_stratified.yaml) on fabricated cube
# scenes, since the fork's cube files are not in the repository: files of 12
# cuboids of 5000 samples in a 6 m room (about 60000 points); 8 files per
# loader batch of the YAML's shape (n_pad 140032, 8 slots), of which the
# scenes that fit are kept; 24 train files give (a)'s 3 batches and (b)'s 3
# steps, 2 test files its validation
DCF_CONFIG = os.path.join(REPO, "configs", "dcf_stratified.yaml")
DCF_SCENE = dict(cubes=12, points_per_cube=5000, extent=6.0)
DCF_TRAIN_FILES, DCF_TEST_FILES = 24, 2
DCF_LOOP_OVERRIDES = ["epochs", "1", "evaluate", "True", "print_freq", "1",
                      "use_tensorboard", "False", "n_devices", "1"]
# (c): test_iou.py's operating point (batch_size_test 4 x voxel_max 80000 =
# n_pad 320000) on one scene of 40 cuboids in 6 m (about 200000 points)
DCF_IOU_SCENE = dict(cubes=40, points_per_cube=5000, extent=6.0)
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
# the bf16 forms of the four attention kernels (their sources' `_bf16`
# entry points), by report name
FAST = "_bf16"
FAST_KERNELS = tuple(n + FAST for n in FWD_KERNELS + BWD_KERNELS)
PROBE_KERNELS = ("bin_math_probe", "cache_key_probe")


def log(msg):
    print(msg, flush=True)


def yaml_fp32(path):
    """The YAML config at ``path`` with its precisions pinned to "highest"
    (phases 2-13: `PIN_NOTE`)."""
    from stratified_transformer_torch.utils.config import (
        load_cfg, merge_cfg_from_list)
    return merge_cfg_from_list(load_cfg(path), HIGHEST)


# the six faces of a cuboid as (axis, side), in the DCF face-label order:
# opposite faces 0/5, 1/4 and 2/3, as ``LOOKUP_FACE``'s edges imply
CUBE_FACES = ((2, -1), (0, -1), (1, -1), (1, 1), (0, 1), (2, 1))


def cube_scene(rng, cubes, points_per_cube, extent):
    """A DCF scene file's cube dicts (the format the ``DCF`` reader and
    ``tests/test_driver_smokes.py::_make_dcf`` use): ``cubes`` random
    cuboids (sides 0.3-1.2 m) in a room of ``extent`` (at least 1.4) metres,
    each sampled
    on its six faces (labels 0-5, 80% of the points) and twelve edges
    (labels 6-17, ``instantiation.LOOKUP_FACE``'s pairs), each sample's
    offset target pointing to the centre of its face or edge. A stand-in
    for the fork's cube files, which are not in the repository."""
    from stratified_transformer_torch.eval.instantiation import LOOKUP_FACE
    n_face = max(int(0.8 * points_per_cube / 6), 1)
    n_edge = max(int(0.2 * points_per_cube / 12), 1)
    items = []
    for _ in range(cubes):
        size = rng.uniform(0.3, 1.2, 3)
        centre = np.concatenate([rng.uniform(size[:2] / 2 + 0.1,
                                             extent - size[:2] / 2 - 0.1),
                                 [size[2] / 2 + rng.uniform(0.0, 1.0)]])
        lo, hi = centre - size / 2, centre + size / 2

        def samples(n, fixed):
            """``n`` points uniform over the cube with the (axis, side)
            pairs of ``fixed`` held on the cube's surface, and the offsets
            to their centre."""
            pts = rng.uniform(lo, hi, (n, 3))
            mid = centre.copy()
            for axis, side in fixed:
                pts[:, axis] = mid[axis] = centre[axis] + side * size[axis] / 2
            return pts, mid - pts

        faces = [samples(n_face, [f]) for f in CUBE_FACES]
        edges = [samples(n_edge, [CUBE_FACES[a], CUBE_FACES[b]])
                 for a, b in LOOKUP_FACE]
        items.append(dict(
            f_samples=np.concatenate([p for p, _ in faces]),
            e_samples=np.concatenate([p for p, _ in edges]),
            f_labels=np.repeat(np.arange(6), n_face),
            e_labels=np.repeat(np.arange(6, 18), n_edge),
            f_offsets=np.concatenate([o for _, o in faces]),
            e_offsets=np.concatenate([o for _, o in edges]),
            centroid=centre, lengths=size))
    return np.asarray(items, dtype=object)


def write_cube_files(root, split, scenes, seed, **kw):
    """``scenes`` files ``<root>/<split>/cube_<i>.npy`` of `cube_scene`
    (``kw``), drawn from one generator seeded ``seed``; returns their
    paths."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, split), exist_ok=True)
    paths = []
    for i in range(scenes):
        paths.append(os.path.join(root, split, f"cube_{i:03d}.npy"))
        np.save(paths[-1], cube_scene(rng, **kw), allow_pickle=True)
    return paths


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
    level without a transformer stage (the ScanNet family's stem level) or
    a model without stratified keys (Swin3D) has no member mask (None)."""
    pyr = hb["pyramid"]
    xyz, off = hb["xyz"], hb["offsets"]
    out = []
    for i in range(cfg.num_layers):
        out.append((xyz, off, pyr["stage_down"][i - cfg.layer_start][
            "is_down"] if i >= cfg.layer_start and cfg.use_stratified
            else None))
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
        is_down=None if is_down is None else torch.from_numpy(is_down).to(
            device),
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
            if plan.sparse_band is not None:
                far += blocks * sparse_pairs(plan, cfg.s_band, cfg.tile)[0]
        valid = int(levels[i][1][-1])
        parts.append(f"stage {i}: {valid} points, band {band}, sparse {far}")
    log(f"[pairs] {label}: " + "; ".join(parts))


def _table_ops(per_pair, pairs, nb, d, rows):
    """(products, other operations) of one table term at the cheaper of its
    per-pair form and its projection form (`least_ops`)."""
    if per_pair * pairs <= 6 * nb * d * rows + 3 * pairs:
        return per_pair * pairs, 0
    return 6 * nb * d * rows, 3 * pairs


# operations of one pair's bins on its three axes, shared by the heads: the
# stratified bins (round to 1e-5, offset, scale, floor, clip, slice shift)
# and Swin3D's (difference, round, offset, clip)
BIN_OPS = {"stratified": 24, "swin_window": 15}


def least_ops(pairs, n_q, n_k, h, d, nb, split=False, bin_ops=24):
    """Least operations of one attention call with cRPE tables on q, k and
    v over ``pairs`` unmasked pairs, ``n_q`` valid queries and ``n_k``
    valid keys, ``nb`` table rows per axis; with ``split``, as ``(products,
    other)``: the products are those the TPU kernel contracts (bf16
    operands in the fast form), the rest fp32. Per pair and head: q·k (2d) and p·v (2d)
    products, the online-softmax update (~5). Per pair, shared by the
    heads: the three axes' bin arithmetic (~24). Per table and head, the
    cheaper of its per-pair form (three d-long dot products for Tq and Tk,
    three d-long adds for Tv) and the TPU kernel's form: each query (Tq),
    key (Tk) or row's bin mass (Tv) projected once onto all 3·nb table rows
    (2d each), then 3 lookups or mass adds per pair. ``bin_ops``: a pair's
    bins (`BIN_OPS`)."""
    parts = [(4 * d * pairs, 5 * pairs),
             _table_ops(6 * d, pairs, nb, d, n_q),
             _table_ops(6 * d, pairs, nb, d, n_k),
             _table_ops(3 * d, pairs, nb, d, n_q)]
    ops = (h * sum(p for p, _ in parts),
           h * sum(o for _, o in parts) + bin_ops * pairs)
    return ops if split else sum(ops)


def least_ops_bwd(pairs, n_q, n_k, h, d, nb, split=False, bin_ops=24):
    """Least operations of one backward call (both table sets present) over
    ``pairs`` unmasked pairs, ``n_q`` valid queries, ``n_k`` valid keys,
    ``nb`` table rows per axis (with ``split`` as ``(products, other)``,
    `least_ops`). Per
    pair and head: the recomputed q·k (2d), g·v (2d), dq += dl k, dk += dl
    q, dv += r g (2d each) products; r and dl (~5). Per query and head: g·o
    (2d, fp32 in both forms). Per pair, shared by the heads: the bins (~24).
    Eight table terms, each at the cheaper of its per-pair form (three
    d-long dot products or axpys, 6d) and the projection form (3 lookups or
    mass adds per pair, then 6·nb·d per query or key): the logit's Tq
    (queries) and Tk (keys), gv's Tv (queries), dq's Tq (queries), dk's Tk
    (keys) and the grads dTq (queries), dTk (keys) and dTv (queries)."""
    parts = ([(10 * d * pairs, 5 * pairs + 2 * d * n_q)]
             + [_table_ops(6 * d, pairs, nb, d, n_q)] * 5
             + [_table_ops(6 * d, pairs, nb, d, n_k)] * 3)
    ops = (h * sum(p for p, _ in parts),
           h * sum(o for _, o in parts) + bin_ops * pairs)
    return ops if split else sum(ops)


def new_report(names):
    return {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "max_abs_err": 0.0, "bound_by": {}} for k in names}


def ops_seconds(ops):
    """Least seconds of ``ops`` operations: a number, all fp32 outside the
    tensor cores (the fp32 kernels); or ``(products, other)`` (the fast
    forms), the products at the bf16 tensor-core peak and the rest at the
    fp32 peak, on units that may run together."""
    if isinstance(ops, tuple):
        return max(ops[0] / PEAK_BF16, ops[1] / PEAK_FP32)
    return ops / PEAK_FP32


def add_timing(report, name, blocks, ms, plain_ms, t_bytes, t_ops, err):
    """Adds one plan's launch to the kernel's per-step sums in ``report``
    (``blocks`` launches of the step use this plan); ``t_ops`` as
    `ops_seconds` takes them. Returns (bound, bound_by)."""
    t_op = ops_seconds(t_ops)
    bound = max(t_bytes / PEAK_BYTES, t_op) * 1e3
    by = "bytes" if t_bytes / PEAK_BYTES >= t_op else "operations"
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


def attention_launches():
    """Launches so far of the four attention kernels (fp32 and bf16 entry
    points), by source: the count the wrappers keep."""
    return {k: m_.KERNEL.launches + m_.KERNEL_FAST.launches
            for k, m_ in attention_kernel_modules().items()}


def device_kernels(fn, reps=1):
    """``reps`` profiled calls of ``fn`` in one session: their wall time (ms,
    profiler on) and ``{name: (device ms, count)}`` of the device kernels
    and copies they ran.

    On the H100 machine the profiler loses all or part of a session's
    device records once the card has idled (PERF.md §6), so every
    session is held complete or fails: it holds one record of an attention
    kernel for each launch that kernel's wrapper counted in it, each kernel
    ``reps`` times over (the calls run the same kernels), and some device
    time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    before = attention_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
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
    launched = {k: v - before[k] for k, v in attention_launches().items()}
    recorded = {k: sum(c for name, (_, c) in by_name.items()
                       if f"stratified::{k}_kernel<" in name)
                for k in launched}
    uneven = {n: c for n, (_, c) in by_name.items() if c % reps}
    if (recorded != launched or uneven
            or not sum(ms for ms, _ in by_name.values()) > 0):
        raise AssertionError(
            f"the profiler lost device records of {reps} call(s): attention "
            f"kernels launched {launched}, recorded {recorded}; kernels not "
            f"a multiple of {reps} times: {len(uneven)}")
    return wall_ms, by_name


def profiled_busy_ms(fn, reps):
    """Device time of ``fn()`` per call from the profiler, summed over the
    device kernels and copies of ``reps`` profiled calls after one warm-up
    (for calls that wait for the card, which `device_busy_ms` cannot
    take); `device_kernels` fails an incomplete session."""
    fn()
    by_name = device_kernels(fn, reps)[1]
    return sum(ms for ms, _ in by_name.values()) / reps


# the sleep kernel that `device_busy_ms` queues calls behind, in cycles of
# the card's clock (~50 ms on the H100): longer than the host takes to
# enqueue the calls it times
SLEEP_CYCLES = int(1e8)


def device_busy_ms(fn, reps):
    """Device time of ``fn()`` per call without the card's idle gaps while
    the host dispatches: ``reps`` calls after one warm-up, queued behind a
    sleep kernel so that the card runs them back to back, timed by CUDA
    events from the sleep's end. Not the profiler: on the H100 machine its
    sessions lose their device records once the card has idled for tens of
    seconds (PERF.md §6). ``fn`` must not wait for the card. If the
    host has not enqueued the calls before the sleep ends, the sleep is
    doubled and the calls timed again (up to 3 times); a reading that is
    not positive fails."""
    fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()      # the card still sleeping
        torch.cuda.synchronize()
        if queued:
            busy = start.elapsed_time(end) / reps
            if not busy > 0:
                raise AssertionError(f"device time {busy} ms of {reps} "
                                     "calls that launch device work")
            return busy
        cycles *= 2
    raise AssertionError(f"the host did not enqueue {reps} calls within a "
                         f"sleep of {cycles // 2} cycles")


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


def rel_l2(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm().clamp_min(1e-30))


# phase 14's failed gates and controls: each is logged where it is found,
# and fast_phase raises at its end if any, so that one run shows them all
FAST_FAILURES = []


def fast_gate(label, err, gate, control=None):
    """A fast kernel's relative L2 ``err`` from its plain fast version must
    be within ``gate``, and ``control`` (the fp32 form's from the same plain
    fast version) beyond it; a failure is logged and kept in
    FAST_FAILURES."""
    bad = []
    if not err <= gate:
        bad.append(f"{label}: relative L2 {err:.3e} > {gate}")
    if control is not None and not control > gate:
        bad.append(f"{label}: the fp32 form's relative L2 {control:.3e} "
                   f"is within the gate {gate} (control)")
    for b in bad:
        log(f"[fast] FAILED {b}")
    FAST_FAILURES.extend(bad)


def check_fast_triple(label, got, want, fp32):
    """A fast kernel's triple against its plain fast version: acc within
    FAST_OUT_REL_L2 relative L2 and the fp32 form's acc ``fp32`` beyond it
    (`fast_gate`), m and den within RTOL / ATOL; returns (acc's relative
    L2, the fp32 form's, the max abs errors)."""
    err, control = rel_l2(got[0], want[0]), rel_l2(fp32[0], want[0])
    fast_gate(f"{label} acc", err, FAST_OUT_REL_L2, control)
    for tn, g, w in zip(("m", "den"), got[1:], want[1:]):
        assert_close(f"{label} {tn}", g, w, RTOL, ATOL)
    return err, control, [max_errors(g, w) for g, w in zip(got, want)]


def kernel_slice_rows(name, dev, nb, fast=True):
    """The rows per block of a backward kernel's fast form for tables of
    ``nb`` rows per axis (the plain fast versions' ``slice_rows``); None
    for the fp32 form, whose key masses are not rounded."""
    from stratified_transformer_torch.kernels import block_limits
    return block_limits(name, dev, nb, fast=True)[0] if fast else None


def fwd_phase(cfg, levels, plans, dev, report, fast=False, variants=None):
    """Phase 4: both forward kernels against their plain versions at every
    stage's plans, with random q/k/v and tables from seed 0. Adds each
    kernel's per-step times, bounds and errors to ``report``, and the public
    wrapper's device-busy time under ``wrapper_busy_ms``; returns one row
    per (kernel, stage, parity). ``fast`` (phase 14): the kernels' bf16
    forms against the plain fast versions (`check_fast_triple`), reported
    under ``<name>_bf16`` with the fp32 form's time on the same inputs
    (``fp32_ms``) beside the wrapper's device-busy time; the bound counts
    the bytes of the fp32 form's inputs, the function's as the model gives
    them, not the wrapper's bf16 copies. ``variants`` (``--fwd-phases``,
    with ``fast``): per-step times of each variant build's fast entry point
    on the same arguments, under ``variants`` (`build_variants`)."""
    from stratified_transformer_torch.kernels import band_attention as band_k
    from stratified_transformer_torch.kernels import (
        sparse_band_attention as sparse_k)
    from stratified_transformer_torch.ops import attention as plain
    gen = torch.Generator(device="cpu").manual_seed(0)
    suffix = FAST if fast else ""
    for name in FWD_KERNELS:
        report[name + suffix]["wrapper_busy_ms"] = 0.0
        if fast:
            report[name + suffix]["fp32_ms"] = 0.0
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
            bkw = dict(kw, band=band, tile=cfg.tile, fast=fast)
            skw = dict(kw, s_band=cfg.s_band, tile=cfg.tile, fast=fast)
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
                        band_k, lambda f: band_k.launch_args(
                            *pargs, **dict(bkw, fast=f)),
                        lambda f=fast: band_k.band_attention(
                            *pargs, **dict(bkw, fast=f)),
                        lambda: plain.band_attention_plain(*pargs, **bkw),
                        band_pairs(plan, band, cfg.tile), n_q, n_q, nb),
                    "sparse_band_attention": (
                        sparse_k, lambda f: sparse_k.launch_args(
                            q, k, v, sb, *tables, **dict(skw, fast=f)),
                        lambda f=fast: sparse_k.sparse_band_attention(
                            q, k, v, sb, *tables, **dict(skw, fast=f)),
                        lambda: plain.sparse_band_attention_plain(
                            q, k, v, sb, *tables, **skw),
                        s_pairs, s_q, s_k, nbf),
                }
                triples = {}
                for name, (mod, make_args, wrapper, plain_fn, pairs, nq, nk,
                           rows) in runs.items():
                    key = name + suffix
                    args, outs, inputs = make_args(fast)
                    got = wrapper()
                    want = plain_fn()
                    torch.cuda.synchronize()
                    triples[name] = (got, want)
                    label = f"{key} stage {i} shifted={shifted}"
                    if fast:
                        acc_l2, ctl, errs = check_fast_triple(
                            label, got, want, wrapper(False))
                        report[key]["out_rel_l2"] = max(
                            report[key].get("out_rel_l2", 0.0), acc_l2)
                        report[key]["fp32_out_rel_l2"] = min(
                            report[key].get("fp32_out_rel_l2", 1.0), ctl)
                    else:
                        for tn, g, w in zip(("acc", "m", "den"), got, want):
                            assert_close(f"{label} {tn}", g, w, RTOL, ATOL)
                        errs = [max_errors(g, w) for g, w in zip(got, want)]
                    kernel = mod.KERNEL_FAST if fast else mod.KERNEL
                    ms = cuda_time_ms(lambda: kernel(*args), 20)
                    # beside the kernel's time: the wrapper's device-busy
                    # time, and the fp32 form's on the same inputs (fast)
                    busy_ms = device_busy_ms(wrapper, 3)
                    report[key]["wrapper_busy_ms"] += blocks * busy_ms
                    timing = f"wrapper device busy {busy_ms:.4f} ms"
                    in_bytes = fwd_bytes(name, inputs, outs, sb)
                    if fast:
                        args32 = make_args(False)
                        fp32_ms = cuda_time_ms(
                            lambda: mod.KERNEL(*args32[0]), 20)
                        report[key]["fp32_ms"] += blocks * fp32_ms
                        timing = f"fp32 form {fp32_ms:.4f} ms, " + timing
                        in_bytes = fwd_bytes(name, args32[2], outs, sb)
                        for tag, fns in (variants or {}).items():
                            vr = report[key].setdefault("variants", {})
                            vr[tag] = vr.get(tag, 0.0) + blocks * cuda_time_ms(
                                lambda: fns[name](*args), 20)
                    plain_ms = cuda_time_ms(plain_fn, 3)
                    t_ops = least_ops(pairs, nq, nk, h, d, rows, split=fast)
                    bound, by = add_timing(report, key, blocks, ms,
                                           plain_ms, in_bytes, t_ops,
                                           max(e[0] for e in errs))
                    per_pair = sum(t_ops) if fast else t_ops
                    rows_out.append(dict({
                        "kernel": key, "stage": i, "shifted": int(shifted),
                        "blocks": blocks, "n": n, "h": h, "pairs": pairs,
                        "ops_per_pair_head": per_pair / max(pairs, 1) / h,
                        "ms": ms, "wrapper_busy_ms": busy_ms,
                        "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": by}, **({"fp32_ms": fp32_ms} if fast
                                            else {})))
                    log(f"[kernel] {key} stage {i} shifted={int(shifted)} "
                        f"N={n} h={h} d={d} pairs={pairs} "
                        f"ops/pair/head={per_pair / max(pairs, 1) / h:.1f}: "
                        f"{ms:.4f} ms ({timing}"
                        + f"; plain {plain_ms:.3f} ms, bound {bound:.4f} ms "
                        f"by {by}); "
                        + (f"acc relative L2 {acc_l2:.2e} (fp32 form "
                           f"{ctl:.2e}), " if fast else "")
                        + f"max abs/rel err acc {errs[0][0]:.2e}/"
                        f"{errs[0][1]:.2e} m {errs[1][0]:.2e}/{errs[1][1]:.2e}"
                        f" den {errs[2][0]:.2e}/{errs[2][1]:.2e}")
                out_k = plain.merge([triples[n_][0] for n_ in FWD_KERNELS])[0]
                out_p = plain.merge([triples[n_][1] for n_ in FWD_KERNELS])[0]
                if fast:
                    fast_gate(f"merged fast output stage {i}",
                              rel_l2(out_k, out_p), FAST_OUT_REL_L2)
                else:
                    assert_close(f"merged stage {i}", out_k, out_p, RTOL,
                                 ATOL)
                e = max_errors(out_k, out_p)
                log(f"[kernel] merged output{' (fast)' if fast else ''} "
                    f"stage {i} shifted={int(shifted)}: max abs/rel err "
                    f"{e[0]:.2e}/{e[1]:.2e}")
    log("[kernel] library_ms: null for both kernels — no single PyTorch call "
        "computes attention with per-pair cRPE table terms on q, k and v "
        "(scaled_dot_product_attention takes one additive bias and no value "
        "term)")
    for name in FWD_KERNELS:
        r = report[name + suffix]
        log(f"[kernel] {name + suffix}: {r['ms']:.3f} ms per eval forward ("
            + (f"fp32 form {r['fp32_ms']:.3f} ms, " if fast else "")
            + f"wrapper device busy {r['wrapper_busy_ms']:.3f} ms"
            + f"; bound {r['bound_ms']:.3f} ms)")
    return rows_out


def bwd_phase(cfg, levels, plans, dev, report, fast=False, variants=None):
    """Phase 7: both backward kernels against their plain versions at every
    stage's plans, with random q/k/v/g and tables from seed 0 and the merged
    forward residuals of the plain versions. Adds each kernel's per-step
    times, bounds and errors to ``report``, and the public wrapper's time
    under ``wrapper_ms``. ``fast`` (phase 14): the bf16 forms against the
    plain fast versions, every gradient within FAST_GRAD_REL_L2 relative
    L2, reported under ``<name>_bf16`` with the fp32 form's time on the
    same inputs (``fp32_ms``) and no wrapper timing; the bound counts the
    bytes of the fp32 form's inputs, the function's as the model gives
    them. ``variants`` (``--bwd-phases``, with ``fast``): per-step times of
    each variant build's fast entry point on the same arguments, under
    ``variants`` (`build_variants`)."""
    from stratified_transformer_torch.kernels import (
        band_attention_bwd as band_bwd_k)
    from stratified_transformer_torch.kernels import (
        sparse_band_attention_bwd as sparse_bwd_k)
    from stratified_transformer_torch.ops import attention as plain
    gen = torch.Generator(device="cpu").manual_seed(0)
    grad_names = ("dq", "dk", "dv", "dtq", "dtk", "dtv")
    suffix = FAST if fast else ""
    for name in BWD_KERNELS:
        r = report[name + suffix]
        if fast:
            r["fp32_ms"] = 0.0
        else:
            r["wrapper_ms"] = r["wrapper_busy_ms"] = 0.0
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
            bkw = dict(kw, band=band, tile=cfg.tile, fast=fast)
            skw = dict(kw, s_band=cfg.s_band, tile=cfg.tile, fast=fast)
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
                # the fast plain versions sum the key masses over the
                # kernels' row slices (ROADMAP.md section 3)
                band_rows, sparse_rows = (
                    kernel_slice_rows(name, dev, nb_, fast)
                    for name, nb_ in zip(BWD_KERNELS, (nb, nbf)))
                runs = {
                    "band_attention_bwd": (
                        band_bwd_k, lambda f: band_bwd_k.launch_args(
                            q, k, v, *geom, *res, *tables,
                            **dict(bkw, fast=f)),
                        lambda f=fast: band_bwd_k.band_attention_bwd(
                            q, k, v, *geom, *res, *tables,
                            **dict(bkw, fast=f)),
                        lambda: plain.band_attention_bwd_plain(
                            q, k, v, *geom, *res, *tables, **bkw,
                            slice_rows=band_rows),
                        band_pairs(plan, band, cfg.tile), n_q, n_q, nb),
                    "sparse_band_attention_bwd": (
                        sparse_bwd_k, lambda f: sparse_bwd_k.launch_args(
                            q, k, v, sb, *res, *tables, **dict(skw, fast=f)),
                        lambda f=fast: sparse_bwd_k.sparse_band_attention_bwd(
                            q, k, v, sb, *res, *tables, **dict(skw, fast=f)),
                        lambda: plain.sparse_band_attention_bwd_plain(
                            q, k, v, sb, *res, *tables, **skw,
                            slice_rows=sparse_rows),
                        s_pairs, s_q, s_k, nbf),
                }
                for name, (mod, make_args, wrapper, plain_fn, pairs, nq, nk,
                           rows) in runs.items():
                    key = name + suffix
                    args, outs, inputs = make_args(fast)
                    got = wrapper()
                    want = plain_fn()
                    torch.cuda.synchronize()
                    label = f"{key} stage {i} shifted={int(shifted)}"
                    if fast:
                        errs, l2s, ctls = [], [], []
                        for gn, a, b, c in zip(grad_names, got, want,
                                               wrapper(False)):
                            l2s.append(rel_l2(a, b))
                            ctls.append(rel_l2(c, b))
                            fast_gate(f"{label} {gn}", l2s[-1],
                                      FAST_GRAD_REL_L2, ctls[-1])
                            errs.append(float((a - b).abs().max()))
                        report[key]["grad_rel_l2"] = max(
                            report[key].get("grad_rel_l2", 0.0), *l2s)
                        report[key]["fp32_grad_rel_l2"] = min(
                            report[key].get("fp32_grad_rel_l2", 1.0), *ctls)
                    else:
                        errs = [grads_close(f"{label} {gn}", a, b)
                                for gn, a, b in zip(grad_names, got, want)]
                    kernel = mod.KERNEL_FAST if fast else mod.KERNEL
                    ms = cuda_time_ms(lambda: kernel(*args), 10)
                    in_bytes = nbytes(inputs)
                    if fast:
                        args32 = make_args(False)
                        fp32_ms = cuda_time_ms(
                            lambda: mod.KERNEL(*args32[0]), 10)
                        report[key]["fp32_ms"] += blocks * fp32_ms
                        timing = f"fp32 form {fp32_ms:.4f} ms"
                        in_bytes = nbytes(args32[2])
                        for tag, fns in (variants or {}).items():
                            vr = report[key].setdefault("variants", {})
                            vr[tag] = vr.get(tag, 0.0) + blocks * cuda_time_ms(
                                lambda: fns[name](*args), 10)
                    else:
                        wrapper_ms = cuda_time_ms(wrapper, 10)
                        busy_ms = device_busy_ms(wrapper, 3)
                        report[key]["wrapper_ms"] += blocks * wrapper_ms
                        report[key]["wrapper_busy_ms"] += blocks * busy_ms
                        timing = (f"wrapper {wrapper_ms:.4f} ms, device busy "
                                  f"{busy_ms:.4f} ms")
                    plain_ms = cuda_time_ms(plain_fn, 2)
                    # the function's bytes: its inputs (as the kernel takes
                    # them) read once, the six grads written once
                    t_ops = least_ops_bwd(pairs, nq, nk, h, d, rows,
                                          split=fast)
                    bound, by = add_timing(report, key, blocks, ms,
                                           plain_ms,
                                           in_bytes + nbytes(got),
                                           t_ops, max(errs))
                    per_pair = sum(t_ops) if fast else t_ops
                    log(f"[bwd] {key} stage {i} shifted={int(shifted)} "
                        f"N={n} h={h} d={d} pairs={pairs} "
                        f"ops/pair/head={per_pair / pairs / h:.1f}: "
                        f"{ms:.4f} ms ({timing}; plain {plain_ms:.3f} ms, "
                        f"bound {bound:.4f} ms by {by}); dk/dv partials "
                        f"{nbytes(outs[1:3]) / 2 ** 20:.0f} MiB; "
                        + ("relative L2 " + " ".join(
                            f"{gn} {e:.2e}" for gn, e in zip(grad_names, l2s))
                           + " (fp32 form " + " ".join(
                            f"{e:.2e}" for e in ctls) + "); "
                           if fast else "")
                        + "max abs err "
                        + " ".join(f"{gn} {e:.2e}"
                                   for gn, e in zip(grad_names, errs))
                        + " (of max |grad| "
                        + " ".join(f"{float(w.abs().max()):.2e}"
                                   for w in want) + ")")
    log("[bwd] library_ms: null for both backward kernels — no single "
        "PyTorch call computes the gradients of attention with per-pair cRPE "
        "table terms on q, k and v")
    for name in BWD_KERNELS:
        r = report[name + suffix]
        log(f"[bwd] {name + suffix}: {r['ms']:.3f} ms per train step ("
            + (f"fp32 form {r['fp32_ms']:.3f} ms" if fast else
               f"wrapper {r['wrapper_ms']:.3f} ms, of which the device is "
               f"busy {r['wrapper_busy_ms']:.3f} ms")
            + f"; bound {r['bound_ms']:.3f} ms)")


# ``--bwd-phases``: where the fast backward kernels' time goes. Each
# variant is a build of the backward sources with phases of the fast
# form's block routine cut out: a cut replaces the opening line of a
# phase (file, text, replacement) so that its body never runs; the
# difference of a variant's time from the kernel's is that phase's share
# (the later phases then read stale shared memory: times only). Cuts of
# attention_bwd_common.cuh split the routine the fast forms ran before the
# tensor-core routine (attention_bwd_block at kFast), those of
# attention_bwd_tc.cuh that routine; a cut whose text a checkout lacks is
# skipped and logged.
TC = "attention_bwd_tc.cuh"
BWD_PHASE_CUTS = {
    "1 key projections": [
        ("attention_bwd_common.cuh",
         "    if (tabs && (tid & (C - 1)) < cn) {", "    if (false) {"),
        (TC, "  auto key_projections = [&](int b) {\n",
         "  auto key_projections = [&](int b) {\n    return;\n")],
    "2 pairs": [
        ("attention_bwd_common.cuh",
         "    for (int j = jlo + sub; j < jhi; j += LPR) {",
         "    for (int j = jhi; j < jhi; j += LPR) {"),
        (TC, "        if (jlo < key0 + 8 && jhi > key0) {",
         "        if (false) {")],
    "2 row masses": [
        ("attention_bwd_common.cuh",
         "    if (tabs && sub < 3 && row_ok) {", "    if (false) {"),
        (TC, "        for (int j = j0; j < j1; j += 8) {",
         "        for (int j = j1; j < j1; j += 8) {")],
    "3 key sums and Mk": [
        ("attention_bwd_common.cuh",
         "    if (kj < cn && (sums || (tabs && kq < 3))) {",
         "    if (false) {"),
        (TC, "        if (kj < s_act[mt][0] || kj >= s_act[mt][1]) "
             "continue;", "        continue;")],
    "4 Mk.Tk and Mk^T.k": [
        ("attention_bwd_common.cuh",
         "    if (tabs) {\n      const int j8",
         "    if (false) {\n      const int j8"),
        (TC, "      if (is_dk && tabs) {", "      if (false) {"),
        (TC, "      if (!is_dk && tabs) {", "      if (false) {")],
    "end of block": [
        ("attention_bwd_common.cuh",
         "    for (int ab = sub; ab < nb3; ab += LPR) {",
         "    for (int ab = nb3; ab < nb3; ab += LPR) {"),
        ("attention_bwd_common.cuh",
         "      for (int tt = 0; tt < R; ++tt) {\n        const float2 mv",
         "      for (int tt = R; tt < R; ++tt) {\n        const float2 mv"),
        (TC, "    if (tabs) {                               // two chains",
         "    if (false) {                              // two chains"),
        (TC, "    if ((tmask >> at) & 1u) {", "    if (false) {")],
}


def build_variants(tmp, phase_cuts, kernels, flag):
    """Variant libraries of the ``kernels``' sources, one per entry of
    ``phase_cuts`` (`BWD_PHASE_CUTS`, `FWD_PHASE_CUTS`) and one with every
    cut ("all"), built in parallel under ``tmp``; returns ``{variant:
    {kernel name: fast entry point}}`` (each entry point raises on a failed
    launch). ``flag`` labels the log lines."""
    import ctypes
    import shutil
    from stratified_transformer_torch.kernels import build
    mods = attention_kernel_modules()
    cuts = dict(phase_cuts)
    cuts["all"] = [c for v in phase_cuts.values() for c in v]
    jobs = []
    for v, (tag, spec) in enumerate(cuts.items()):
        src = os.path.join(tmp, f"v{v}")
        shutil.copytree(build.CSRC, src)
        for fn, old, new in spec:
            path = os.path.join(src, fn)
            text = open(path).read() if os.path.exists(path) else ""
            if text.count(old) != 1:
                log(f"[{flag}] {tag}: cut {old.strip()[:40]!r} not in "
                    f"{fn}, skipped")
                continue
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        for name in kernels:
            out = os.path.join(src, f"lib{name}.so")
            jobs.append((tag, name, out, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", out,
                 os.path.join(src, f"{name}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    variants = {}
    for tag, name, out, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {tag} of {name}.cu:\n{text}")
        fn = getattr(ctypes.CDLL(out), mods[name].KERNEL_FAST.symbol)
        fn.argtypes = mods[name].KERNEL_FAST.argtypes
        fn.restype = ctypes.c_int

        def call(*args, fn=fn, tag=tag):
            rc = fn(*args)
            if rc != 0:
                raise RuntimeError(f"variant {tag}: cudaError_t {rc}")
        variants.setdefault(tag, {})[name] = call
    return variants


def kernel_phases(dev, flag, phase_cuts, kernels, phase_fn):
    """``--bwd-phases`` / ``--fwd-phases``: the fast forms of ``kernels`` at
    phase 14 (a)'s S3DIS plans and (c)'s ScanNet plans (``phase_fn``,
    `bwd_phase` or `fwd_phase`, with ``fast``, gates included), each beside
    its variant builds without one phase (`build_variants` of
    ``phase_cuts``); per-step ms of the kernel and of each variant, and
    each phase's share (the kernel's time less the variant's)."""
    import tempfile
    from stratified_transformer_torch.config import load_config
    from stratified_transformer_torch.data.loader import host_batch
    FAST_FAILURES.clear()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        variants = build_variants(tmp, phase_cuts, kernels, flag)
        log(f"[{flag}] {len(variants)} variants built in "
            f"{time.time() - t0:.1f} s")
        out = {}
        for tag, path, hb_kw, cfg_kw in (
                ("s3dis", CONFIG, {}, dict(n_pad=N_PAD, num_scenes=SCENES)),
                ("scannet", SCANNET_CONFIG, SCANNET_ROOMS, {})):
            cfg = load_config(path, **cfg_kw)
            hb = host_batch(cfg, seed=0, **hb_kw)
            levels = stage_levels(cfg, hb)
            plans = {(i, sh): build_plan(cfg, i, levels[i], sh, dev)
                     for i in stages(cfg) for sh in (False, True)}
            report = new_report(FAST_KERNELS)
            phase_fn(cfg, levels, plans, dev, report, fast=True,
                     variants=variants)
            out[tag] = {}
            for name in kernels:
                r = report[name + FAST]
                out[tag][name + FAST] = {
                    "ms": r["ms"], "fp32_ms": r["fp32_ms"],
                    "bound_ms": r["bound_ms"], "variants": r["variants"],
                    "phase_ms": {v: r["ms"] - t
                                 for v, t in r["variants"].items()}}
                log(f"[{flag}] {tag} {name}{FAST}: {r['ms']:.3f} ms per "
                    "step; without " + ", ".join(
                        f"{v}: {t:.3f} ({r['ms'] - t:+.3f})"
                        for v, t in r["variants"].items()))
            del plans
    if FAST_FAILURES:
        raise AssertionError(f"--{flag}: {len(FAST_FAILURES)} gates or "
                             f"controls failed: {FAST_FAILURES}")
    return out


def bwd_phases(dev):
    """``--bwd-phases``: `kernel_phases` of the fast backward kernels."""
    return kernel_phases(dev, "bwd-phases", BWD_PHASE_CUTS, BWD_KERNELS,
                         bwd_phase)


# ``--fwd-phases``: where the fast forward kernels' time goes, as
# ``--bwd-phases`` splits the backward's. Cuts of attention_fwd_common.cuh
# split the routine the fast forms ran before the tensor-core routine
# (attention_fwd_block at kFast), those of attention_fwd_tc.cuh that
# routine. "key staging" cuts the loads of k and v (the keys' points and
# skey stay, so the variant keeps the kernel's pairs); "projections" the
# tables' staging (Tq, Tk; the old far-key form's three tables) and the
# projections; "pass 1" the products and cRPE lookups of the logits (the
# masks stay); "pass 2" the exp and p·v (p is 1 on the pairs, so the walk
# still runs); "mass walk" the walk; "end of block" mass·Tv (with the old
# routine's Tv reads) and the old
# routine's lane reductions (the writes stay, or the compiler would drop
# the whole block).
FWD_TC = "attention_fwd_tc.cuh"
FWD_OLD = "attention_fwd_common.cuh"
FWD_PHASE_CUTS = {
    "key staging": [
        (FWD_OLD, "    for (int i0 = tid; i0 < cn * D; i0 += 2 * NT) {",
         "    for (int i0 = cn * D; i0 < cn * D; i0 += 2 * NT) {"),
        (FWD_TC, "    if (ksrc >= 0)\n      kvr = ",
         "    if (false)\n      kvr = ")],
    "projections": [
        (FWD_OLD, "    if (tabs) project_mma<D, S>(s_q, R / 16,",
         "    if (false) project_mma<D, S>(s_q, R / 16,"),
        (FWD_OLD, "      if (tabs) project_mma<D, S>(s_k, C / 16,",
         "      if (false) project_mma<D, S>(s_k, C / 16,"),
        (FWD_OLD, "  if (!kProj && tabs) {\n    // a thread per (table, bin)",
         "  if (false) {\n    // a thread per (table, bin)"),
        (FWD_TC, "    for (int i = tid; i < 3 * nb; i += NT) {",
         "    for (int i = 3 * nb; i < 3 * nb; i += NT) {"),
        (FWD_TC, "  if (tabs && lo < hi)\n    project(a_q,",
         "  if (false)\n    project(a_q,"),
        (FWD_TC, "    if (tabs)\n      project(a_k,",
         "    if (false)\n      project(a_k,")],
    "pass 1": [
        (FWD_OLD, "#pragma unroll\n          for (int c = 0; c < D; c += 4) "
                  "lds4(s_k + j * S + c, kc + c);\n          float s = 0.0f;\n"
                  "#pragma unroll\n          for (int c = 0; c < D; ++c) "
                  "s = fmaf(q[c], kc[c], s);\n          if (tabs) {",
         "          float s = 0.0f;\n          if (false) {"),
        (FWD_TC, "          mma_bf16_16816(sc, qa, b);", ""),
        (FWD_TC, "              if (tabs) {\n                const float xkk[3]",
         "              if (false) {\n                const float xkk[3]")],
    "rescale": [
        (FWD_OLD, "    if (mx > m) {\n      const float r = expf(m - mx);",
         "    if (mx > m) m = mx;\n    if (false) {\n"
         "      const float r = expf(m - mx);"),
        (FWD_TC, "    if (mx > rm) {\n      const float r = expf(rm - mx);",
         "    if (mx > rm) mref = rm = mx;\n    if (false) {\n"
         "      const float r = expf(rm - mx);")],
    "pass 2": [
        (FWD_OLD, "      if (j < rhi && ((ok >> u) & 1u)) {\n"
                  "        p = expf(l[u] - m);",
         "      p = ((ok >> u) & 1u) ? 1.0f : 0.0f;\n      if (false) {\n"
         "        p = expf(l[u] - m);"),
        (FWD_TC, "? expf(l[nt][e] - rm) : 0.0f;", "? 1.0f : 0.0f;"),
        (FWD_TC, "        mma_bf16_16816(d, pa, b);", "")],
    "mass walk": [
        (FWD_OLD, "    if (kMass && tabs) {\n      // the row's masses",
         "    if (false) {\n      // the row's masses"),
        (FWD_TC, "    if (tabs) {\n#pragma unroll\n      for (int nt = 0; "
                 "nt < 4; ++nt) {\n        if (!act[nt]) continue;",
         "    if (false) {\n#pragma unroll\n      for (int nt = 0; "
         "nt < 4; ++nt) {\n        if (!act[nt]) continue;")],
    "end of block": [
        (FWD_OLD, "  if (!kProj && kMass && T.tv != nullptr) {",
         "  if (false) {"),
        (FWD_OLD, "  if (kProj && T.tv != nullptr) {", "  if (false) {"),
        (FWD_OLD, "#pragma unroll\n  for (int c = 0; c < D; ++c) acc[c] = "
                  "group_sum<LPR>(acc[c]);\n  den = group_sum<LPR>(den);\n",
         ""),
        (FWD_TC, "  if (tabs && lo < hi) {\n    __syncwarp();",
         "  if (false) {\n    __syncwarp();")],
}


def fwd_phases(dev):
    """``--fwd-phases``: `kernel_phases` of the fast forward kernels."""
    return kernel_phases(dev, "fwd-phases", FWD_PHASE_CUTS, FWD_KERNELS,
                         fwd_phase)


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
    yaml_cfg = yaml_fp32(yaml_path)
    cfg = eval_config(yaml_cfg)
    data_name = yaml_cfg["data_name"]
    coord, feat, _, _ = SyntheticRooms(num_scenes=1, seed=999, **(
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

    def counts():
        return {k: m_.KERNEL.launches for k, m_ in kernel_mods.items()}

    def reset():
        for m_ in kernel_mods.values():
            m_.KERNEL.launches = 0

    log(f"[scene] phase 10 / 12 (e): {PIN_NOTE}")
    geo_s = geometry_check(cfg, hb, dev, geometry)
    err = nopyramid_check(model, ref_model, hb, dev, counts, reset)
    scfg = eval_config(yaml_fp32(yaml_path))
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
                                 cfg.num_classes,
                                 float(yaml_cfg.get("offset_weight", 1.0)))
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
        losses, offset_losses, times, grads = [], [], [], None
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
            if not (bool(torch.isfinite(stats["loss"]))
                    and bool(torch.isfinite(stats["loss_offset"]))):
                raise AssertionError(f"non-finite loss at train step {step}")
            losses.append(float(stats["loss"]))
            offset_losses.append(float(stats["loss_offset"]))
            if step == 0:
                grads = {n_: p_.grad.clone()
                         for n_, p_ in m_.named_parameters()}
        return losses, offset_losses, times, grads

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
    losses_k, offsets_k, times_k, grads_k = run_steps(model_k, opt_k, True)
    launches = counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for step in range(len(batches)):
        log(f"{tag} step {step}: loss {losses_k[step]:.5f}, "
            f"{times_k[step]:.1f} ms (host clock, synchronized)")
    log(f"{tag} launches over {len(batches)} steps: {launches}; "
        f"max_memory_allocated {peak_mb:.0f} MiB")

    model_p, opt_p = trainer("reference")
    losses_p, offsets_p, times_p, grads_p = run_steps(model_p, opt_p, False)
    worst = check_grads("train step 1", grads_k, grads_p)
    log(f"{tag} step-1 grads of all {len(grads_p)} parameters within "
        f"{GRAD_REL_L2} relative L2 (+{GRAD_FLOOR}/entry) of the plain-version"
        f" step; largest relative L2 {worst[0]:.2e} ({worst[1]})")
    np.testing.assert_allclose(losses_k, losses_p, rtol=LOSS_RTOL,
                               err_msg="loss trajectory")
    # the offset loss (0 without the offset head): step 1's within
    # OFFSET_LOSS_RTOL, the trajectory as the loss's
    np.testing.assert_allclose(offsets_k[0], offsets_p[0],
                               rtol=OFFSET_LOSS_RTOL,
                               err_msg="step-1 offset loss")
    np.testing.assert_allclose(offsets_k, offsets_p, rtol=LOSS_RTOL,
                               err_msg="offset loss trajectory")
    log(f"{tag} loss trajectory kernels {losses_k} vs plain {losses_p}; "
        f"offset loss {offsets_k} vs {offsets_p}; "
        f"plain-version step median {float(np.median(times_p)):.1f} ms")
    step_ms = float(np.median(times_k))
    log(f"{tag} full-width train step median {step_ms:.1f} ms over "
        f"{len(batches)} steps")
    del model_p, opt_p, grads_p, grads_k
    wall, busy, by_name = profile_call(f"{tag[1:-1]} step", lambda: (
        train_step(model_k, opt_k, batches[0],
                   torch.Generator(device="cuda").manual_seed(2000))))
    return {"step_ms": step_ms, "step_ms_all": times_k, "losses": losses_k,
            "plain_losses": losses_p, "offset_losses": offsets_k,
            "plain_offset_losses": offsets_p, "launches": launches,
            "max_memory_allocated_mib": peak_mb,
            "grad_worst_rel_l2": worst[0], "grad_worst": worst[1],
            "profiled_wall_ms": wall, "profiled_busy_ms": busy,
            "profiled_kernels": by_name}


def run_loop(tag, loop_cfg, kernel_mods, blocks):
    """The training driver's loop (``train/driver.py::run``, the function
    its CLI runs) on the flattened YAML ``loop_cfg`` on the card, its lines
    logged with ``tag``; the kernels' launches read at each logged
    iteration and validation line must be one of each attention kernel per
    block and train step and one of each forward kernel per block and
    validation forward, none backward (`launch_deltas`), over at least one
    of each. Returns ``(model, summary, seconds)``."""
    from stratified_transformer_torch.train import driver
    marks = []

    def counts():
        return {k: m_.KERNEL.launches for k, m_ in kernel_mods.items()}

    def loop_log(msg):
        log(f"{tag} {msg[:400]}")
        if msg.startswith("Epoch ["):
            marks.append(("step", counts(), 0))
        elif msg.startswith("Val epoch"):
            marks.append(("val", counts(), None))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m_ in kernel_mods.values():
        m_.KERNEL.launches = 0
    t0 = time.perf_counter()
    model, summary = driver.run(loop_cfg, "cuda", log=loop_log)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    val_forwards = iter(t["val_forwards"] for t in summary["timing"])
    marks = [(kind, now, next(val_forwards) if kind == "val" else 0)
             for kind, now, _ in marks]
    steps, vals = launch_deltas(marks, kernel_mods, blocks)
    if (steps, vals) != (summary["steps"], summary["val_forwards"]) or not (
            steps and vals):
        raise AssertionError(f"logged {steps} steps and {vals} validation "
                             f"forwards, the loop took {summary['steps']} "
                             f"and {summary['val_forwards']}")
    return model, summary, seconds


def scannet_loop(dev, kernel_mods, blocks):
    """Phase 12 (d): the training driver's loop (``train/driver.py::run``)
    on the ScanNet YAML with SCANNET_LOOP_OVERRIDES: one launch of each
    attention kernel per block and train step, of each forward kernel per
    block and validation forward, finite losses, the audit of stages 1-4.
    Returns the loop's numbers."""
    import tempfile

    from stratified_transformer_torch.train import audit
    from stratified_transformer_torch.utils.config import merge_cfg_from_list
    with tempfile.TemporaryDirectory() as tmp:
        yaml_cfg = merge_cfg_from_list(
            yaml_fp32(SCANNET_CONFIG),
            SCANNET_LOOP_OVERRIDES + ["save_path", os.path.join(tmp, "run")])
        _, summary, loop_s = run_loop("[scannet] loop:", yaml_cfg,
                                      kernel_mods, blocks)
    steps, vals = summary["steps"], summary["val_forwards"]
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
           "launches": {k: m_.KERNEL.launches
                        for k, m_ in kernel_mods.items()}, "losses": losses,
           "step_wall_ms": [1e3 * r["wall_s"] for r in summary["iters"]],
           "valid_points": [r["points"] for r in summary["iters"]],
           "timing": summary["timing"], "audit": audited[-1]}
    log(f"[scannet] loop: {steps} steps and {vals} validation forwards in "
        f"{loop_s:.1f} s, launches {out['launches']} ({blocks} of each "
        f"kernel per step, {blocks} forward and 0 backward per validation "
        f"forward); losses {losses}; valid points {out['valid_points']}; "
        f"{audit.format_truncation(audited[-1])}")
    return out


def scannet_kernels(cfg, hb, dev):
    """Phase 12 (a) (``--scannet-kernels-only`` alone): the four attention
    kernels against their plain versions at every transformer stage's plans
    of the ScanNet batch ``hb`` (phases 4 and 7 at ScanNet's shapes);
    returns their report."""
    levels = stage_levels(cfg, hb)
    plans = {(i, sh): build_plan(cfg, i, levels[i], sh, dev)
             for i in stages(cfg) for sh in (False, True)}
    log_pairs("scannet batch 0", cfg, hb, dev)
    report = new_report(FWD_KERNELS + BWD_KERNELS)
    fwd_phase(cfg, levels, plans, dev, report)
    bwd_phase(cfg, levels, plans, dev, report)
    return report


def scannet_phase(dev, kernel_mods):
    """Phase 12: the ScanNet family at full width on its YAML's batch shape
    (module docstring). Returns the numbers of (a)-(e) and each attention
    kernel's report of (a) under ``report``."""
    from stratified_transformer_torch.config import load_config
    from stratified_transformer_torch.data.loader import host_batch, to_device
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.train.step import make_eval_step
    t_phase = time.time()
    log(f"[scannet] phase 12: {PIN_NOTE}")
    yaml_cfg = yaml_fp32(SCANNET_CONFIG)
    cfg = load_config(SCANNET_CONFIG, **FP32)
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
    out["report"] = scannet_kernels(cfg, hbs[0], dev)

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


def dcf_batches(yaml_cfg, cfg, count):
    """The first ``count`` loader batches of the DCF train files (dataset
    order)."""
    from stratified_transformer_torch.data.loader import (
        BatchLoader, build_dataset)
    itr = iter(BatchLoader(build_dataset(yaml_cfg, "train"), cfg, yaml_cfg,
                           shuffle=False))
    hbs = [next(itr) for _ in range(count)]
    itr.close()
    return hbs


def dcf_eval(cfg, yaml_cfg, hbs, model, ref_model, dev, kernel_mods):
    """Phase 13 (a), the forward: eval forwards of the batches ``hbs``
    through the kernels (one launch of each forward kernel per block, no
    backward), logits and offsets within LOGIT_RTOL / LOGIT_ATOL of the
    plain-version forward's; one profiled. Returns the numbers."""
    from stratified_transformer_torch.data.loader import to_device
    from stratified_transformer_torch.train.step import make_eval_step
    blocks = attention_blocks(cfg)
    eval_step = make_eval_step(int(yaml_cfg["ignore_label"]),
                               cfg.num_classes)
    batches = [to_device(hb, dev) for hb in hbs]
    eval_step(model, batches[0])                # first call: lazy set-up
    torch.cuda.synchronize()
    for m_ in kernel_mods.values():
        m_.KERNEL.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, outs = [], []
    for j, b in enumerate(batches):
        before = {k: m_.KERNEL.launches for k, m_ in kernel_mods.items()}
        t0 = time.perf_counter()
        logits, shift, stats = eval_step(model, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per = {k: m_.KERNEL.launches - before[k]
               for k, m_ in kernel_mods.items()}
        want = {k: blocks if k in FWD_KERNELS else 0 for k in per}
        if per != want:
            raise AssertionError(f"dcf forward {j} launches {per}, expected "
                                 f"{want}")
        if not (shift is not None and shift.shape == (cfg.n_pad, 3)
                and bool(torch.isfinite(logits).all())
                and bool(torch.isfinite(shift).all())
                and bool(torch.isfinite(stats["loss"]))):
            raise AssertionError("dcf forward: no offsets, or non-finite "
                                 "logits, offsets or loss")
        outs.append((logits, shift))
    launches = {k: m_.KERNEL.launches for k, m_ in kernel_mods.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    errs = []
    for j, b in enumerate(batches):
        logits_p, shift_p, _ = eval_step(ref_model, b)
        assert_close(f"dcf logits batch {j}", outs[j][0], logits_p,
                     LOGIT_RTOL, LOGIT_ATOL)
        assert_close(f"dcf offsets batch {j}", outs[j][1], shift_p,
                     LOGIT_RTOL, LOGIT_ATOL)
        errs.append((max_errors(outs[j][0], logits_p)[0],
                     max_errors(outs[j][1], shift_p)[0]))
    _, busy, _ = profile_call("dcf forward",
                              lambda: eval_step(model, batches[0]))
    out = {"forward_ms": times, "forward_ms_median": float(np.median(times)),
           "launches": launches, "max_memory_allocated_mib": peak,
           "profiled_busy_ms": busy,
           "logits_max_abs_err": [e[0] for e in errs],
           "shift_max_abs_err": [e[1] for e in errs]}
    log(f"[dcf] eval forward median {out['forward_ms_median']:.1f} ms "
        f"({', '.join(f'{t:.1f}' for t in times)}; host clock, "
        f"synchronized); launches over {len(batches)} forwards {launches}; "
        f"vs plain-version forward max abs err logits "
        f"{max(out['logits_max_abs_err']):.2e}, offsets "
        f"{max(out['shift_max_abs_err']):.2e}; max_memory_allocated "
        f"{peak:.0f} MiB; profiled device busy {busy:.2f} ms")
    return out


def dcf_loop(yaml_cfg, tmp, dev, kernel_mods, blocks):
    """Phase 13 (b): the training driver's loop on the cube files for one
    epoch with validation (one launch of each kernel per block and step, of
    each forward kernel per block and validation forward), ``loss_offset``
    finite in every iteration and in ``metrics.jsonl``; then the epoch's
    checkpoint restored into a fresh model gives bit-identical logits and
    offsets on a validation batch. Returns the loop's numbers."""
    from stratified_transformer_torch.config import from_cfg
    from stratified_transformer_torch.data.loader import (
        BatchLoader, build_dataset, to_device)
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.train import checkpoint
    from stratified_transformer_torch.train.step import make_eval_step
    from stratified_transformer_torch.utils.config import merge_cfg_from_list
    save = os.path.join(tmp, "run")
    loop_cfg = merge_cfg_from_list(yaml_cfg, DCF_LOOP_OVERRIDES + [
        "save_path", save])
    model, summary, loop_s = run_loop("[dcf] loop:", loop_cfg, kernel_mods,
                                      blocks)
    launches = {k: m_.KERNEL.launches for k, m_ in kernel_mods.items()}
    steps, vals = summary["steps"], summary["val_forwards"]
    with open(os.path.join(save, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    offsets = [r["loss_offset"] for r in summary["iters"]]
    if not (records and all("loss_offset" in r for r in records)
            and np.isfinite(offsets).all() and all(
                np.isfinite(v) for r in records for v in r.values())):
        raise AssertionError(f"loss_offset missing or non-finite: iterations"
                             f" {offsets}, metrics.jsonl {records}")
    cfg = from_cfg(loop_cfg)
    itr = iter(BatchLoader(build_dataset(loop_cfg, "val"), cfg, loop_cfg,
                           shuffle=False))
    vbatch = to_device(next(itr), dev)
    itr.close()
    eval_step = make_eval_step(int(loop_cfg["ignore_label"]), cfg.num_classes)
    model.eval()
    logits, shift, _ = eval_step(model, vbatch)
    fresh = build_model(cfg, "cuda", seed=1)
    _, epoch, _ = checkpoint.restore(os.path.join(save, "ckpt"), fresh)
    logits_r, shift_r, _ = eval_step(fresh, vbatch)
    if epoch != 1 or not (torch.equal(logits_r, logits)
                          and torch.equal(shift_r, shift)):
        raise AssertionError(f"the restored epoch-{epoch} checkpoint gives "
                             "other logits or offsets than the trained model")
    out = {"loop_s": loop_s, "steps": steps, "val_forwards": vals,
           "launches": launches,
           "losses": [r["loss"] for r in summary["iters"]],
           "loss_offset": offsets, "records": records,
           "step_wall_ms": [1e3 * r["wall_s"] for r in summary["iters"]],
           "valid_points": [r["points"] for r in summary["iters"]],
           "scenes": [r["scenes"] for r in summary["iters"]],
           "timing": summary["timing"]}
    log(f"[dcf] loop: {steps} steps and {vals} validation forwards in "
        f"{loop_s:.1f} s, launches {out['launches']}; losses "
        f"{out['losses']}, offset losses {offsets}; valid points "
        f"{out['valid_points']} in {out['scenes']} scenes; metrics.jsonl "
        f"{records}; the restored checkpoint's logits and offsets "
        "bit-identical")
    return out


def dcf_iou(model, dev, kernel_mods, tmp):
    """Phase 13 (c): ``test_iou.py``'s protocol (`iou_driver.score_scene`:
    sphere crops, forwards without a host pyramid, per-point means,
    instantiation, merge, box mAP) on one fabricated DCF_IOU_SCENE file at
    n_pad 320000 in 4 slots, with ``model``'s weights: one launch of each
    forward kernel per block and forward; the first crop batch's logits and
    offsets within LOGIT_RTOL / LOGIT_ATOL of the plain-version forward's;
    the protocol again giving identical boxes and TP/FP/FN; then the host
    steps alone on the scene's stand-in offsets (half the targets plus 5 mm
    noise, the true labels), where cuboids form. Returns the numbers."""
    from stratified_transformer_torch.data.datasets import DCF
    from stratified_transformer_torch.eval import (
        box_map, instantiation, iou_driver)
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.utils.config import merge_cfg_from_list
    root = os.path.join(tmp, "iou")
    write_cube_files(root, "test", 1, 31, **DCF_IOU_SCENE)
    yaml_cfg = merge_cfg_from_list(yaml_fp32(DCF_CONFIG), [
        "data_root", str([root])])
    cfg = iou_driver.offset_config(yaml_cfg)
    voxel_max = int(yaml_cfg["voxel_max"])
    models = []
    for impl in ("fused", "reference"):
        m_ = build_model(dataclasses.replace(cfg, attn_impl=impl), "cuda")
        m_.load_state_dict(model.state_dict())
        models.append(m_)
    [(path, coord, feat, gt)] = list(iou_driver.iou_scenes(yaml_cfg))
    predict = iou_driver.make_predict(models[0])
    fwd_s, first, crops = [], [], []

    def timed(feats, xyz, offsets):
        if not first:
            first.append((feats.copy(), xyz.copy(), offsets.copy()))
        crops.append(int(np.count_nonzero(np.diff(np.concatenate(
            [[0], offsets])))))
        t0 = time.perf_counter()
        out = predict(feats, xyz, offsets)      # synchronizes (.cpu())
        fwd_s.append(time.perf_counter() - t0)
        return out

    for m_ in kernel_mods.values():
        m_.KERNEL.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = [iou_driver.score_scene(timed, coord, feat, gt,
                                   box_map.DetectionMAP(0.5), cfg, voxel_max)]
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = {k: m_.KERNEL.launches for k, m_ in kernel_mods.items()}
    forwards = len(fwd_s)
    blocks = attention_blocks(cfg)
    want = {k: blocks * forwards if k in FWD_KERNELS else 0
            for k in launches}
    if launches != want:
        raise AssertionError(f"test_iou launches {launches}, expected {want} "
                             f"over {forwards} forwards")
    runs.append(iou_driver.score_scene(predict, coord, feat, gt,
                                       box_map.DetectionMAP(0.5), cfg,
                                       voxel_max))
    a, b = runs
    if not (np.array_equal(a["boxes"], b["boxes"]) and
            (a["tp"], a["fp"], a["fn"]) == (b["tp"], b["fp"], b["fn"])):
        raise AssertionError(f"test_iou protocol twice: boxes or TP/FP/FN "
                             f"differ ({a['tp']}/{a['fp']}/{a['fn']} vs "
                             f"{b['tp']}/{b['fp']}/{b['fn']})")
    got = [torch.from_numpy(t) for t in predict(*first[0])]
    want_t = [torch.from_numpy(t) for t in
              iou_driver.make_predict(models[1])(*first[0])]
    for name, g, w in zip(("logits", "offsets"), got, want_t):
        assert_close(f"test_iou first batch {name}", g, w, LOGIT_RTOL,
                     LOGIT_ATOL)
    errs = [max_errors(g, w)[0] for g, w in zip(got, want_t)]
    _, labels, target, _, _ = DCF.load_item(path)
    stand_in = 0.5 * target + np.random.default_rng(32).normal(
        0, 0.005, target.shape)
    t0 = time.perf_counter()
    objs = instantiation.instantiate(coord, stand_in, labels)
    merged = instantiation.merge_instances(objs)
    det = box_map.DetectionMAP(0.5)
    tp, fp, fn = det.evaluate(np.asarray([instantiation.support_to_box(o)
                                          for o in merged]).reshape(-1, 6),
                              gt)
    host_s = time.perf_counter() - t0
    if not tp:
        raise AssertionError("no box found from the stand-in offsets")
    out = {"points": len(coord), "n_pad": cfg.n_pad,
           "slots": cfg.num_scenes, "cubes": len(gt),
           "seconds": a["seconds"], "forward_s": sum(fwd_s),
           "host_s": a["seconds"] - sum(fwd_s), "forwards": forwards,
           "crops": sum(crops), "raw_objects": a["raw_objects"],
           "objects": a["objects"],
           "tp_fp_fn": (a["tp"], a["fp"], a["fn"]),
           "launches": launches, "max_memory_allocated_mib": peak,
           "first_batch_max_abs_err": errs,
           "stand_in": {"seconds": host_s, "raw_objects": len(objs),
                        "objects": len(merged), "tp_fp_fn": (tp, fp, fn),
                        "summary": det.summary()}}
    log(f"[dcf] test_iou: {len(coord)} points, {sum(crops)} crops in "
        f"{forwards} forwards of n_pad {cfg.n_pad} ({cfg.num_scenes} slots);"
        f" {a['seconds']:.2f} s, of it forwards {sum(fwd_s):.2f} s and host "
        f"{out['host_s']:.2f} s; objects {a['raw_objects']} -> "
        f"{a['objects']} after merge; TP/FP/FN {a['tp']}/{a['fp']}/{a['fn']}"
        f" of {len(gt)} boxes (random weights), the same in a second run; "
        f"launches {launches}; first batch vs plain versions max abs err "
        f"logits {errs[0]:.2e}, offsets {errs[1]:.2e}; max_memory_allocated "
        f"{peak:.0f} MiB")
    log(f"[dcf] test_iou host steps on stand-in offsets: {len(objs)} -> "
        f"{len(merged)} objects, TP/FP/FN {tp}/{fp}/{fn} of {len(gt)} in "
        f"{host_s:.2f} s; {det.summary()}")
    return out


def dcf_layout_removal(tmp):
    """Phase 13 (d): the layout-removal driver on its smoke scene (random
    weights): both ``.ply`` files read back with the prepared scene's point
    count."""
    from stratified_transformer_torch.data.ply import read_ply
    from stratified_transformer_torch.eval import layoutrm_driver
    from stratified_transformer_torch.utils.config import merge_cfg_from_list
    yaml_cfg = merge_cfg_from_list(yaml_fp32(DCF_CONFIG), [
        "result_path", os.path.join(tmp, "layoutrm")])
    t0 = time.perf_counter()
    [rec] = layoutrm_driver.run(yaml_cfg, "cuda",
                                log=lambda m: log(f"[dcf] layoutrm: {m}"))
    secs = time.perf_counter() - t0
    for key in ("sem", "shift"):
        n = len(read_ply(rec[key])["vertex"])
        if n != rec["points"]:
            raise AssertionError(f"{rec[key]} holds {n} points, the scene "
                                 f"{rec['points']}")
    log(f"[dcf] layoutrm: both clouds read back with {rec['points']} points "
        f"({secs:.1f} s with the model's build)")
    return {"points": rec["points"], "non_face": rec["non_face"],
            "seconds": secs}


def dcf_phase(dev, kernel_mods):
    """Phase 13: the DCF family at full width (module docstring). Returns
    the numbers of (a)-(d)."""
    import tempfile

    from stratified_transformer_torch.config import from_cfg
    from stratified_transformer_torch.data.loader import to_device
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.utils.config import merge_cfg_from_list
    t_phase = time.time()
    log(f"[dcf] phase 13: {PIN_NOTE}")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "cubes")
        t0 = time.time()
        write_cube_files(root, "train", DCF_TRAIN_FILES, 21, **DCF_SCENE)
        write_cube_files(root, "test", DCF_TEST_FILES, 22, **DCF_SCENE)
        yaml_cfg = merge_cfg_from_list(yaml_fp32(DCF_CONFIG), [
            "data_root", str([root]), "n_devices", "1"])
        cfg = from_cfg(yaml_cfg)
        blocks = attention_blocks(cfg)
        hbs = dcf_batches(yaml_cfg, cfg, EVAL_BATCHES)
        out.update(n_pad=cfg.n_pad, blocks=blocks,
                   setup_s=time.time() - t0,
                   valid_points=[int(hb["offsets"][-1]) for hb in hbs],
                   scenes=[int(np.count_nonzero(np.diff(np.concatenate(
                       [[0], hb["offsets"]])))) for hb in hbs])
        log(f"[dcf] {DCF_TRAIN_FILES} + {DCF_TEST_FILES} cube files "
            f"({json.dumps(DCF_SCENE)}) and {len(hbs)} loader batches (n_pad "
            f"{cfg.n_pad}, {cfg.num_scenes} slots): valid points "
            f"{out['valid_points']} in {out['scenes']} scenes, "
            f"{out['setup_s']:.1f} s")

        # (a) eval forwards and train steps
        model = build_model(cfg, "cuda", seed=0)
        o1_weights(model, seed=0)
        ref_model = build_model(
            dataclasses.replace(cfg, attn_impl="reference"), "cuda")
        ref_model.load_state_dict(model.state_dict())
        out["eval"] = dcf_eval(cfg, yaml_cfg, hbs, model, ref_model, dev,
                               kernel_mods)
        init_state = {k: v.clone() for k, v in model.state_dict().items()}
        train = train_phase("[dcf]", cfg, yaml_cfg, init_state,
                            [to_device(hb, dev) for hb in hbs], kernel_mods)
        train.pop("profiled_kernels")
        out["train"] = train
        del init_state, ref_model, hbs

        # (b) the training loop; (c) test_iou; (d) layout removal
        out["loop"] = dcf_loop(yaml_cfg, tmp, dev, kernel_mods, blocks)
        out["iou"] = dcf_iou(model, dev, kernel_mods, tmp)
        out["layoutrm"] = dcf_layout_removal(tmp)
    out["seconds"] = time.time() - t_phase
    log(f"[dcf] phase 13 in {out['seconds']:.0f} s")
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


def fast_kernel_modules():
    """The fast (bf16) forms of the four attention kernels by report name,
    each as an object whose ``KERNEL`` is the wrapper module's
    ``KERNEL_FAST`` (the launch count that `counts` reads)."""
    return {name + FAST: types.SimpleNamespace(KERNEL=mod.KERNEL_FAST)
            for name, mod in attention_kernel_modules().items()}


def fast_model_step(cfg, yaml_cfg, hbs, dev, mods):
    """Phase 14 (b): the full-width eval forward and one training step of
    the shipped S3DIS YAML (``cfg.fast``) through the fast kernels, against
    the same through the plain fast versions, and the fast model's logits
    against the fp32 kernels' on the same weights. ``mods``: the four fp32
    and four fast kernels by name; every launch count is read from them."""
    from stratified_transformer_torch.data.loader import to_device
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.train import schedulers
    from stratified_transformer_torch.train.state import make_optimizer
    from stratified_transformer_torch.train.step import (
        make_eval_step, make_train_step)
    blocks = attention_blocks(cfg)

    def counts():
        return {k: m_.KERNEL.launches for k, m_ in mods.items()}

    def expect(label, before, names):
        per = {k: counts()[k] - before[k] for k in before}
        want = {k: blocks if k in names else 0 for k in before}
        if per != want:
            raise AssertionError(f"{label}: launches {per}, expected {want}")

    model = build_model(cfg, "cuda", seed=0)
    o1_weights(model, seed=0)
    state = {k: v.clone() for k, v in model.state_dict().items()}

    def twin(**kw):
        m_ = build_model(dataclasses.replace(cfg, **kw), "cuda")
        m_.load_state_dict(state)
        return m_

    eval_step = make_eval_step(int(yaml_cfg["ignore_label"]),
                               cfg.num_classes)
    batches = [to_device(hb, dev) for hb in hbs]
    fast_fwd = tuple(n + FAST for n in FWD_KERNELS)
    models = {"fast": model, "fp32": twin(**FP32)}
    for m_ in models.values():
        eval_step(m_, batches[0])               # first call: lazy set-up
    torch.cuda.synchronize()
    times = {k: [] for k in models}
    logits = {k: [] for k in models}
    for b in batches:                           # in turns: fast, fp32
        for k, m_ in models.items():
            before = counts()
            t0 = time.perf_counter()
            out_l = eval_step(m_, b)[0]
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
            expect(f"{k} forward", before,
                   fast_fwd if k == "fast" else FWD_KERNELS)
            if not bool(torch.isfinite(out_l).all()):
                raise AssertionError(f"non-finite {k} logits")
            logits[k].append(out_l)
    plain_model = twin(attn_impl="reference")
    out = {"forward_ms": times, "logits_rel_l2": [],
           "fp32_logits_rel_l2": [], "vs_fp32_rel_l2": [],
           "vs_fp32_max_abs": []}
    for j, b in enumerate(batches):
        before = counts()
        want = eval_step(plain_model, b)[0]
        expect("plain fast forward", before, ())
        err = rel_l2(logits["fast"][j], want)
        control = rel_l2(logits["fp32"][j], want)
        fast_gate(f"fast logits batch {j}", err, FAST_LOGITS_REL_L2, control)
        out["logits_rel_l2"].append(err)
        out["fp32_logits_rel_l2"].append(control)
        out["vs_fp32_rel_l2"].append(rel_l2(logits["fast"][j],
                                            logits["fp32"][j]))
        out["vs_fp32_max_abs"].append(
            max_errors(logits["fast"][j], logits["fp32"][j])[0])
    log(f"[fast] eval forward (N {cfg.n_pad}, host clock, synchronized, in "
        f"turns) fast {', '.join(f'{t:.1f}' for t in times['fast'])} ms, "
        f"fp32 {', '.join(f'{t:.1f}' for t in times['fp32'])} ms; fast "
        f"logits vs plain fast versions relative L2 "
        f"{max(out['logits_rel_l2']):.2e} (the fp32 kernels' logits "
        f"{min(out['fp32_logits_rel_l2']):.2e}: control); vs the fp32 "
        f"kernels' logits "
        f"relative L2 {', '.join(f'{e:.2e}' for e in out['vs_fp32_rel_l2'])}"
        f" (max abs {max(out['vs_fp32_max_abs']):.2e}; report only)")
    del logits, models

    # one training step from the same weights, kernels and plain versions
    schedule = schedulers.from_config(yaml_cfg, TRAIN_ITERS_PER_EPOCH)[0]
    train_step = make_train_step(int(yaml_cfg["ignore_label"]),
                                 cfg.num_classes)

    def step(impl, **kw):
        m_ = build_model(dataclasses.replace(cfg, attn_impl=impl, **kw),
                         "cuda", train=True)
        m_.load_state_dict(state)
        opt = make_optimizer(
            m_, schedule, weight_decay=float(yaml_cfg["weight_decay"]),
            transformer_lr_scale=float(yaml_cfg["transformer_lr_scale"]))
        gen = torch.Generator(device="cuda").manual_seed(1000)
        before = counts()
        t0 = time.perf_counter()
        stats = train_step(m_, opt, batches[0], gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        grads = {n_: p_.grad.clone() for n_, p_ in m_.named_parameters()}
        return float(stats["loss"]), ms, grads, {
            k: counts()[k] - before[k] for k in before}

    step("fused")                               # set-up (cuBLAS, autograd)
    loss_k, ms_k, grads_k, per_k = step("fused")
    want = {k: blocks if k in FAST_KERNELS else 0 for k in per_k}
    if per_k != want:
        raise AssertionError(f"fast train step launches {per_k}, expected "
                             f"{want}")
    loss_32, ms_32, grads_32, per_32 = step("fused", **FP32)
    want = {k: blocks if k in FWD_KERNELS + BWD_KERNELS else 0
            for k in per_32}
    if per_32 != want:
        raise AssertionError(f"fp32 train step launches {per_32}, expected "
                             f"{want}")
    # more steps in turns for the times: host clocks spread by tens of
    # percent from one step to the next
    step_ms = {"fast": [ms_k], "fp32": [ms_32]}
    for _ in range(STEP_TIMINGS - 1):
        step_ms["fast"].append(step("fused")[1])
        step_ms["fp32"].append(step("fused", **FP32)[1])
    with plain_in_kernel_slices(dev):
        loss_p, ms_p, grads_p, per_p = step("reference")
    if any(per_p.values()):
        raise AssertionError(f"the plain fast step launched {per_p}")
    worst = (0.0, "", 0.0)
    for name, gp in grads_p.items():
        err = float((grads_k[name] - gp).norm())
        bound = (FAST_STEP_GRAD_REL_L2 * float(gp.norm())
                 + GRAD_FLOOR * gp.numel() ** 0.5)
        if not err <= bound:
            msg = (f"fast step-1 grad {name}: |kernel - plain| {err:.3e} > "
                   f"{bound:.3e}")
            log(f"[fast] FAILED {msg}")
            FAST_FAILURES.append(msg)
        if float(gp.norm()) > 1e3 * GRAD_FLOOR * gp.numel() ** 0.5:
            worst = max(worst, (err / float(gp.norm()), name, float(
                (grads_32[name] - gp).norm()) / float(gp.norm())))
    flat = [torch.cat([g[n_].flatten() for n_ in grads_p])
            for g in (grads_k, grads_p, grads_32)]
    total, total_32 = rel_l2(flat[0], flat[1]), rel_l2(flat[2], flat[1])
    fast_gate("fast step-1 grads, all parameters", total,
              FAST_STEP_ALL_REL_L2, total_32)
    np.testing.assert_allclose(loss_k, loss_p, rtol=LOSS_RTOL,
                               err_msg="fast step-1 loss")
    med = {k: float(np.median(v)) for k, v in step_ms.items()}
    out.update(train_step_ms=med["fast"], fp32_train_step_ms=med["fp32"],
               train_steps_ms=step_ms["fast"],
               fp32_train_steps_ms=step_ms["fp32"],
               plain_train_step_ms=ms_p, loss=loss_k, plain_loss=loss_p,
               fp32_loss=loss_32, grad_worst_rel_l2=worst[0],
               grad_worst=worst[1], grad_worst_fp32_rel_l2=worst[2],
               grads_rel_l2=total, fp32_grads_rel_l2=total_32, launches=per_k)
    log(f"[fast] train step (host clock, synchronized, {STEP_TIMINGS} each "
        f"in turns): fast {', '.join(f'{t:.1f}' for t in step_ms['fast'])} "
        f"ms (median {med['fast']:.1f}), fp32 "
        f"{', '.join(f'{t:.1f}' for t in step_ms['fp32'])} ms (median "
        f"{med['fp32']:.1f}), plain fast versions {ms_p:.1f} ms (one step);"
        f" launches {per_k}; step-1 grads against the plain fast step in the"
        f" kernels' row slices: all {len(grads_p)} parameters together "
        f"{total:.2e} relative L2 (the fp32 kernels' step {total_32:.2e}: "
        f"control); largest {worst[0]:.2e} ({worst[1]}; fp32 kernels "
        f"{worst[2]:.2e}); loss {loss_k:.6f} (plain {loss_p:.6f}, fp32 "
        f"kernels {loss_32:.6f})")
    return out


@contextlib.contextmanager
def plain_in_kernel_slices(dev):
    """Within: the plain fast backward versions that the fused attention's
    ``plain`` path runs sum the key masses over the fast kernels' row
    slices (`kernel_slice_rows`, from each call's table rows), so that the
    plain fast step rounds where the kernels' step does (the kept
    divergence from the TPU kernel's per-tile masses, ROADMAP.md section 3,
    is pinned on the CPU by tests/test_torch_fast.py)."""
    from stratified_transformer_torch.ops import attention as plain
    from stratified_transformer_torch.ops import attention_fused

    def sliced(fn, name, band):
        def run(*args, **kw):
            nbf = plain.num_bins(*args[-3:])
            nb = (plain.band_slice(nbf, kw.get("rpe_mode", "stratified"))[1]
                  if band else nbf)
            rows = (kernel_slice_rows(name, dev, nb, kw.get("fast", False))
                    if nbf else None)
            return fn(*args, **kw, slice_rows=rows)
        return run

    with mock.patch.multiple(
            attention_fused,
            band_attention_bwd_plain=sliced(
                plain.band_attention_bwd_plain, "band_attention_bwd", True),
            sparse_band_attention_bwd_plain=sliced(
                plain.sparse_band_attention_bwd_plain,
                "sparse_band_attention_bwd", False)):
        yield


def fast_forwards_in_turns(tag, cfg, yaml_cfg, hb, dev, reps=3):
    """Phase 14 (c): the full-width eval forward of the shipped YAML
    (``cfg``, fast) and the same weights pinned to fp32 on the batch ``hb``:
    ``reps`` of each in turns (host clock, synchronized). (No device-busy
    time: the forward waits for the card, so `device_busy_ms` cannot take
    it, and the profiler lost its device records here, PERF.md §7.)"""
    from stratified_transformer_torch.data.loader import to_device
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.train.step import make_eval_step
    model = build_model(cfg, "cuda", seed=0)
    o1_weights(model, seed=0)
    fp32 = build_model(dataclasses.replace(cfg, **FP32), "cuda")
    fp32.load_state_dict(model.state_dict())
    eval_step = make_eval_step(int(yaml_cfg["ignore_label"]),
                               cfg.num_classes)
    batch = to_device(hb, dev)
    models = {"fast": model, "fp32": fp32}
    times = {k: [] for k in models}
    with torch.no_grad():
        for m_ in models.values():
            eval_step(m_, batch)                # first call: lazy set-up
        torch.cuda.synchronize()
        for _ in range(reps):
            for k, m_ in models.items():
                t0 = time.perf_counter()
                eval_step(m_, batch)
                torch.cuda.synchronize()
                times[k].append((time.perf_counter() - t0) * 1e3)
    log(f"[fast] {tag} eval forward (n_pad {cfg.n_pad}, host clock, "
        f"synchronized, in turns) fast "
        f"{', '.join(f'{t:.1f}' for t in times['fast'])} ms, fp32 "
        f"{', '.join(f'{t:.1f}' for t in times['fp32'])} ms")
    return {"forward_ms": times}


def fast_phase(dev):
    """Phase 14: the shipped YAMLs as they are (``rpe_precision`` /
    ``qk_precision: default``): (a) the four fast kernels against their
    plain fast versions at S3DIS's operating point (N 40960, 2 scenes, host
    pyramid) at every block's plan, with times, bounds and the fp32 forms'
    times from this call; (b) `fast_model_step`; (c) the four fast kernels
    at ScanNet's 80-row tables on phase 12's plans of one batch, and
    `fast_forwards_in_turns` on that batch. Returns the numbers and each
    fast kernel's reports under ``report`` and ``scannet_report``."""
    from stratified_transformer_torch.config import load_config
    from stratified_transformer_torch.data.loader import host_batch
    from stratified_transformer_torch.utils.config import load_cfg
    t_phase = time.time()
    FAST_FAILURES.clear()
    cfg = load_config(CONFIG, n_pad=N_PAD, num_scenes=SCENES)
    yaml_cfg = load_cfg(CONFIG)
    if not (cfg.fast and yaml_cfg["rpe_precision"] == "default"):
        raise AssertionError("the shipped S3DIS YAML does not select the "
                             "fast forms")
    log("[fast] phase 14: configs/s3dis_stratified.yaml as shipped "
        "(rpe_precision/qk_precision default): the bf16 forms of the four "
        "attention kernels")
    hbs = [host_batch(cfg, seed=s) for s in range(EVAL_BATCHES)]
    levels = stage_levels(cfg, hbs[0])
    plans = {(i, sh): build_plan(cfg, i, levels[i], sh, dev)
             for i in stages(cfg) for sh in (False, True)}
    report = new_report(FAST_KERNELS)
    out = {"stages": fwd_phase(cfg, levels, plans, dev, report, fast=True)}
    bwd_phase(cfg, levels, plans, dev, report, fast=True)
    out["report"] = report
    del plans
    mods = dict(attention_kernel_modules(), **fast_kernel_modules())
    out["model"] = fast_model_step(cfg, yaml_cfg, hbs, dev, mods)

    scfg = load_config(SCANNET_CONFIG)
    if not scfg.fast:
        raise AssertionError("the shipped ScanNet YAML does not select the "
                             "fast forms")
    t0 = time.time()
    shb = host_batch(scfg, seed=0, **SCANNET_ROOMS)
    log(f"[fast] ScanNet batch (n_pad {scfg.n_pad}, "
        f"{int(shb['offsets'][-1])} valid points) built in "
        f"{time.time() - t0:.2f} s")
    slevels = stage_levels(scfg, shb)
    splans = {(i, sh): build_plan(scfg, i, slevels[i], sh, dev)
              for i in stages(scfg) for sh in (False, True)}
    sreport = new_report(FAST_KERNELS)
    fwd_phase(scfg, slevels, splans, dev, sreport, fast=True)
    bwd_phase(scfg, slevels, splans, dev, sreport, fast=True)
    out["scannet_report"] = sreport
    del splans
    out["scannet_forward"] = fast_forwards_in_turns(
        "ScanNet", scfg, load_cfg(SCANNET_CONFIG), shb, dev)
    out["seconds"] = time.time() - t_phase
    log(f"[fast] phase 14 in {out['seconds']:.0f} s")
    if FAST_FAILURES:
        raise AssertionError(f"phase 14: {len(FAST_FAILURES)} gates or "
                             f"controls failed: {FAST_FAILURES}")
    return out



# phase 15: the Swin3D family (arch: swin3d_transformer) on the band kernels'
# swin mode; its kernels in the kernels line, by report name
SWIN_CONFIG = os.path.join(REPO, "configs", "s3dis_swin3d.yaml")
SCANNET_SWIN_CONFIG = os.path.join(REPO, "configs", "scannetv2_swin3d.yaml")
SWIN = "_swin"
SWIN_KERNELS = ("band_attention" + SWIN, "band_attention_bwd" + SWIN)
SWIN_FAST_KERNELS = tuple(n + FAST for n in SWIN_KERNELS)
# (e): the training driver's loop, 1 epoch of 2 steps on the YAML's batch
# shape (8 slots of 140000 points; 16 synthetic rooms of 60000 points) with
# validation (16 rooms of seed 10000 in the YAML's batches of 4), and
# the eval driver's protocol at the YAML's test shape (n_pad 400000 in 5
# crops) on one synthetic room of SWIN_SCENE_POINTS points (reduced from
# phase 10's 300000 for time)
SWIN_LOOP_OVERRIDES = [
    "data_name", "synthetic", "max_batch_points", "140000", "batch_size", "8",
    "voxel_max", "80000", "synthetic_points", "60000", "synthetic_scenes",
    "16", "epochs", "1", "evaluate", "True", "print_freq", "1",
    "use_tensorboard", "False", "n_devices", "1"]
SWIN_SCENE_POINTS = 40000


def swin_kernels(cfg, levels, dev, report, family="S3DIS"):
    """Phase 15 (b) and (f)'s kernels: at every stage's plans of parity 0
    and 1 (no far keys; each point's window-quantized position from the
    plan's grid origin, the shifted parity at window / 2), with random
    q/k/v/g and tables of 2 qgl - 1 rows (31 at S3DIS) from seed 0: the
    band forward and backward kernels in the swin mode against their plain
    versions (phase 4's and phase 7's gates), and their fast forms against
    the plain fast versions (phase 14's gates, each with its fp32
    control). Adds per-step times, bounds and errors to ``report``
    (``<kernel>_swin``, ``..._swin_bf16``) and the forward wrapper's
    device-busy time; ``family`` names the configuration in the log."""
    from stratified_transformer_torch.kernels import band_attention as band_k
    from stratified_transformer_torch.kernels import (
        band_attention_bwd as band_bwd_k)
    from stratified_transformer_torch.models.attention import swin_positions
    from stratified_transformer_torch.ops import attention as plain
    gen = torch.Generator(device="cpu").manual_seed(0)
    grad_names = ("dq", "dk", "dv", "dtq", "dtk", "dtv")
    bin_ops = BIN_OPS["swin_window"]
    report[SWIN_KERNELS[0]]["wrapper_busy_ms"] = 0.0
    for name in SWIN_FAST_KERNELS:
        report[name]["fp32_ms"] = 0.0
    for i in stages(cfg):
        h, d = cfg.num_heads[i], cfg.channels[i] // cfg.num_heads[i]
        ws, qs = cfg.window_sizes()[i], cfg.quant_sizes()[i]
        nbf = 2 * int(ws / qs) - 1
        band = cfg.stage_band(i)
        n = len(levels[i][0])
        q, k, v, g = (torch.randn(n, h, d, generator=gen).to(dev)
                      for _ in range(4))
        tables = tuple((torch.randn(nbf, h, d, 3, generator=gen) * 0.05
                        ).to(dev) for _ in range(3))
        for shifted in (False, True):
            blocks = (cfg.depths[i] + (0 if shifted else 1)) // 2
            plan = build_plan(cfg, i, levels[i], shifted, dev)
            if plan.sparse_band is not None:
                raise AssertionError("a Swin3D plan with far keys")
            u = swin_positions(plan.xyz_sorted, plan.grid_start,
                               ws / 2.0 if shifted else 0.0, ws, qs)
            geom = (u, plan.seg_start, plan.seg_end, plan.valid_sorted)
            kw = dict(window_size=ws, quant_size=qs, scale=d ** -0.5,
                      band=band, tile=cfg.tile, rpe_mode="swin_window")
            pairs = band_pairs(plan, band, cfg.tile)
            n_q = int(plan.valid_sorted.sum())
            label = f"stage {i} shifted={int(shifted)}"
            rows = kernel_slice_rows("band_attention_bwd", dev, nbf)
            with torch.no_grad():
                for fast in (False, True):
                    fkw = dict(kw, fast=fast)
                    sfx = SWIN + (FAST if fast else "")
                    # forward
                    key = "band_attention" + sfx
                    args, outs, inputs = band_k.launch_args(
                        q, k, v, *geom, *tables, **fkw)
                    got = band_k.band_attention(q, k, v, *geom, *tables,
                                                **fkw)
                    want = plain.band_attention_plain(q, k, v, *geom,
                                                      *tables, **fkw)
                    if fast:
                        err = check_fast_triple(
                            f"{key} {label}", got, want,
                            band_k.band_attention(
                                q, k, v, *geom, *tables,
                                **dict(fkw, fast=False)))
                        # the fp32 form on the same inputs; the bound
                        # counts its inputs, the function's, not the bf16
                        # copies
                        args32 = band_k.launch_args(q, k, v, *geom, *tables,
                                                    **kw)
                        side_ms = cuda_time_ms(
                            lambda: band_k.KERNEL(*args32[0]), 20)
                        report[key]["fp32_ms"] += blocks * side_ms
                        inputs = args32[2]
                        errs = err[2]
                    else:
                        for tn, a, b in zip(("acc", "m", "den"), got, want):
                            assert_close(f"{key} {label} {tn}", a, b, RTOL,
                                         ATOL)
                        errs = [max_errors(a, b) for a, b in zip(got, want)]
                        side_ms = device_busy_ms(
                            lambda: band_k.band_attention(
                                q, k, v, *geom, *tables, **fkw), 3)
                        report[key]["wrapper_busy_ms"] += blocks * side_ms
                    kern = band_k.KERNEL_FAST if fast else band_k.KERNEL
                    ms = cuda_time_ms(lambda: kern(*args), 20)
                    plain_ms = cuda_time_ms(lambda: plain.band_attention_plain(
                        q, k, v, *geom, *tables, **fkw), 3)
                    t_ops = least_ops(pairs, n_q, n_q, h, d, nbf, split=fast,
                                      bin_ops=bin_ops)
                    bound, by = add_timing(
                        report, key, blocks, ms, plain_ms,
                        fwd_bytes("band_attention", inputs, outs, None),
                        t_ops, max(e[0] for e in errs))
                    log(f"[swin] {key} {label} N={n} h={h} pairs={pairs}: "
                        f"{ms:.4f} ms ("
                        + (f"fp32 form {side_ms:.4f} ms" if fast else
                           f"wrapper device busy {side_ms:.4f} ms")
                        + f"; plain {plain_ms:.3f} ms, bound {bound:.4f} ms "
                        f"by {by}); max abs err acc {errs[0][0]:.2e}")
                    # backward, on the merged residuals of the plain forward
                    key = "band_attention_bwd" + sfx
                    out, m, den = plain.merge([want])
                    res = (g, out, m, den)
                    args, outs, inputs = band_bwd_k.launch_args(
                        q, k, v, *geom, *res, *tables, **fkw)
                    bound_inputs = inputs
                    got = band_bwd_k.band_attention_bwd(
                        q, k, v, *geom, *res, *tables, **fkw)
                    want_g = plain.band_attention_bwd_plain(
                        q, k, v, *geom, *res, *tables, **fkw,
                        slice_rows=rows if fast else None)
                    if fast:
                        ctl_g = band_bwd_k.band_attention_bwd(
                            q, k, v, *geom, *res, *tables,
                            **dict(fkw, fast=False))
                        l2s = []
                        for gn, a, b, c in zip(grad_names, got, want_g,
                                               ctl_g):
                            l2s.append(rel_l2(a, b))
                            fast_gate(f"{key} {label} {gn}", l2s[-1],
                                      FAST_GRAD_REL_L2, rel_l2(c, b))
                        errs = [float((a - b).abs().max())
                                for a, b in zip(got, want_g)]
                        fp32_args, _, fp32_inputs = band_bwd_k.launch_args(
                            q, k, v, *geom, *res, *tables, **kw)
                        side_ms = cuda_time_ms(
                            lambda: band_bwd_k.KERNEL(*fp32_args), 10)
                        report[key]["fp32_ms"] += blocks * side_ms
                        # the bound counts the fp32 inputs, as the model
                        # gives them (`bwd_phase`)
                        bound_inputs = fp32_inputs
                    else:
                        errs = [grads_close(f"{key} {label} {gn}", a, b)
                                for gn, a, b in zip(grad_names, got, want_g)]
                    kern = band_bwd_k.KERNEL_FAST if fast else band_bwd_k.KERNEL
                    ms = cuda_time_ms(lambda: kern(*args), 10)
                    plain_ms = cuda_time_ms(
                        lambda: plain.band_attention_bwd_plain(
                            q, k, v, *geom, *res, *tables, **fkw), 2)
                    t_ops = least_ops_bwd(pairs, n_q, n_q, h, d, nbf,
                                          split=fast, bin_ops=bin_ops)
                    bound, by = add_timing(report, key, blocks, ms, plain_ms,
                                           nbytes(bound_inputs + tuple(got)),
                                           t_ops, max(errs))
                    log(f"[swin] {key} {label}: {ms:.4f} ms ("
                        + (f"fp32 form {side_ms:.4f} ms; " if fast else "")
                        + f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms by "
                        f"{by}); max abs err "
                        + " ".join(f"{gn} {e:.2e}"
                                   for gn, e in zip(grad_names, errs)))
    for name in SWIN_KERNELS + SWIN_FAST_KERNELS:
        r = report[name]
        log(f"[swin] {name}: {r['ms']:.3f} ms per {family} Swin3D train step "
            f"(plain {r['plain_ms']:.2f} ms, bound {r['bound_ms']:.3f} ms"
            + (f", fp32 form {r['fp32_ms']:.3f} ms" if "fp32_ms" in r else "")
            + (f", wrapper device busy {r['wrapper_busy_ms']:.3f} ms"
               if "wrapper_busy_ms" in r else "") + ")")


def swin_eval(tag, cfg, yaml_cfg, batches, model, ref_model, all_mods):
    """Phase 15 (c)/(d)'s eval forwards: one band launch per block and no
    other (no far-key kernel, no backward), finite logits equal to the
    plain-version model's within LOGIT_RTOL / LOGIT_ATOL. Returns times
    and errors."""
    from stratified_transformer_torch.train.step import make_eval_step
    blocks = attention_blocks(cfg)
    eval_step = make_eval_step(int(yaml_cfg["ignore_label"]),
                               cfg.num_classes)

    def counts():
        return {k: m_.KERNEL.launches for k, m_ in all_mods.items()}

    eval_step(model, batches[0])                # first call: lazy set-up
    torch.cuda.synchronize()
    times, errs = [], []
    for j, b in enumerate(batches):
        before = counts()
        t0 = time.perf_counter()
        logits, _, stats = eval_step(model, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per = {k: counts()[k] - before[k] for k in before}
        want_n = {k: blocks if k == "band_attention" else 0 for k in before}
        if per != want_n:
            raise AssertionError(f"{tag} forward {j} launches {per}, "
                                 f"expected {want_n}")
        if not (bool(torch.isfinite(logits).all())
                and bool(torch.isfinite(stats["loss"]))):
            raise AssertionError(f"{tag} non-finite logits or loss")
        before = counts()
        want = eval_step(ref_model, b)[0]
        if counts() != before:
            raise AssertionError(f"{tag} the plain-version forward launched "
                                 "a kernel")
        assert_close(f"{tag} logits batch {j}", logits, want, LOGIT_RTOL,
                     LOGIT_ATOL)
        errs.append(max_errors(logits, want))
    log(f"{tag} eval forward (host clock, synchronized) "
        f"{', '.join(f'{t:.1f}' for t in times)} ms; {blocks} band launches"
        f" and none else per forward; logits vs plain-version forward max "
        f"abs/rel err {max(e[0] for e in errs):.2e}/"
        f"{max(e[1] for e in errs):.2e}")
    return {"forward_ms": times, "logits_max_abs_err": [e[0] for e in errs]}


def swin_model(tag, cfg, yaml_cfg, eval_hbs, train_hbs, dev, band_mods,
               all_mods):
    """Phase 15 (c)/(d): the full-width Swin3D at ``o1_weights`` through the
    kernels against the plain-version model: eval forwards on ``eval_hbs``
    (`swin_eval`) and `train_phase`'s steps on ``train_hbs`` (one launch of
    each band kernel per block and step, step-1 grads within GRAD_REL_L2,
    the loss trajectory), with no far-key kernel launched."""
    from stratified_transformer_torch.data.loader import to_device
    from stratified_transformer_torch.models.stratified import build_model
    model = build_model(cfg, "cuda", seed=0)
    o1_weights(model, seed=0)
    ref_model = build_model(dataclasses.replace(cfg, attn_impl="reference"),
                            "cuda")
    ref_model.load_state_dict(model.state_dict())
    if not all(not m_.attn.plain and m_.attn.rpe_mode == "swin_window"
               for m_ in model.modules() if hasattr(m_, "attn")):
        raise AssertionError(f"{tag} a block off the kernels' swin mode")
    batches = [to_device(hb, dev) for hb in eval_hbs]
    out = {"eval": swin_eval(tag, cfg, yaml_cfg, batches, model, ref_model,
                             all_mods)}
    del batches, ref_model
    init_state = {k_: v_.clone() for k_, v_ in model.state_dict().items()}
    del model
    sparse = {k: all_mods[k].KERNEL.launches for k in all_mods
              if k not in band_mods}
    train = train_phase(tag, cfg, yaml_cfg, init_state,
                        [to_device(hb, dev) for hb in train_hbs], band_mods)
    if {k: all_mods[k].KERNEL.launches for k in sparse} != sparse:
        raise AssertionError(f"{tag} a far-key kernel launched in training")
    train.pop("profiled_kernels")
    out["train"] = train
    return out


def swin_drivers(band_mods, all_mods):
    """Phase 15 (e): the shipped S3DIS Swin YAML (``attn_impl: reference``,
    which the port runs on its main path) through ``train/driver.py`` for 1
    epoch of 2 steps with validation and ``eval/driver.py`` on one
    synthetic room of SWIN_SCENE_POINTS points at the YAML's test shape:
    band launches one per block and step (forward), no far-key kernel, no
    audit."""
    import tempfile

    from stratified_transformer_torch.eval import driver as eval_driver
    from stratified_transformer_torch.utils.config import merge_cfg_from_list
    blocks = 12
    sparse = {k: all_mods[k].KERNEL.launches for k in all_mods
              if k not in band_mods}
    with tempfile.TemporaryDirectory() as tmp:
        yaml_cfg = merge_cfg_from_list(
            yaml_fp32(SWIN_CONFIG),
            SWIN_LOOP_OVERRIDES + ["save_path", os.path.join(tmp, "run")])
        model, summary, loop_s = run_loop("[swin] loop:", yaml_cfg,
                                          band_mods, blocks)
    losses = [r["loss"] for r in summary["iters"]]
    if (summary["steps"] != 2 or not np.isfinite(losses).all()
            or any("audit" in r for r in summary["iters"])):
        raise AssertionError(f"swin loop: {summary['steps']} steps, losses "
                             f"{losses}, an audit where none runs")
    if model.cfg.attn_impl != "fused" or model.cfg.use_stratified:
        raise AssertionError(f"swin loop model {model.cfg}")
    out = {"loop_s": loop_s, "steps": summary["steps"], "losses": losses,
           "val_forwards": summary["val_forwards"],
           "step_wall_ms": [1e3 * r["wall_s"] for r in summary["iters"]],
           "valid_points": [r["points"] for r in summary["iters"]],
           "launches": {k: m_.KERNEL.launches for k, m_ in band_mods.items()}}
    log(f"[swin] loop: {summary['steps']} steps in {loop_s:.1f} s, launches "
        f"{out['launches']}; losses {losses}; valid points "
        f"{out['valid_points']}")
    del model
    eval_cfg = merge_cfg_from_list(yaml_fp32(SWIN_CONFIG), [
        "data_name", "synthetic", "synthetic_points", str(SWIN_SCENE_POINTS),
        "synthetic_eval_scenes", "1"])
    for m_ in band_mods.values():
        m_.KERNEL.launches = 0
    lines = []
    t0 = time.perf_counter()
    metrics = eval_driver.run(eval_cfg, "cuda",
                              log=lambda x: (lines.append(x), log(
                                  f"[swin] eval driver: {x[:300]}")))
    torch.cuda.synchronize()
    scene_s = time.perf_counter() - t0
    ev = {k: m_.KERNEL.launches for k, m_ in band_mods.items()}
    if (len(metrics["scenes"]) != 1 or ev["band_attention"] == 0
            or ev["band_attention"] % blocks or ev["band_attention_bwd"]
            or not lines[-1].startswith("Val result")):
        raise AssertionError(f"swin eval driver: scenes "
                             f"{len(metrics['scenes'])}, launches {ev}")
    if {k: all_mods[k].KERNEL.launches for k in sparse} != sparse:
        raise AssertionError("a far-key kernel launched in the swin drivers")
    out.update(scene_s=scene_s, scene_forwards=ev["band_attention"] // blocks,
               scene_launches=ev, scene_points=SWIN_SCENE_POINTS)
    log(f"[swin] eval driver: one {SWIN_SCENE_POINTS}-point room in "
        f"{scene_s:.1f} s, {out['scene_forwards']} forwards, launches {ev}")
    return out


def swin_fast_model(hb, dev, band_mods, all_mods):
    """Phase 15 (f): the S3DIS Swin YAML with ``rpe_precision/qk_precision
    default`` at full width (``o1_weights``), one eval forward and one
    train step through the bf16 band kernels: 12 launches of each fast form
    per step (the forward's alone in evaluation) and none of the fp32 forms
    or the far-key kernels. The forward's logits and the step's gradients
    against the plain fast versions' (in the kernels' row slices) are held
    to FAST_LOGITS_REL_L2 and FAST_SWIN_STEP_ALL_REL_L2 (`fast_gate`), with
    the same forward and step on the fp32 kernels as the controls, and each
    parameter's gradient and the loss as in phase 14. Returns the launches
    and readings."""
    from stratified_transformer_torch.config import load_config
    from stratified_transformer_torch.data.loader import to_device
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.train import schedulers
    from stratified_transformer_torch.train.state import make_optimizer
    from stratified_transformer_torch.train.step import (
        make_eval_step, make_train_step)
    from stratified_transformer_torch.utils.config import (
        load_cfg, merge_cfg_from_list)
    yaml_cfg = merge_cfg_from_list(load_cfg(SWIN_CONFIG), [
        "rpe_precision", "default", "qk_precision", "default"])
    cfg = load_config(SWIN_CONFIG, n_pad=N_PAD, num_scenes=SCENES,
                      rpe_precision="default", qk_precision="default")
    if not cfg.fast:
        raise AssertionError("default precisions do not select the fast "
                             "forms")
    fast_mods = {k + SWIN + FAST: types.SimpleNamespace(KERNEL=m_.KERNEL_FAST)
                 for k, m_ in band_mods.items()}
    mods = dict(all_mods, **fast_mods)

    def counts():
        return {k: m_.KERNEL.launches for k, m_ in mods.items()}

    model = build_model(cfg, "cuda", seed=0)
    o1_weights(model, seed=0)
    state = {k: v.clone() for k, v in model.state_dict().items()}

    def twin(impl, train=False, **kw):
        m_ = build_model(dataclasses.replace(cfg, attn_impl=impl, **kw),
                         "cuda", train=train)
        m_.load_state_dict(state)
        return m_

    eval_step = make_eval_step(int(yaml_cfg["ignore_label"]),
                               cfg.num_classes)
    b = to_device(hb, dev)
    eval_step(model, b)                         # first call: lazy set-up
    schedule = schedulers.from_config(yaml_cfg, TRAIN_ITERS_PER_EPOCH)[0]
    train_step = make_train_step(int(yaml_cfg["ignore_label"]),
                                 cfg.num_classes)

    def step(impl, **kw):
        m_ = twin(impl, train=True, **kw)
        opt = make_optimizer(
            m_, schedule, weight_decay=float(yaml_cfg["weight_decay"]),
            transformer_lr_scale=float(yaml_cfg["transformer_lr_scale"]))
        stats = train_step(m_, opt, b,
                           torch.Generator(device="cuda").manual_seed(1))
        return float(stats["loss"]), {
            n_: p_.grad.clone() for n_, p_ in m_.named_parameters()}

    step("fused")                               # set-up (cuBLAS, autograd)
    torch.cuda.synchronize()
    for m_ in fast_mods.values():
        m_.KERNEL.launches = 0
    before = counts()
    logits = eval_step(model, b)[0]
    loss_k, grads_k = step("fused")
    torch.cuda.synchronize()
    per = {k: counts()[k] - before[k] for k in before}
    # the forward kernel in the eval forward and the step, the backward in
    # the step
    want = dict.fromkeys(per, 0)
    fwd_name, bwd_name = fast_mods
    want.update({fwd_name: 24, bwd_name: 12})
    if per != want:
        raise AssertionError(f"fast swin forward and step launches {per}, "
                             f"expected {want}")
    # the controls: the same forward and step on the fp32 kernels
    before = counts()
    logits_32 = eval_step(twin("fused", **FP32), b)[0]
    loss_32, grads_32 = step("fused", **FP32)
    per_32 = {k: counts()[k] - before[k] for k in before}
    want = dict.fromkeys(per_32, 0)
    want.update({"band_attention": 24, "band_attention_bwd": 12})
    if per_32 != want:
        raise AssertionError(f"fp32 swin forward and step launches "
                             f"{per_32}, expected {want}")
    before = counts()
    logits_p = eval_step(twin("reference"), b)[0]
    with plain_in_kernel_slices(dev):
        loss_p, grads_p = step("reference")
    if counts() != before:
        raise AssertionError("the plain fast swin model launched a kernel")
    err, control = rel_l2(logits, logits_p), rel_l2(logits_32, logits_p)
    fast_gate("swin fast logits", err, FAST_LOGITS_REL_L2, control)
    for name, gp in grads_p.items():
        diff = float((grads_k[name] - gp).norm())
        bound = (FAST_STEP_GRAD_REL_L2 * float(gp.norm())
                 + GRAD_FLOOR * gp.numel() ** 0.5)
        if not diff <= bound:
            msg = (f"swin fast step-1 grad {name}: |kernel - plain| "
                   f"{diff:.3e} > {bound:.3e}")
            log(f"[fast] FAILED {msg}")
            FAST_FAILURES.append(msg)
    flat = [torch.cat([g[n_].flatten() for n_ in grads_p])
            for g in (grads_k, grads_p, grads_32)]
    total, total_32 = rel_l2(flat[0], flat[1]), rel_l2(flat[2], flat[1])
    fast_gate("swin fast step-1 grads, all parameters", total,
              FAST_SWIN_STEP_ALL_REL_L2, total_32)
    np.testing.assert_allclose(loss_k, loss_p, rtol=LOSS_RTOL,
                               err_msg="swin fast step-1 loss")
    out = {"launches": {k: per[k] for k in fast_mods},
           "logits_rel_l2": err, "fp32_logits_rel_l2": control,
           "grads_rel_l2": total, "fp32_grads_rel_l2": total_32,
           "loss": loss_k, "plain_loss": loss_p, "fp32_loss": loss_32}
    log(f"[swin] (f) default precision: one forward and one train step, "
        f"launches {out['launches']} (none of the fp32 forms); against the "
        f"plain fast versions: logits relative L2 {err:.2e} (gate "
        f"{FAST_LOGITS_REL_L2}; the fp32 kernels' {control:.2e}: control), "
        f"step-1 gradients {total:.2e} (gate {FAST_SWIN_STEP_ALL_REL_L2}; "
        f"fp32 kernels {total_32:.2e}: control); loss {loss_k:.6f} (plain "
        f"{loss_p:.6f}, fp32 kernels {loss_32:.6f})")
    return out


def swin_phase(dev):
    """Phase 15: the Swin3D family (module docstring): (a) the quantized
    positions and the swin bins on the card, (b)/(f) the band kernels' swin
    mode and its fast form against the plain versions, (c) S3DIS and (d)
    ScanNet Swin3D at full width against the plain-version models (and (d)'s
    kernels as (b)/(f) under ``scannet_report``), (e) the
    train and eval drivers on the shipped S3DIS Swin YAML, (f) the same
    YAML at ``default`` precision on the fast kernels. Returns the numbers
    and the kernels' report under ``report``."""
    from stratified_transformer_torch.config import load_config
    from stratified_transformer_torch.data.loader import host_batch
    from stratified_transformer_torch.kernels import band_attention as band_k
    from stratified_transformer_torch.models.attention import swin_positions
    from stratified_transformer_torch.ops import attention as plain
    t_phase = time.time()
    FAST_FAILURES.clear()
    log(f"[swin] phase 15: configs/s3dis_swin3d.yaml and "
        f"configs/scannetv2_swin3d.yaml ({PIN_NOTE}; (f) at default)")
    all_mods = attention_kernel_modules()
    band_mods = {k: all_mods[k] for k in ("band_attention",
                                          "band_attention_bwd")}
    yaml_cfg = yaml_fp32(SWIN_CONFIG)
    cfg = load_config(SWIN_CONFIG, n_pad=N_PAD, num_scenes=SCENES, **FP32)
    if cfg.use_stratified or cfg.rpe_mode != "swin_window" or (
            cfg.attn_impl != "fused"):
        raise AssertionError(f"the S3DIS Swin YAML reads as {cfg}")
    hbs = [host_batch(cfg, seed=s) for s in range(EVAL_BATCHES)]
    if hbs[0]["pyramid"]["stage_down"] != ():
        raise AssertionError("a Swin3D host pyramid with member masks")
    out = {}

    # (a) positions and bins: the card against the CPU
    levels = stage_levels(cfg, hbs[0])
    n_u = 0
    for i in stages(cfg):
        ws, qs = cfg.window_sizes()[i], cfg.quant_sizes()[i]
        for shifted in (False, True):
            us = []
            for where in (dev, "cpu"):
                plan = build_plan(cfg, i, levels[i], shifted, where)
                us.append((plan.order, swin_positions(
                    plan.xyz_sorted, plan.grid_start,
                    ws / 2.0 if shifted else 0.0, ws, qs)))
            for a, b in zip(us[0], us[1]):
                if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
                    raise AssertionError(f"stage {i} shifted={shifted}: "
                                         "swin positions differ between the "
                                         "card and the CPU")
            n_u += us[1][1].numel()
        qgl = int(ws / qs)
        rel = torch.arange(-qgl - 2, qgl + 3, dtype=torch.float32)
        got = band_k.rel_bins(rel.to(dev), ws, qs, 2 * qgl - 1,
                              rpe_mode="swin_window").cpu().long()
        want = plain.swin_relative_position_index(rel, 2 * qgl - 1)
        if not torch.equal(got, want):
            raise AssertionError(f"stage {i}: swin bins on the card {got} "
                                 f"vs {want}")
    log(f"[swin] (a) {n_u} quantized coordinates (4 stages x 2 parities) "
        "bit-identical between the card and the CPU; the swin bin probe on "
        "every integer rel in [-qgl-2, qgl+2] == "
        "swin_relative_position_index")

    # (b) and (f): the kernels
    report = new_report(SWIN_KERNELS + SWIN_FAST_KERNELS)
    swin_kernels(cfg, levels, dev, report)
    out["report"] = report

    # (c) S3DIS Swin3D at full width
    train_hbs = [host_batch(cfg, seed=10 + s, train=True,
                            rng=np.random.default_rng(100 + s), aug=yaml_cfg)
                 for s in range(TRAIN_STEPS)]
    for m_ in all_mods.values():
        m_.KERNEL.launches = 0
    out["s3dis"] = swin_model("[swin-s3dis]", cfg, yaml_cfg, hbs, train_hbs,
                              dev, band_mods, all_mods)
    main_launches = {k: m_.KERNEL.launches for k, m_ in all_mods.items()}
    if not (main_launches["band_attention"]
            and main_launches["band_attention_bwd"]) or (
                main_launches["sparse_band_attention"]
                or main_launches["sparse_band_attention_bwd"]):
        raise AssertionError(f"swin main path launches {main_launches}")
    out["launches"] = main_launches
    del train_hbs

    # (d) ScanNet Swin3D at phase 12's batch shape
    syaml = yaml_fp32(SCANNET_SWIN_CONFIG)
    scfg = load_config(SCANNET_SWIN_CONFIG, num_scenes=2, **FP32)
    t0 = time.time()
    shb = host_batch(scfg, seed=0, **SCANNET_ROOMS)
    log(f"[swin] scannet: batch n_pad {scfg.n_pad}, 2 slots, "
        f"{int(shb['offsets'][-1])} valid points, built in "
        f"{time.time() - t0:.2f} s")
    out["scannet"] = swin_model("[swin-scannet]", scfg, syaml, [shb], [shb],
                                dev, band_mods, all_mods)
    # its kernels at the batch's plans: CUDA-event times and bounds
    sreport = new_report(SWIN_KERNELS + SWIN_FAST_KERNELS)
    swin_kernels(scfg, stage_levels(scfg, shb), dev, sreport, "ScanNet")
    out["scannet_report"] = sreport
    del shb

    # (e) the drivers
    out["drivers"] = swin_drivers(band_mods, all_mods)

    # (f) the S3DIS Swin YAML at default precision: the fast kernels, one
    # eval forward and one train step
    out["fast"] = swin_fast_model(hbs[0], dev, band_mods, all_mods)
    out["seconds"] = time.time() - t_phase
    log(f"[swin] phase 15 in {out['seconds']:.0f} s")
    if FAST_FAILURES:
        raise AssertionError(f"phase 15: {len(FAST_FAILURES)} fast gates or "
                             f"controls failed: {FAST_FAILURES}")
    return out


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
    from stratified_transformer_torch.utils.config import merge_cfg_from_list
    log(f"[loop] phase 11: {PIN_NOTE}")

    def counts():
        return {k: m_.KERNEL.launches for k, m_ in kernel_mods.items()}

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        yaml_cfg = merge_cfg_from_list(yaml_fp32(CONFIG), LOOP_OVERRIDES + [
            "save_path", os.path.join(tmp, "run")])
        cfg = from_cfg(yaml_cfg)
        seed = int(yaml_cfg["manual_seed"])
        model, summary, out["loop_s"] = run_loop(
            "[loop]", yaml_cfg, kernel_mods, attention_blocks(cfg))
        out["launches"] = counts()
        out["peak_gib"] = memory_use()["cuda:0"]["peak_bytes_gb"]
        steps, vals = summary["steps"], summary["val_forwards"]
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
    device time per call (`profiled_busy_ms`). Then phase 5's eval forward
    (phase 2's batch, full width) with each form, in turns over ``rounds``
    rounds, synchronized host wall per forward."""
    from stratified_transformer_torch.config import from_cfg
    from stratified_transformer_torch.data.loader import to_device
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.train import metrics
    from stratified_transformer_torch.train.step import make_eval_step
    from stratified_transformer_torch.utils.config import merge_cfg_from_list

    forms = {"scatter_add": metrics.intersection_and_union,
             "bincount": bincount_iou}
    loop_n = from_cfg(merge_cfg_from_list(yaml_fp32(CONFIG),
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
                         "device_ms": profiled_busy_ms(lambda: fn(*args),
                                                       20)}
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


# phase 16: data-parallel training. (b) and (c) split phase 11's batch shape
# (max_batch_points 140000 in batch_size 8 slots) over two ranks on the one
# card: n_pad 70016 and 4 scene slots each, joined over gloo (NCCL refuses
# two ranks on one device: "Duplicate GPU detected"). (c) is the training
# driver's rank function for one epoch of 2 steps (16 synthetic rooms of
# 60000 raw points, 8 per global batch) and one validation
DP_WORLD = 2
DP_OVERRIDES = [
    "data_name", "synthetic", "max_batch_points", "140000", "batch_size", "8",
    "voxel_max", "80000", "synthetic_points", "60000", "synthetic_scenes",
    "16", "epochs", "1", "evaluate", "True", "print_freq", "1",
    "use_tensorboard", "False", "n_devices", str(DP_WORLD)]
# (b): kernel-path DP steps timed per rank after the checked one, and
# gradient all-reduces timed alone
DP_TIMED_STEPS = 3
DP_ALL_REDUCES = 3
# the ranks' rendezvous and every collective wait at most this long
DP_TIMEOUT_S = 300
# the S3DIS model's five parameters whose gradient is 0 in exact arithmetic
# (GRAD_FLOOR's: a shift of the head's input that the training BatchNorm
# removes): the first AdamW step moves them by lr times the sign of fp32
# noise, so (b) holds them within 2.02 lr of the one-device step
ZERO_GRAD_BIASES = ("up_2.norm1.bias", "up_2.norm2.bias",
                    "up_2.linear1.bias", "up_2.linear2.bias",
                    "cls_fc1.bias")
# ... and only while their gradients are fp32 noise below this (as the CPU
# test `tests/test_torch_dp.py::assert_params_close` requires)
ZERO_GRAD_MAX = 1e-7


def sync(dev):
    """Wait for ``dev`` (a CUDA device; nothing on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def release(dev):
    """Hand ``dev``'s cached blocks back to the card, for the ranks that
    share it (nothing on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def state_tensors(model, optimizer):
    """``model``'s state (parameters, BatchNorm statistics) and
    ``optimizer``'s moments, by name, on the CPU."""
    out = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    names = {id(p): n for n, p in model.named_parameters()}
    for p, s in optimizer.state.items():
        for key, t in s.items():
            out[f"{names[id(p)]}/{key}"] = t.detach().cpu().clone()
    return out


def assert_same_tensors(label, got, want):
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    if set(got) != set(want) or differ:
        raise AssertionError(f"{label}: {len(differ)} of {len(want)} "
                             f"tensors differ ({differ[:5]})")


def dp_world_one(dev):
    """Phase 16 (a): two S3DIS training steps at phase 2's batch shape
    (phase 8's augmented batches) through the one-device step and through
    the collectives of the data-parallel step in a one-rank NCCL group on
    ``cuda:0``, from the same `o1_weights`, with PyTorch's deterministic
    algorithms (its default CUDA ``index_add_`` orders its float atomics
    differently from run to run): the one-device step twice (the control:
    bit-identical), then the DP path with every reduction forced, which
    `parallel.dp.make_dp_train_step` skips at one rank: SyncBN on
    (``bn_axis_name`` "data"), `parallel.dp.all_reduce_grads` in the step
    and the packed statistics all-reduced. A sum over one rank and the
    division by 1 are exact, so the parameters, statistics and AdamW state
    must be bit-identical to the one-device steps'; NCCL's all-reduce on
    CUDA tensors, SyncBN's autograd function and the flattened gradient
    buffer run on the card."""
    from stratified_transformer_torch.config import load_config
    from stratified_transformer_torch.data.loader import host_batch, to_device
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.parallel import mesh
    from stratified_transformer_torch.parallel.dp import all_reduce_grads
    from stratified_transformer_torch.train import driver
    from stratified_transformer_torch.train.step import (
        make_train_step, pack_stats)
    cfg = load_config(CONFIG, n_pad=N_PAD, num_scenes=SCENES, **FP32)
    yaml_cfg = yaml_fp32(CONFIG)
    batches = [to_device(host_batch(
        cfg, seed=10 + s, train=True, rng=np.random.default_rng(100 + s),
        aug=yaml_cfg), dev) for s in range(2)]
    init = build_model(cfg, dev, seed=0)
    o1_weights(init, seed=0)
    init = init.state_dict()
    ignore = int(yaml_cfg["ignore_label"])
    one_device = make_train_step(ignore, cfg.num_classes)
    reduced = make_train_step(ignore, cfg.num_classes,
                              reduce_grads=all_reduce_grads)

    def two_steps(step, cfg=cfg):
        model = build_model(cfg, dev, seed=0, train=True)
        model.load_state_dict(init)
        opt = driver.build_optimizer(model, yaml_cfg, TRAIN_ITERS_PER_EPOCH)
        packed = [step(model, opt, b, driver.drop_path_generator(
            dev, yaml_cfg["manual_seed"], s)) for s, b in enumerate(batches)]
        sync(dev)
        return state_tensors(model, opt), [p.cpu() for p in packed]

    def single(m_, o_, b, g):
        return pack_stats(one_device(m_, o_, b, g))

    def dp(m_, o_, b, g):
        packed = pack_stats(reduced(m_, o_, b, g))
        torch.distributed.all_reduce(packed)
        return packed

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want, want_packed = two_steps(single)
        control, _ = two_steps(single)
        mesh.init_group(0, 1, dev, mesh.free_port(), timeout_s=DP_TIMEOUT_S)
        try:
            backend = torch.distributed.get_backend()
            got, got_packed = two_steps(dp, dataclasses.replace(
                cfg, bn_axis_name="data"))
        finally:
            torch.distributed.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
    assert_same_tensors("(a) the one-device step run twice", control, want)
    assert_same_tensors("(a) the DP step at world size 1", got, want)
    if not all(torch.equal(a, b) for a, b in zip(got_packed, want_packed)):
        raise AssertionError("(a) the DP step's statistics differ")
    log(f"[dp] (a) world size 1 ({backend}, {dev}): 2 steps at N {N_PAD} "
        "through SyncBN's, the gradients' and the statistics' all-reduces "
        f"bit-identical to the one-device steps in all {len(want)} "
        "parameters, statistics and AdamW moments (deterministic algorithms;"
        " the one-device steps repeat bit for bit)")
    return {"backend": backend, "tensors": len(want),
            "losses": [float(p[0]) for p in got_packed]}


def nccl_pair_rank(rank, world, port, dev):
    """A rank of `nccl_pair`: joins an NCCL group on ``dev`` (which forms
    its communicator at once) and sums one value."""
    sys.path.insert(0, REPO)
    from stratified_transformer_torch.parallel import mesh
    mesh.init_group(rank, world, dev, port, timeout_s=60)
    try:
        t = torch.ones(1, device=dev)
        torch.distributed.all_reduce(t)
        sync(dev)
    finally:
        torch.distributed.destroy_process_group()


def nccl_pair(dev):
    """Whether NCCL forms a group of two ranks on the one card ``dev``:
    "formed", or the last line of the error it raises."""
    from stratified_transformer_torch.parallel import mesh
    try:
        mesh.spawn(nccl_pair_rank, 2, args=(2, mesh.free_port(), dev),
                   timeout_s=120)
    except Exception as e:              # the answer, recorded
        return "refused: " + str(e).strip().splitlines()[-1][:200]
    return "formed"


def dp_job(tmp, dev):
    """(b)'s job: the per-rank configuration of DP_OVERRIDES, `o1_weights`,
    and each rank's share of the first batch of the DP loaders."""
    from stratified_transformer_torch.config import from_cfg
    from stratified_transformer_torch.data.loader import (
        BatchLoader, build_dataset)
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.utils.config import merge_cfg_from_list
    yaml_cfg = merge_cfg_from_list(yaml_fp32(CONFIG), DP_OVERRIDES + [
        "save_path", os.path.join(tmp, "run")])
    cfg = from_cfg(yaml_cfg, DP_WORLD)
    batches, iters = [], 0
    for r in range(DP_WORLD):
        bl = BatchLoader(build_dataset(yaml_cfg, "train"), cfg, yaml_cfg,
                         shuffle=True, seed=int(yaml_cfg["manual_seed"]),
                         rank=r, world=DP_WORLD)
        itr = iter(bl)
        batches.append(next(itr))
        itr.close()
        iters = bl.batches_per_epoch
    model = build_model(cfg, dev, seed=0)
    o1_weights(model, seed=0)
    return {"yaml_cfg": dict(yaml_cfg), "cfg": cfg, "iters": iters,
            "init": {k: v.cpu() for k, v in model.state_dict().items()},
            "batches": batches}


def dp_steps_rank(rank, world, port, job_path, out, dev):
    """Phase 16 (b), rank ``rank`` of ``world`` on ``dev`` over gloo:
    one DP step (`parallel.dp.make_dp_train_step`, SyncBN on) through the
    kernels on rank 0's share for every rank (identical batches), then one
    on each rank's own share (distinct batches), its kernel launches
    counted, its averaged gradients held against the same DP step through
    the plain versions (`check_grads`); then DP_TIMED_STEPS kernel steps
    timed and the gradient all-reduce timed alone. Writes
    ``<out>/rank<rank>.pt``."""
    sys.path.insert(0, REPO)
    from stratified_transformer_torch.data.loader import to_device
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.parallel import dp, mesh
    from stratified_transformer_torch.train import driver
    mesh.init_group(rank, world, dev, port, backend="gloo",
                    timeout_s=DP_TIMEOUT_S)
    try:
        job = torch.load(job_path, weights_only=False)
        cfg, yaml_cfg = job["cfg"], job["yaml_cfg"]
        kernel_mods = attention_kernel_modules()
        step = dp.make_dp_train_step(int(yaml_cfg["ignore_label"]),
                                     cfg.num_classes)

        def counts():
            return {k: m_.KERNEL.launches for k, m_ in kernel_mods.items()}

        def trainer(impl):
            m_ = build_model(dataclasses.replace(cfg, attn_impl=impl),
                             dev, seed=0, train=True)
            m_.load_state_dict(job["init"])
            return m_, driver.build_optimizer(m_, yaml_cfg, job["iters"])

        def gen(s):
            return driver.drop_path_generator(dev, yaml_cfg["manual_seed"],
                                              s)

        res = {}
        model, opt = trainer("fused")
        step(model, opt, to_device(job["batches"][0], dev), gen(0))
        res["identical"] = {n: p.detach().cpu()
                            for n, p in model.named_parameters()}
        del model, opt
        batch = to_device(job["batches"][rank], dev)
        model, opt = trainer("fused")
        for m_ in kernel_mods.values():
            m_.KERNEL.launches = 0
        packed = step(model, opt, batch, gen(0))
        sync(dev)
        res["launches"] = counts()
        res["packed"] = packed.cpu()
        res["state"] = state_tensors(model, opt)
        grads_k = {n: p.grad.clone() for n, p in model.named_parameters()}
        plain, opt_p = trainer("reference")
        step(plain, opt_p, batch, gen(0))
        if counts() != res["launches"]:
            raise AssertionError("the plain-version DP step launched a "
                                 "kernel")
        res["grad_worst"] = check_grads(f"[dp] rank {rank} step 1", grads_k, {
            n: p.grad for n, p in plain.named_parameters()})
        del plain, opt_p, grads_k
        walls = []
        for s in range(1, DP_TIMED_STEPS + 1):
            sync(dev)
            t0 = time.perf_counter()
            step(model, opt, batch, gen(s))
            sync(dev)
            walls.append(1e3 * (time.perf_counter() - t0))
        reduces = []
        for _ in range(DP_ALL_REDUCES):
            sync(dev)
            t0 = time.perf_counter()
            dp.all_reduce_grads(model)
            sync(dev)
            reduces.append(1e3 * (time.perf_counter() - t0))
        res.update(step_wall_ms=walls, all_reduce_ms=reduces,
                   points=int(batch["offsets"][-1]),
                   grad_floats=sum(p.numel() for p in model.parameters()))
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def dp_driver_rank(rank, world, port, yaml_cfg, out, dev):
    """Phase 16 (c), rank ``rank`` of ``world`` on ``dev`` over gloo:
    `train.driver.run_rank` (rank 0's lines logged with ``[dp]``), its
    kernel launches and the host wall of each gradient all-reduce
    (`parallel.dp.all_reduce_grads` between synchronizations). Writes
    ``<out>/rank<rank>.pt``."""
    sys.path.insert(0, REPO)
    from stratified_transformer_torch.parallel import dp
    from stratified_transformer_torch.train import driver
    kernel_mods = attention_kernel_modules()
    reduces = []
    all_reduce_grads = dp.all_reduce_grads

    def timed(model):
        sync(dev)
        t0 = time.perf_counter()
        all_reduce_grads(model)
        sync(dev)
        reduces.append(1e3 * (time.perf_counter() - t0))

    dp.all_reduce_grads = timed
    for m_ in kernel_mods.values():
        m_.KERNEL.launches = 0
    model, summary = driver.run_rank(
        rank, world, yaml_cfg, dev, port,
        log=lambda msg: log(f"[dp] (c) rank 0: {msg[:300]}"),
        backend="gloo", timeout_s=DP_TIMEOUT_S)
    res = {"summary": summary, "all_reduce_ms": reduces, "launches": {
        k: m_.KERNEL.launches for k, m_ in kernel_mods.items()}}
    if rank == 0:
        res["model"] = {k: v.cpu() for k, v in model.state_dict().items()}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def dp_phase(dev):
    """Phase 16: data-parallel training (`parallel/`, SyncBN, the per-rank
    loader, `train/driver.py`'s rank function), fp32 kernels (`PIN_NOTE`):
    (a) `dp_world_one`; (b) `dp_steps_rank` on two ranks: with identical
    batches each rank's parameters within RTOL / ATOL of the one-device
    step on that batch (ZERO_GRAD_BIASES within 2.02 lr), with distinct
    batches the ranks' parameters, SyncBN statistics and AdamW moments
    bit-identical, one launch of each attention kernel per block on every
    rank, the gradients against the plain versions' on every rank; the DP
    step's wall per rank and the gradient all-reduce's share of it; (c)
    `dp_driver_rank` on two ranks: the ranks in one state at the end, the
    launches per rank (12 of each kernel per step; rank 0 alone
    validates), rank 0's checkpoint restored into a one-device model and
    optimizer bit for bit, the step walls and the all-reduce's share. Two
    ranks over gloo on one card: no forecast of NCCL across cards."""
    import tempfile

    from stratified_transformer_torch.config import from_cfg
    from stratified_transformer_torch.data.loader import to_device
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.parallel import mesh
    from stratified_transformer_torch.train import checkpoint, driver
    from stratified_transformer_torch.train.step import make_train_step
    t_phase = time.time()
    log(f"[dp] phase 16: {PIN_NOTE}")
    out = {"a": dp_world_one(dev)}
    if dev.type == "cuda":
        out["nccl_two_ranks_one_card"] = nccl_pair(dev)
        log(f"[dp] NCCL, two ranks on {dev}: "
            f"{out['nccl_two_ranks_one_card']} (so (b) and (c) join over "
            "gloo)")
    with tempfile.TemporaryDirectory() as tmp:
        # ---- (b) -----------------------------------------------------------
        job = dp_job(tmp, dev)
        cfg, yaml_cfg = job["cfg"], job["yaml_cfg"]
        blocks = attention_blocks(cfg)
        one = build_model(dataclasses.replace(cfg, bn_axis_name=None), dev,
                          seed=0, train=True)
        one.load_state_dict(job["init"])
        opt = driver.build_optimizer(one, yaml_cfg, job["iters"])
        make_train_step(int(yaml_cfg["ignore_label"]), cfg.num_classes)(
            one, opt, to_device(job["batches"][0], dev),
            driver.drop_path_generator(dev, yaml_cfg["manual_seed"], 0))
        want = {n: p.detach().cpu() for n, p in one.named_parameters()}
        zero_grads = max(float(one.get_parameter(n).grad.abs().max())
                         for n in ZERO_GRAD_BIASES)
        if not zero_grads < ZERO_GRAD_MAX:
            raise AssertionError(
                f"(b) the biases {ZERO_GRAD_BIASES} have gradients up to "
                f"{zero_grads:.2e}, not below {ZERO_GRAD_MAX}: they are not "
                "the zero-gradient parameters that 2.02 lr admits")
        del one, opt
        release(dev)
        job_path = os.path.join(tmp, "job.pt")
        torch.save(job, job_path)
        t0 = time.perf_counter()
        mesh.spawn(dp_steps_rank, DP_WORLD, args=(
            DP_WORLD, mesh.free_port(), job_path, tmp, dev),
            timeout_s=2 * DP_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(DP_WORLD)]
        lr = float(yaml_cfg["base_lr"])
        for r, res in enumerate(ranks):
            for name, w in want.items():
                got = res["identical"][name]
                if name in ZERO_GRAD_BIASES:
                    assert_close(f"(b) rank {r} {name}", got, w, 0.0,
                                 2.02 * lr)
                else:
                    assert_close(f"(b) rank {r} {name}", got, w, RTOL, ATOL)
            if res["launches"] != {k: blocks for k in res["launches"]}:
                raise AssertionError(f"(b) rank {r}: kernel launches "
                                     f"{res['launches']} in one DP step, "
                                     f"expected {blocks} each")
        for r in range(1, DP_WORLD):
            assert_same_tensors(f"(b) rank {r} against rank 0",
                                ranks[r]["state"], ranks[0]["state"])
        step_ms = [float(np.median(res["step_wall_ms"])) for res in ranks]
        reduce_ms = [float(np.median(res["all_reduce_ms"])) for res in ranks]
        out["b"] = {
            "n_pad": cfg.n_pad, "num_scenes": cfg.num_scenes,
            "points": [res["points"] for res in ranks],
            "psum_points": float(ranks[0]["packed"][3]),
            "launches": [res["launches"] for res in ranks],
            "grad_worst_rel_l2": [res["grad_worst"][0] for res in ranks],
            "grad_worst": [res["grad_worst"][1] for res in ranks],
            "zero_grad_biases_max_grad": zero_grads,
            "step_wall_ms": [res["step_wall_ms"] for res in ranks],
            "step_wall_ms_median": step_ms,
            "all_reduce_ms": [res["all_reduce_ms"] for res in ranks],
            "all_reduce_ms_median": reduce_ms,
            "all_reduce_share": [a / s for a, s in zip(reduce_ms, step_ms)],
            "grad_floats": ranks[0]["grad_floats"], "spawn_s": spawn_s}
        log(f"[dp] (b) {DP_WORLD} ranks on {dev} over gloo, n_pad "
            f"{cfg.n_pad} in {cfg.num_scenes} slots each ({out['b']['points']}"
            f" valid points; psum'd {out['b']['psum_points']:.0f}): identical "
            f"batches give the one-device step's parameters (rtol {RTOL} / "
            f"atol {ATOL}; the 5 zero-gradient biases, |grad| <= "
            f"{zero_grads:.1e}, within 2.02 lr); distinct batches leave the "
            "ranks' parameters, SyncBN statistics and AdamW moments "
            f"bit-identical; {blocks} launches of each attention kernel per "
            "rank; step-1 grads within "
            f"{GRAD_REL_L2} relative L2 of the plain versions' (largest "
            + ", ".join(f"{e:.2e}" for e in out['b']['grad_worst_rel_l2'])
            + ")")
        log(f"[dp] (b) DP step wall per rank (median of {DP_TIMED_STEPS}, "
            "synchronized): " + ", ".join(f"{s:.1f}" for s in step_ms)
            + f" ms; gradient all-reduce of {out['b']['grad_floats']} floats: "
            + ", ".join(f"{a:.1f}" for a in reduce_ms) + " ms, share "
            + ", ".join(f"{a / s:.1%}" for a, s in zip(reduce_ms, step_ms))
            + " (two ranks over gloo on one card)")
        iters = job["iters"]
        del job, ranks
        release(dev)

        # ---- (c) -----------------------------------------------------------
        t0 = time.perf_counter()
        mesh.spawn(dp_driver_rank, DP_WORLD, args=(
            DP_WORLD, mesh.free_port(), yaml_cfg, tmp, dev),
            timeout_s=2 * DP_TIMEOUT_S)
        loop_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(DP_WORLD)]
        summaries = [res["summary"] for res in ranks]
        digests = {s["state_sha256"] for s in summaries}
        if len(digests) != 1:
            raise AssertionError(f"(c) the ranks ended in different states: "
                                 f"{digests}")
        steps, vals = summaries[0]["steps"], summaries[0]["val_forwards"]
        if not (steps and vals):
            raise AssertionError(f"(c) {steps} steps, {vals} validation "
                                 "forwards")
        for r, res in enumerate(ranks):
            want_l = {k: blocks * steps + (blocks * vals if r == 0
                                           and k in FWD_KERNELS else 0)
                      for k in res["launches"]}
            if res["launches"] != want_l:
                raise AssertionError(f"(c) rank {r}: launches "
                                     f"{res['launches']}, expected {want_l}")
        fresh = build_model(dataclasses.replace(cfg, bn_axis_name=None),
                            dev, seed=1, train=True)
        opt = driver.build_optimizer(fresh, yaml_cfg, iters)
        _, epoch, _ = checkpoint.restore(os.path.join(tmp, "run", "ckpt"),
                                         fresh, opt)
        assert_same_tensors("(c) rank 0's checkpoint restored", {
            k: v.cpu() for k, v in fresh.state_dict().items()},
            ranks[0]["model"])
        if not (epoch == 1 and all(g["t"] == steps
                                   for g in opt.param_groups)):
            raise AssertionError(f"(c) restored epoch {epoch}, step "
                                 f"{[g['t'] for g in opt.param_groups]}")
        walls = [[1e3 * it["wall_s"] for it in s["iters"]]
                 for s in summaries]
        reduces = [res["all_reduce_ms"] for res in ranks]
        out["c"] = {
            "steps": steps, "val_forwards": vals, "loop_s": loop_s,
            "launches": [res["launches"] for res in ranks],
            "step_wall_ms": walls, "all_reduce_ms": reduces,
            "all_reduce_share": [sum(a) / sum(w) for a, w in zip(reduces,
                                                                 walls)],
            "losses": [it["loss"] for it in summaries[0]["iters"]],
            "points": [it["points"] for it in summaries[0]["iters"]],
            "timing": summaries[0]["timing"],
            "records": summaries[0]["records"]}
        log(f"[dp] (c) the training driver's rank function on {DP_WORLD} "
            f"ranks (gloo, {dev}): {steps} steps and {vals} validation "
            f"forwards in {loop_s:.1f} s; the ranks end in one state; launches"
            f" {out['c']['launches']}; rank 0's checkpoint restores into a "
            "one-device model and optimizer bit for bit; step walls "
            + "; ".join("rank " + str(r) + " " + ", ".join(
                f"{w:.0f}" for w in ws) + " ms" for r, ws in enumerate(walls))
            + "; all-reduce share "
            + ", ".join(f"{s:.1%}" for s in out["c"]["all_reduce_share"])
            + " (two ranks over gloo on one card)")
        del fresh, opt
    out["seconds"] = time.time() - t_phase
    log(f"[dp] phase 16 in {out['seconds']:.0f} s")
    return out


# phase 17: sharded whole-scene inference (`parallel/halo.py`,
# `eval/voting.py::evaluate_scene_sharded`, the eval driver's `sharded*`
# keys), fp32 kernels. (b) runs the JAX test's corridor
# (tests/test_halo.py:79-115: 10000 points in 32 m, the 2-stage model) on
# HALO_WORLD gloo ranks on the one card, at heads (1, 2): the kernels' head
# size is 16. (c) and (d) run phase 10's room through the eval driver on
# HALO_DRIVER_WORLD gloo ranks (NCCL refuses two ranks on one device).
HALO_WORLD = 4
HALO_DRIVER_WORLD = 2
HALO_TIMEOUT_S = 600
# (a)-(c): max |dprob| of the sharded paths against the whole-scene (or
# whole-chunk) forward, all through the kernels, where the halo covers the
# receptive field: the block's valid rows reach the forward in the whole
# forward's order, and only the pad (hence the level capacities and the
# dense layers' row counts) differs. Stated before the first run: the
# ceiling of 1e-5 (readings expected below 1e-6).
HALO_EXACT = 1e-5
# (b): the sub-window halo of the JAX test's control; its error must
# exceed 100 x HALO_EXACT
HALO_SUB = 0.05
# (c): TTA passes of phase 10's seven run through the driver (and through
# the serial sphere-crop protocol beside it). All seven took 141 s through
# the driver and 81 s through the serial protocol on an H100 (222 s of
# (c)); three keep the script's time in bounds
HALO_PASSES = 3
# (e): the points of the S3DIS-format room the entry point reads
HALO_CLI_POINTS = 40000


def corridor_scene(n_scene=10000, seed=123):
    """``tests/test_halo.py::_real_model_setup``'s corridor: a 32 x 1.5 m
    floor and two 32 x 0.3 m walls (``(coord, feat)``)."""
    rng = np.random.default_rng(seed)
    nf, nw = (3 * n_scene) // 4, n_scene // 8
    f = rng.uniform(0, 1, (nf, 3)) * [32.0, 1.5, 0.02]
    w1 = rng.uniform(0, 1, (nw, 3)) * [32.0, 0.02, 0.3]
    w2 = rng.uniform(0, 1, (nw, 3)) * [32.0, 0.02, 0.3] + [0, 1.48, 0]
    coord = np.concatenate([f, w1, w2]).astype(np.float32)
    feat = rng.normal(size=(len(coord), 3)).astype(np.float32)
    return coord, feat


def corridor_config():
    """The JAX test's corridor model (2 stages, grid 0.1, windows 0.25 /
    0.5 m, ``down_quota`` cells) at heads (1, 2), fp32."""
    from stratified_transformer_torch.config import StratifiedConfig
    return StratifiedConfig(
        num_classes=5, in_channels=6, n_pad=0, num_scenes=1, depths=(1, 1),
        channels=(16, 32), num_heads=(1, 2), num_layers=2, grid_size=0.1,
        window_size=2.5, patch_size=1, quant_size=0.025, downsample_scale=4,
        band=128, tile=128, sparse_cap=64, sampler="grid",
        down_quota="cells", neighbor_method="grid", stem_transformer=True,
        drop_path_rate=0.0, **FP32)


def round_tile(n, tile=128):
    return (int(n) + tile - 1) // tile * tile


def whole_probs(model, coord, feat, n_pad=None, concat_xyz=True):
    """The whole-scene (or whole-chunk) forward through ``model`` anchored
    at the origin, as `parallel.halo` anchors its blocks, at the flat
    capacity ``n_pad`` (default: the points rounded up to a tile): numpy
    probabilities of the valid rows. The samplers keep at most a level's
    capacity (``int(n_pad * ratio) + 1`` rounded to a tile) of grid cells,
    so a capacity that binds makes the result depend on ``n_pad``."""
    from stratified_transformer_torch.parallel import halo
    dev = next(model.parameters()).device
    n = len(coord)
    c = coord - coord.min(0)
    f = np.concatenate([feat, c], 1) if concat_xyz else feat
    n_pad = n_pad or round_tile(n)
    feats = torch.zeros((n_pad, f.shape[1]), device=dev)
    xyz = torch.zeros((n_pad, 3), device=dev)
    feats[:n] = torch.from_numpy(np.asarray(f, np.float32)).to(dev)
    xyz[:n] = torch.from_numpy(np.asarray(c, np.float32)).to(dev)
    off = torch.tensor([n], device=dev)
    return halo.block_predict(model)(feats, xyz, off)[:n].cpu().numpy()


def checked_predict(model, ref_model, errors):
    """`parallel.halo.block_predict` of ``model`` that holds each block's
    logits against ``ref_model``'s (the plain versions) on the same block,
    phase 5's LOGIT_RTOL / LOGIT_ATOL, and appends the worst error."""
    dev = next(model.parameters()).device
    anchor = torch.zeros(3, device=dev)

    @torch.inference_mode()
    def predict(feats, xyz, offsets):
        logits = model(feats, xyz, offsets, anchor=anchor)[0]
        want = ref_model(feats, xyz, offsets, anchor=anchor)[0]
        n = int(offsets[-1])
        assert_close(f"block of {n} points, kernels vs plain versions",
                     logits[:n], want[:n], LOGIT_RTOL, LOGIT_ATOL)
        errors.append(max_errors(logits[:n], want[:n])[0])
        return torch.softmax(logits, -1)
    return predict


def halo_calls(paths, predict, coord, feat, ncls, dev):
    """Run ``paths`` (``{key: (host | collective, keywords)}``) through
    `parallel.halo`; returns ``{key: {"probs", "stats", "s"}}``."""
    from stratified_transformer_torch.parallel import halo
    out = {}
    for key, (name, kw) in paths.items():
        fn = (halo.sharded_scene_probs if name == "host"
              else halo.sharded_scene_probs_collective)
        stats = {}
        sync(dev)
        t0 = time.perf_counter()
        probs = fn(predict, coord, feat, ncls, device=dev, stats=stats, **kw)
        out[key] = {"probs": probs, "stats": stats,
                    "s": time.perf_counter() - t0}
    return out


def halo_world_one(dev, model, ref_model, coord, feat):
    """Phase 17 (a): one chunk (the first vote chunk of phase 10's room)
    through host replication and both exchanges, every collective forced
    in a one-rank NCCL group on ``dev`` (the gather of the core
    probabilities, the band / slab gathers, the drop count's sum), against
    the whole-chunk forward, all through the kernels and at one flat
    capacity (the exchange's block): within HALO_EXACT of each other, 12 +
    12 launches per forward."""
    from stratified_transformer_torch.parallel import mesh
    blocks = attention_blocks(model.cfg)
    n = len(coord)
    pad = round_tile(n)
    b_pad = pad + 2 * 128
    errors = []
    predict = checked_predict(model, ref_model, errors)
    mods = attention_kernel_modules()
    for m_ in mods.values():
        m_.KERNEL.launches = 0
    want = whole_probs(model, coord, feat, b_pad)
    coll = dict(core_pad=pad, halo_cap=128, halo=1.0)
    paths = {"host": ("host", dict(n_pad=b_pad, halo=1.0)),
             "ppermute": ("collective", dict(coll, mode="ppermute")),
             "allgather": ("collective", dict(coll, mode="allgather"))}
    mesh.init_group(0, 1, dev, mesh.free_port(), timeout_s=HALO_TIMEOUT_S)
    try:
        backend = torch.distributed.get_backend()
        got = halo_calls(paths, predict, coord, feat, model.cfg.num_classes,
                         dev)
    finally:
        torch.distributed.destroy_process_group()
    launches = {k: m_.KERNEL.launches for k, m_ in mods.items()}
    forwards = 1 + len(errors)
    want_l = {k: blocks * forwards if k in FWD_KERNELS else 0
              for k in launches}
    if launches != want_l:
        raise AssertionError(f"(a) launches {launches}, expected {want_l}")
    err = {k: float(np.abs(v["probs"] - want).max()) for k, v in got.items()}
    err["host_vs_collective"] = float(max(
        np.abs(got["host"]["probs"] - got[m]["probs"]).max()
        for m in ("ppermute", "allgather")))
    log(f"[halo] (a) one rank ({backend}, {dev}), every collective forced, "
        f"one {n}-point chunk at full width: max |dprob| against the "
        "whole-chunk forward " + ", ".join(f"{k} {v:.2e}"
                                           for k, v in err.items())
        + f" (gate {HALO_EXACT}); blocks vs plain versions max abs "
        f"{max(errors):.2e}; launches {launches}")
    if max(err.values()) > HALO_EXACT:
        raise AssertionError(f"(a) sharded paths against the whole chunk: "
                             f"{err}")
    return {"backend": backend, "points": n, "max_abs_dprob": err,
            "launches": launches, "forwards": forwards,
            "block_vs_plain_max_abs": max(errors)}


def halo_corridor_rank(rank, world, port, job_path, out, dev):
    """Phase 17 (b), rank ``rank`` of ``world`` on ``dev`` over gloo: the
    job's paths on the corridor through `checked_predict` (every block
    forward held against the plain versions); writes
    ``<out>/rank<rank>.pt`` with the results, the kernel launches and the
    block forwards."""
    sys.path.insert(0, REPO)
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.parallel import mesh
    mesh.init_group(rank, world, dev, port, backend="gloo",
                    timeout_s=HALO_TIMEOUT_S)
    try:
        job = torch.load(job_path, weights_only=False)
        cfg = job["cfg"]
        model = build_model(cfg, dev)
        ref = build_model(dataclasses.replace(cfg, attn_impl="reference"),
                          dev)
        model.load_state_dict(job["state"])
        ref.load_state_dict(job["state"])
        mods = attention_kernel_modules()
        for m_ in mods.values():
            m_.KERNEL.launches = 0
        errors = []
        res = halo_calls(job["paths"], checked_predict(model, ref, errors),
                         job["coord"], job["feat"], cfg.num_classes, dev)
        res["launches"] = {k: m_.KERNEL.launches for k, m_ in mods.items()}
        res["forwards"] = len(errors)
        res["block_vs_plain_max_abs"] = max(errors)
    finally:
        torch.distributed.destroy_process_group()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def halo_corridor(dev, tmp):
    """Phase 17 (b): the corridor on HALO_WORLD gloo ranks on the card:
    host replication, ``ppermute`` and ``allgather`` (at the JAX test's
    capacities) within HALO_EXACT of the whole-scene forward through the
    kernels, with no halo point truncated or dropped; the sub-window halo
    (HALO_SUB) beyond 100 x HALO_EXACT; every block forward against the
    plain versions; the ranks' results identical."""
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.parallel import halo, mesh
    cfg = corridor_config()
    coord, feat = corridor_scene()
    n = len(coord)
    model = build_model(cfg, dev)
    o1_weights(model, seed=0)
    want = whole_probs(model, coord, feat)
    hw = halo.receptive_halo(cfg)
    core_pad = round_tile(n // 4 + 128)
    halo_cap = round_tile(n // 8)
    wide = max(float(np.diff(np.quantile(
        coord[:, 0], np.linspace(0, 1, HALO_WORLD + 1)))[1:-1].min()) * 1.2,
        hw)
    coll = dict(core_pad=core_pad, halo_cap=halo_cap)
    paths = {
        "host": ("host", dict(n_pad=round_tile(n // 2), halo=hw)),
        "host_sub": ("host", dict(n_pad=round_tile(n // 2), halo=HALO_SUB)),
        "ppermute": ("collective", dict(coll, halo=hw)),
        "ppermute_sub": ("collective", dict(coll, halo=HALO_SUB)),
        "allgather": ("collective", dict(core_pad=core_pad,
                                         halo_cap=round_tile(0.45 * n),
                                         halo=wide))}
    job_path = os.path.join(tmp, "corridor.pt")
    torch.save({"cfg": cfg, "state": {k: v.cpu() for k, v in
                                      model.state_dict().items()},
                "coord": coord, "feat": feat, "paths": paths}, job_path)
    del model
    release(dev)
    t0 = time.perf_counter()
    mesh.spawn(halo_corridor_rank, HALO_WORLD, args=(
        HALO_WORLD, mesh.free_port(), job_path, tmp, dev),
        timeout_s=2 * HALO_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(HALO_WORLD)]
    for r, res in enumerate(ranks[1:], 1):
        for key in paths:
            if not np.array_equal(res[key]["probs"], ranks[0][key]["probs"]):
                raise AssertionError(f"(b) {key}: rank {r} differs from "
                                     "rank 0")
    blocks = attention_blocks(cfg)
    for r, res in enumerate(ranks):
        want_l = {k: blocks * res["forwards"] if k in FWD_KERNELS else 0
                  for k in res["launches"]}
        if res["launches"] != want_l:
            raise AssertionError(f"(b) rank {r}: launches {res['launches']},"
                                 f" expected {want_l}")
    got = ranks[0]
    err = {k: float(np.abs(got[k]["probs"] - want).max()) for k in paths}
    exact = max(err[k] for k in ("host", "ppermute", "allgather"))
    dropped = {"host": got["host"]["stats"]["truncated_halo_points"],
               "ppermute": got["ppermute"]["stats"]["halo_cap_dropped"],
               "allgather": got["allgather"]["stats"]["halo_cap_dropped"]}
    modes = {k: [m for m in ("ppermute", "allgather")
                 if got[k]["stats"].get(f"collective_{m}_scenes")]
             for k in ("ppermute", "allgather")}
    out = {"points": n, "halo": hw, "wide_halo": wide, "core_pad": core_pad,
           "halo_cap": halo_cap, "max_abs_dprob": err, "dropped": dropped,
           "modes": modes, "spawn_s": spawn_s,
           "forwards": [res["forwards"] for res in ranks],
           "launches": [res["launches"] for res in ranks],
           "block_vs_plain_max_abs": max(res["block_vs_plain_max_abs"]
                                         for res in ranks),
           "seconds": {k: got[k]["s"] for k in paths}}
    log(f"[halo] (b) corridor ({n} points, halo {hw:.2f} m) on {HALO_WORLD} "
        f"gloo ranks on {dev}: max |dprob| against the whole-scene forward "
        + ", ".join(f"{k} {v:.2e}" for k, v in err.items())
        + f" (gate {HALO_EXACT}, controls beyond {100 * HALO_EXACT}); "
        f"dropped {dropped}; modes {modes}; block forwards "
        f"{out['forwards']}, vs plain versions max abs "
        f"{out['block_vs_plain_max_abs']:.2e}; {spawn_s:.1f} s")
    if exact > HALO_EXACT or any(dropped.values()):
        raise AssertionError(f"(b) sharded paths against the whole scene: "
                             f"{err}, dropped {dropped}")
    if min(err["host_sub"], err["ppermute_sub"]) <= 100 * HALO_EXACT:
        raise AssertionError(f"(b) the sub-window controls do not bite: "
                             f"{err}")
    if modes != {"ppermute": ["ppermute"], "allgather": ["allgather"]}:
        raise AssertionError(f"(b) exchange modes {modes}")
    return out


def halo_driver_rank(rank, world, port, yaml_cfg, passes, out, dev):
    """Phase 17 (c), (d), rank ``rank`` of ``world`` on ``dev`` over gloo:
    `eval.driver.run_rank` with ``sharded`` on the first ``passes`` TTA
    passes, rank 0's lines kept. Records each block forward's device wall
    (synchronized), each collective's (the exchange's gathers and the sums
    of the drop counts and the core probabilities), the first chunk's
    probabilities and block (whose truncation counters it counts on the
    block's grid, `train.audit`), the scene's prediction, and the kernel
    launches. Writes ``<out>/rank<rank>.pt``."""
    sys.path.insert(0, REPO)
    from stratified_transformer_torch.eval import driver, voting
    from stratified_transformer_torch.models.stratified import (
        geometry_pyramid)
    from stratified_transformer_torch.parallel import halo
    from stratified_transformer_torch.train import audit
    mods = attention_kernel_modules()
    for m_ in mods.values():
        m_.KERNEL.launches = 0
    rec = {"forward_s": [], "gather_s": [], "sum_s": [], "lines": []}
    tta = voting.tta_transforms
    voting.tta_transforms = lambda name: tta(name)[:passes]

    def timed(fn, key):
        def call(*a, **kw):
            sync(dev)
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            sync(dev)
            rec[key].append(time.perf_counter() - t0)
            return r
        return call

    block_predict = halo.block_predict
    halo.block_predict = lambda m_: timed(block_predict(m_), "forward_s")
    halo.all_gather_rows = timed(halo.all_gather_rows, "gather_s")
    halo.all_reduce_sum = timed(halo.all_reduce_sum, "sum_s")
    collective = halo.sharded_scene_probs_collective

    def first_chunk(predict, coord, *a, **kw):
        if "first" in rec:
            return collective(predict, coord, *a, **kw)

        def keep(feats, xyz, offsets):
            rec["block"] = (xyz.clone(), offsets.clone())
            return predict(feats, xyz, offsets)
        rec["first"] = {"coord": coord, "feat": a[0]}
        rec["first"]["probs"] = collective(keep, coord, *a, **kw)
        return rec["first"]["probs"]

    halo.sharded_scene_probs_collective = first_chunk
    scene = voting.evaluate_scene_sharded

    def keep_scene(*a, **kw):
        rec["scene"] = scene(*a, **kw)
        return rec["scene"]

    voting.evaluate_scene_sharded = keep_scene
    t0 = time.perf_counter()
    rec["metrics"] = driver.run_rank(
        rank, world, yaml_cfg, dev, port, log=rec["lines"].append,
        backend="gloo", timeout_s=HALO_TIMEOUT_S)
    rec["seconds"] = time.perf_counter() - t0
    rec["launches"] = {k: m_.KERNEL.launches for k, m_ in mods.items()}
    if "block" in rec:
        cfg = driver.sharded_config(yaml_cfg)[0]
        xyz, off = rec.pop("block")
        anchor = torch.zeros(3, device=dev)
        with torch.inference_mode():
            pyr = geometry_pyramid(cfg, xyz, off, anchor)
            rec["first"]["audit"] = audit.audit_truncation_packed(
                cfg, {"xyz": xyz, "offsets": off, "pyramid": pyr},
                anchor=anchor).cpu().numpy()
        rec["first"]["block_points"] = int(off[-1])
    torch.save(rec, os.path.join(out, f"rank{rank}.pt"))


def run_halo_driver(dev, tmp, yaml_cfg, passes):
    """`halo_driver_rank` on HALO_DRIVER_WORLD ranks; returns the ranks'
    records."""
    from stratified_transformer_torch.parallel import mesh
    mesh.spawn(halo_driver_rank, HALO_DRIVER_WORLD, args=(
        HALO_DRIVER_WORLD, mesh.free_port(), yaml_cfg, passes, tmp, dev),
        timeout_s=2 * HALO_TIMEOUT_S)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(HALO_DRIVER_WORLD)]


def audit_drops(arr):
    """band / sband / cap dropped pairs over the stages of a packed
    audit."""
    return {"band": int(arr[:, 0].sum()), "sband": int(arr[:, 2].sum()),
            "cap": int(arr[:, 4].sum())}


def halo_cli(dev, tmp, ckpt):
    """Phase 17 (e): the entry point as a user runs it, ``python -m
    stratified_transformer_torch.eval.driver --config
    configs/s3dis_stratified.yaml sharded true data_root <rooms>
    model_path <ckpt>``, without ``--device`` (the card; one visible card
    is one rank), the YAML as shipped (fast mode), on one S3DIS-format room
    (HALO_CLI_POINTS points of a synthetic room): its lines, one launch of
    each fast forward kernel per block and block forward and none of the
    fp32 ones."""
    import contextlib
    import io

    from stratified_transformer_torch.data.datasets import SyntheticRooms
    from stratified_transformer_torch.eval import driver
    root = os.path.join(tmp, "rooms")
    os.makedirs(root)
    c, f, lab, _ = SyntheticRooms(num_scenes=1, seed=5,
                                  points=HALO_CLI_POINTS).raw_scene(0)
    np.save(os.path.join(root, "Area_5_office_1.npy"), np.concatenate(
        [c, f, lab[:, None]], 1).astype(np.float32))
    mods = attention_kernel_modules()
    for m_ in mods.values():
        m_.KERNEL.launches = m_.KERNEL_FAST.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = driver.main(["--config", CONFIG, "sharded", "true", "data_root",
                          root, "model_path", ckpt])
    secs = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    fast = {k + FAST: mods[k].KERNEL_FAST.launches for k in FWD_KERNELS}
    fp32 = {k: mods[k].KERNEL.launches for k in FWD_KERNELS}
    stats = [x for x in lines if x.startswith("sharded eval stats: ")]
    blocks = int(stats[0].split()[3]) if stats else 0
    log(f"[halo] (e) python -m stratified_transformer_torch.eval.driver "
        f"--config configs/s3dis_stratified.yaml sharded true (the card, "
        f"fast mode as shipped) on one {len(c)}-point room: rc {rc}, "
        f"{secs:.1f} s, {blocks} block forwards, launches {fast} and "
        f"fp32 {fp32}; " + "; ".join(lines[:2] + stats + lines[-1:]))
    if rc != 0 or not blocks or set(fast.values()) != {12 * blocks} or any(
            fp32.values()) or not lines[-1].startswith(
                "Val result: mIoU/mAcc/allAcc "):
        raise AssertionError(f"(e) the entry point: rc {rc}, launches "
                             f"{fast} / {fp32} over {blocks} blocks, "
                             f"{lines[-3:]}")
    return {"points": len(c), "seconds": secs, "block_forwards": blocks,
            "launches": fast, "lines": lines[:2] + stats + lines[-1:]}


def halo_phase(dev):
    """Phase 17: sharded whole-scene inference, fp32 kernels (`PIN_NOTE`):
    (a) `halo_world_one`; (b) `halo_corridor`; (c) the eval driver with
    ``sharded: true`` on HALO_DRIVER_WORLD gloo ranks on phase 10's room
    (HALO_PASSES TTA passes), the capacities at the largest vote chunk and
    slab: no halo point truncated or dropped and no chunk re-run, one
    launch of each forward kernel per block and block forward, the stats
    and result lines; the first chunk against the whole-chunk forward with
    the audit of each block and of the chunk (the deviation gated at
    HALO_EXACT where neither drops a band pair); seconds, forwards per rank,
    the collectives' ms per chunk, the host's share; the same passes
    through the serial sphere-crop protocol, and the two predictions'
    agreement; (d) the YAML's own capacities on the same room, one pass:
    every chunk that overflowed ``halo_cap`` re-run through host
    replication and logged, none accepted; (e) `halo_cli`."""
    import tempfile

    from stratified_transformer_torch.data.datasets import SyntheticRooms
    from stratified_transformer_torch.eval import voting
    from stratified_transformer_torch.eval.driver import (
        eval_config, make_predict_probs, sharded_config)
    from stratified_transformer_torch.models.stratified import (
        build_model, geometry_pyramid)
    from stratified_transformer_torch.parallel import halo
    from stratified_transformer_torch.train import audit, checkpoint
    from stratified_transformer_torch.utils.config import merge_cfg_from_list
    t_phase = time.time()
    log(f"[halo] phase 17: {PIN_NOTE}")
    yaml0 = yaml_fp32(CONFIG)
    coord, feat, _, _ = SyntheticRooms(num_scenes=1, seed=999,
                                       points=SCENE_POINTS).raw_scene(0)
    voxel = float(yaml0["voxel_size"])
    # the vote chunks of every pass (the driver's draws), their slabs
    tfms = voting.tta_transforms("s3dis")[:HALO_PASSES]
    rng = np.random.default_rng(0)
    chunk_max = slab_max = chunks = 0
    first = None
    for tfm in tfms:
        c, f = coord.astype(np.float32).copy(), feat.astype(np.float32)
        if tfm is not None:
            c, f = tfm(c, f.copy(), rng)
        c -= c.min(0)
        for idx in voting.vote_chunks(c, voxel):
            cp = c[idx] - c[idx].min(0)
            if first is None:
                first = (cp, f[idx] / 255.0)
            chunks += 1
            chunk_max = max(chunk_max, len(idx))
            slab_max = max(slab_max, max(len(b["idx"][b["core"]]) for b in
                                         halo.partition_scene(
                                             cp, HALO_DRIVER_WORLD, 0.0)))
    log(f"[halo] phase 10's room: {len(coord)} points, {chunks} vote chunks "
        f"in {len(tfms)} TTA passes, the largest {chunk_max} points, its "
        f"largest slab of {HALO_DRIVER_WORLD} {slab_max}")
    out = {"room_points": len(coord), "passes": len(tfms), "chunks": chunks,
           "largest_chunk": chunk_max, "largest_slab": slab_max}
    with tempfile.TemporaryDirectory() as tmp:
        # weights: phase 5's scale, through a checkpoint the driver reads
        ecfg = eval_config(yaml0)
        model = build_model(ecfg, dev, seed=0)
        o1_weights(model, seed=0)
        ckpt = checkpoint.save(os.path.join(tmp, "ckpt"), model,
                               torch.optim.SGD(model.parameters(), lr=0.1),
                               0, 0)
        state = model.state_dict()
        del model
        bcfg = sharded_config(yaml0)[0]
        block = build_model(bcfg, dev)
        ref = build_model(dataclasses.replace(bcfg, attn_impl="reference"),
                          dev)
        block.load_state_dict(state)
        ref.load_state_dict(state)

        # ---- (a) ---------------------------------------------------------
        out["a"] = halo_world_one(dev, block, ref, *first)
        del ref
        release(dev)

        # ---- (b) ---------------------------------------------------------
        out["b"] = halo_corridor(dev, tmp)

        # ---- (c) ---------------------------------------------------------
        keys = ["data_name", "synthetic", "synthetic_points",
                str(SCENE_POINTS), "synthetic_eval_scenes", "1",
                "model_path", ckpt, "sharded", "True", "sharded_devices",
                str(HALO_DRIVER_WORLD)]
        sized = ["sharded_block_points", str(chunk_max),
                 "sharded_core_points", str(chunk_max),
                 "sharded_halo_points", str(slab_max)]
        yaml_c = merge_cfg_from_list(yaml_fp32(CONFIG), keys + sized)
        t0 = time.perf_counter()
        ranks = run_halo_driver(dev, tmp, yaml_c, HALO_PASSES)
        wall = time.perf_counter() - t0
        out["c"] = halo_driver_report("c", ranks, bcfg, wall)
        st = out["c"]["stats"]
        if (st.get("truncated_halo_points") or st.get("halo_cap_dropped")
                or st.get("collective_rerun_chunks")
                or st.get("collective_fallback_chunks")
                or st.get("collective_chunks") != chunks):
            raise AssertionError(f"(c) the sized run truncated, dropped or "
                                 f"re-ran: {st}")
        # the first chunk against the whole-chunk forward on one process,
        # at the blocks' capacity (gated) and at its own (reported)
        r0 = ranks[0]["first"]
        scfg = sharded_config(yaml_c)[1]
        b_pad = scfg.core_pad + 2 * scfg.halo_cap
        want = whole_probs(block, r0["coord"], r0["feat"], b_pad)
        own = whole_probs(block, r0["coord"], r0["feat"])
        n = len(r0["coord"])
        xyz = torch.zeros((b_pad, 3), device=dev)
        xyz[:n] = torch.from_numpy(r0["coord"]).to(dev)
        off = torch.tensor([n], device=dev)
        anchor = torch.zeros(3, device=dev)
        with torch.inference_mode():
            whole_audit = audit.audit_truncation_packed(bcfg, {
                "xyz": xyz, "offsets": off,
                "pyramid": geometry_pyramid(bcfg, xyz, off, anchor)},
                anchor=anchor).cpu().numpy()
        drops = {"whole_chunk": audit_drops(whole_audit),
                 "blocks": [audit_drops(r["first"]["audit"]) for r in ranks]}
        dev_max = float(np.abs(r0["probs"] - want).max())
        agree = float((r0["probs"].argmax(1) == want.argmax(1)).mean())
        own_max = float(np.abs(r0["probs"] - own).max())
        own_agree = float((r0["probs"].argmax(1) == own.argmax(1)).mean())
        gated = (drops["whole_chunk"]["band"] == 0
                 and all(b["band"] == 0 for b in drops["blocks"]))
        out["c"]["first_chunk"] = {
            "points": n, "block_points": [r["first"]["block_points"]
                                          for r in ranks],
            "b_pad": b_pad, "max_abs_dprob": dev_max,
            "argmax_agreement": agree, "own_pad_max_abs_dprob": own_max,
            "own_pad_argmax_agreement": own_agree, "audit_drops": drops,
            "gated": gated}
        log(f"[halo] (c) first chunk ({n} points; blocks of "
            f"{out['c']['first_chunk']['block_points']} points): sharded "
            f"against the whole-chunk forward at the blocks' capacity "
            f"{b_pad}: max |dprob| {dev_max:.2e}, argmax agreement "
            f"{agree:.6f}; at its own ({round_tile(n)}): {own_max:.2e}, "
            f"{own_agree:.6f}; dropped pairs (band / sband / "
            f"cap) whole chunk {drops['whole_chunk']}, blocks "
            f"{drops['blocks']}; " + (
                f"gated at {HALO_EXACT}" if gated else
                "not gated (a band pair is dropped)"))
        if gated and dev_max > HALO_EXACT:
            raise AssertionError(f"(c) first chunk: max |dprob| {dev_max}")
        del block
        release(dev)
        # the serial sphere-crop protocol on the same passes
        model = build_model(ecfg, dev)
        model.load_state_dict(state)
        t0 = time.perf_counter()
        pred_s, _ = voting.evaluate_scene(
            make_predict_probs(model), coord, feat, ecfg.num_classes,
            data_name="s3dis", voxel_size=voxel,
            voxel_max=int(yaml0["voxel_max"]),
            batch_size_test=ecfg.num_scenes, n_pad=ecfg.n_pad,
            num_scenes=ecfg.num_scenes, concat_xyz=ecfg.concat_xyz,
            transforms=tfms)
        serial_s = time.perf_counter() - t0
        agree = float((ranks[0]["scene"][0] == pred_s).mean())
        out["c"].update(serial_s=serial_s, protocols_argmax_agreement=agree)
        log(f"[halo] (c) the serial sphere-crop protocol (phase 10) on the "
            f"same {len(tfms)} passes: {serial_s:.1f} s; the two protocols' "
            f"labels agree at {agree:.4f} of the points (slabs against "
            "sphere crops: not gated)")
        del model
        release(dev)

        # ---- (d) ---------------------------------------------------------
        yaml_d = merge_cfg_from_list(yaml_fp32(CONFIG), keys)
        t0 = time.perf_counter()
        ranks = run_halo_driver(dev, tmp, yaml_d, 1)
        out["d"] = halo_driver_report("d", ranks, bcfg,
                                      time.perf_counter() - t0)
        st = out["d"]["stats"]
        reruns = [x for x in ranks[0]["lines"]
                  if "re-run through host replication" in x]
        accepted = st.get("collective_chunks", 0)
        out["d"].update(rerun_lines=len(reruns))
        log(f"[halo] (d) the YAML's capacities (block_pad "
            f"{sharded_config(yaml_d)[1].block_pad}, halo_cap "
            f"{sharded_config(yaml_d)[1].halo_cap}), 1 pass: truncated "
            f"{st.get('truncated_halo_points', 0)} halo points, cap-dropped "
            f"{st.get('halo_cap_dropped', 0)}, re-run "
            f"{st.get('collective_rerun_chunks', 0)} chunks ({len(reruns)} "
            f"lines), accepted through the exchange {accepted}; e.g. "
            f"{reruns[:1]}")
        if len(reruns) != st.get("collective_rerun_chunks", 0) or (
                st.get("halo_cap_dropped", 0)
                and accepted + len(reruns) != out["d"]["chunks"]):
            raise AssertionError(f"(d) overflowed chunks not all re-run and "
                                 f"logged: {st}, {len(reruns)} lines")

        # ---- (e) ---------------------------------------------------------
        out["e"] = halo_cli(dev, tmp, ckpt)
    out["seconds"] = time.time() - t_phase
    log(f"[halo] phase 17 in {out['seconds']:.0f} s")
    return out


def halo_driver_report(tag, ranks, bcfg, wall):
    """The numbers of a `run_halo_driver` run, with its gates: the ranks'
    predictions identical, one launch of each forward kernel per block and
    block forward (none backward), rank 0's stats and result lines."""
    blocks = attention_blocks(bcfg)
    for r, res in enumerate(ranks):
        fw = len(res["forward_s"])
        want_l = {k: blocks * fw if k in FWD_KERNELS else 0
                  for k in res["launches"]}
        if res["launches"] != want_l:
            raise AssertionError(f"({tag}) rank {r}: launches "
                                 f"{res['launches']} over {fw} block "
                                 f"forwards, expected {want_l}")
        if not np.array_equal(res["scene"][1], ranks[0]["scene"][1]):
            raise AssertionError(f"({tag}) rank {r}'s probabilities differ "
                                 "from rank 0's")
    lines = ranks[0]["lines"]
    stats_line = [x for x in lines if x.startswith("sharded eval stats: ")]
    if len(stats_line) != 1 or not lines[-1].startswith(
            "Val result: mIoU/mAcc/allAcc "):
        raise AssertionError(f"({tag}) the driver's lines: {lines[-3:]}")
    m = ranks[0]["metrics"]
    st = m["sharded_stats"]
    scene_s = m["scenes"][0]["seconds"]
    fwd = [sum(r["forward_s"]) for r in ranks]
    chunks = (st.get("collective_chunks", 0)
              + st.get("collective_rerun_chunks", 0)
              + st.get("collective_fallback_chunks", 0))
    gather_ms = [1e3 * sum(r["gather_s"]) / max(chunks, 1) for r in ranks]
    sum_ms = [1e3 * sum(r["sum_s"]) / max(chunks, 1) for r in ranks]
    out = {"stats": st, "chunks": chunks, "scene_s": scene_s, "wall_s": wall,
           "forwards": [len(r["forward_s"]) for r in ranks],
           "forward_s": fwd, "exchange_ms_per_chunk": gather_ms,
           "sums_ms_per_chunk": sum_ms,
           "host_share": [1 - (f + (g + s) * chunks / 1e3) / scene_s
                          for f, g, s in zip(fwd, gather_ms, sum_ms)],
           "launches": [r["launches"] for r in ranks],
           "miou": m["miou"], "all_acc": m["all_acc"],
           "lines": [x for x in lines if "re-run" not in x][:4]
           + stats_line + lines[-1:]}
    log(f"[halo] ({tag}) eval driver, {HALO_DRIVER_WORLD} gloo ranks: scene "
        f"{scene_s:.1f} s ({wall:.1f} s with the ranks' start), {chunks} "
        f"chunks, block forwards per rank {out['forwards']} "
        f"({', '.join(f'{f:.1f}' for f in fwd)} s), exchange "
        f"{', '.join(f'{g:.1f}' for g in gather_ms)} ms and sums "
        f"{', '.join(f'{s:.1f}' for s in sum_ms)} ms per chunk, host share "
        f"{', '.join(f'{h:.1%}' for h in out['host_share'])}; launches "
        f"{out['launches']}; {stats_line[0]}; {lines[-1]}")
    return out


# phase 18: ScanNet from raw scans. (a) PREP_SCANS scans in ScanNet's raw
# layout (SCANNET_SCENE's 200000-vertex 5 m room, about two faces per
# vertex) through the port's preparation tool; (b) the readers and the GT
# txt files; (c) one eval forward per scene of the shipped ScanNet YAML
# (fast kernels); (d) the legacy dense-batch ops and subtraction /
# aggregation on the card and the CPU at LEGACY's sizes
PREP_SCANS = 2
PREP_FACES_PER_VERTEX = 2
# ScanNet's 20 benchmark classes as nyu40 ids (the benchmark's list), and
# nyu40 ids outside them, which the preparation maps to -100
SCANNET_NYU40 = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33,
                 34, 36, 39)
UNMAPPED_NYU40 = (0, 13, 15, 17, 40)
# over-segmentation cells (m) standing in for ScanNet's mesh segments
PREP_SEGMENT_CELL = 0.25
LEGACY = dict(b=2, n=40960, m=4096, nsample=32, k=16, nclass=13, c=48,
              w_c=6, radius=0.12, patch_n_pad=2048)
LEGACY_RTOL = LEGACY_ATOL = 1e-6
# divide2patch's kNN is the model's (`ops.neighbors.knn`, the JAX package's
# ``|q|^2 + |r|^2 - 2 q.r`` form): its product runs in cuBLAS on the card
# and in the CPU's BLAS, which round differently. A row whose neighbours
# differ between the two must pick neighbours as near, rank by rank, within
# this many float32 ulps of the patch points' largest squared coordinate
# (about the form's rounding), and few rows may
KNN_TIE_ULPS = 4
KNN_TIE_ROWS = 0.02


def _ply_header(n_vertex, n_face, label):
    return "\n".join(
        ["ply", "format binary_little_endian 1.0",
         f"element vertex {n_vertex}"]
        + [f"property float {a}" for a in "xyz"]
        + [f"property uchar {c}" for c in ("red", "green", "blue", "alpha")]
        + (["property ushort label"] if label else [])
        + [f"element face {n_face}",
           "property list uchar int vertex_indices", "end_header", ""]
    ).encode("ascii")


def write_scannet_scans(root, split, count, seed, points=200000, extent=5.0,
                        labels=True):
    """``count`` scans ``<root>/<split>/scene<seed+i>_00*`` in ScanNet's raw
    layout, from SyntheticRooms' rooms (``points`` vertices in ``extent``
    metres): the binary ``_vh_clean_2.ply`` (vertex x y z float, red green
    blue alpha uchar; about PREP_FACES_PER_VERTEX triangles per vertex) and,
    with ``labels``, its ``.labels.ply`` (plus a ushort nyu40 ``label`` per
    vertex: each of SCANNET_NYU40 and UNMAPPED_NYU40 on some segment), the
    ``.0.010000.segs.json`` over-segmentation (PREP_SEGMENT_CELL cells) and
    the ``.aggregation.json`` instance groups (runs of 1-3 segments; about
    one segment in ten in none). Returns per scan ``(name, xyz float32,
    rgb uint8, nyu40 labels, instance ids or -100)``; the last two None
    without ``labels``."""
    from stratified_transformer_torch.data.datasets import SyntheticRooms
    os.makedirs(os.path.join(root, split), exist_ok=True)
    scans = []
    for i in range(count):
        name = f"scene{seed + i:04d}_00"
        base = os.path.join(root, split, name)
        xyz, rgb, _, _ = SyntheticRooms(num_scenes=1, points=points,
                                        extent=extent,
                                        seed=seed + i).raw_scene(0)
        rgb = np.rint(rgb).astype(np.uint8)
        n = len(xyz)
        rng = np.random.default_rng(seed + i)
        faces = np.zeros(PREP_FACES_PER_VERTEX * n, np.dtype(
            [("n", "u1"), ("v", "<i4", 3)]))
        corner = np.arange(len(faces)) % n
        faces["n"] = 3
        faces["v"] = (corner[:, None] + np.concatenate([
            np.zeros((len(faces), 1), np.int64),
            rng.integers(1, 9, (len(faces), 2))], 1)) % n
        vert = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"),
                ("green", "u1"), ("blue", "u1"), ("alpha", "u1")]

        def write(path, label=None):
            extra = [] if label is None else [("label", "<u2")]
            v = np.zeros(n, np.dtype(vert + extra))
            v["x"], v["y"], v["z"] = xyz.T
            v["red"], v["green"], v["blue"] = rgb.T
            v["alpha"] = 255
            if label is not None:
                v["label"] = label
            with open(path, "wb") as f:
                f.write(_ply_header(n, len(faces), label is not None))
                f.write(v.tobytes())
                f.write(faces.tobytes())

        nyu = inst = None
        if labels:
            cells = np.floor((xyz - xyz.min(0)) / PREP_SEGMENT_CELL)
            _, seg = np.unique(cells, axis=0, return_inverse=True)
            seg = seg.reshape(-1)
            n_seg = int(seg.max()) + 1
            ids = np.array(SCANNET_NYU40 + UNMAPPED_NYU40)
            seg_label = ids[rng.integers(0, len(ids), n_seg)]
            seg_label[:len(ids)] = ids[rng.permutation(len(ids))]
            nyu = seg_label[seg].astype(np.uint16)
            seg_ids = seg * 3 + 7               # ScanNet's ids are sparse
            groups, seg_inst = [], np.full(n_seg, -100)
            s = 0
            while s < n_seg:
                run = int(rng.integers(1, 4))
                if rng.uniform() >= 0.1:
                    members = list(range(s, min(s + run, n_seg)))
                    seg_inst[members] = len(groups)
                    groups.append({
                        "id": len(groups), "objectId": len(groups),
                        "segments": [int(m_) * 3 + 7 for m_ in members],
                        "label": f"nyu40_{int(seg_label[members[0]])}"})
                s += run
            inst = seg_inst[seg]
            write(base + "_vh_clean_2.labels.ply", nyu)
            with open(base + "_vh_clean_2.0.010000.segs.json", "w") as f:
                json.dump({"params": {"kThresh": "0.0001", "segMinVerts":
                                      "20"}, "sceneId": name,
                           "segIndices": seg_ids.tolist()}, f)
            with open(base + ".aggregation.json", "w") as f:
                json.dump({"sceneId": f"scannet.{name}", "appId": "smoke",
                           "segGroups": groups, "segmentsFile":
                           f"scannet.{name}_vh_clean_2.0.010000.segs.json"},
                          f)
        write(base + "_vh_clean_2.ply")
        scans.append((name, xyz, rgb, nyu, inst))
    return scans


def scannet_gt(nyu, inst):
    """The benchmark's GT ids of one scan from its nyu40 labels and
    instance ids: ``nyu*1000 + inst + 1`` on the grouped points of a
    benchmark class other than wall and floor, ``nyu*1000`` on the other
    points of a benchmark class, 0 elsewhere; and the 20-class semantic
    labels (-100 outside the benchmark)."""
    sem = np.full(len(nyu), -100)
    for i, x in enumerate(SCANNET_NYU40):
        sem[nyu == x] = i
    nyu = nyu.astype(np.int64)
    gt = np.where((sem >= 2) & (inst >= 0), nyu * 1000 + inst + 1,
                  np.where(sem >= 0, nyu * 1000, 0))
    return gt, sem


def legacy_inputs(scenes, seed=0):
    """Phase 18 (d)'s inputs: LEGACY's ``n`` references per scene drawn from
    the prepared scenes' points and ``m`` queries among them, class
    histograms, and features and weights on a dyadic grid (multiples of
    1/8 in [-4, 4]): every sum the ops and their backward take is then exact
    in float32 in any order, so the card and the CPU agree bit for bit and
    a difference is one of what the ops compute, not of a sum's order."""
    L = LEGACY
    rng = np.random.default_rng(seed)
    refs = np.stack([s[1][rng.choice(len(s[1]), L["n"], replace=False)]
                     for s in scenes[:L["b"]]]).astype(np.float32)
    queries = np.stack([r[rng.choice(L["n"], L["m"], replace=False)]
                        for r in refs])
    b, n, m, c = L["b"], L["n"], L["m"], L["c"]

    def dyadic(*shape):
        return (rng.integers(-32, 33, shape) / 8).astype(np.float32)

    return {
        "refs": refs, "queries": queries,
        "stat": rng.integers(0, 3, (b, n, L["nclass"])).astype(np.int32),
        "ref_feats": dyadic(b, c, n), "anchor_feats": dyadic(b, c, m),
        "int_feats": rng.integers(-50, 50, (b, 4, n)),
        "query_rows": rng.choice(n, (b, m), replace=False),
        "weight": dyadic(b * m, L["k"], L["w_c"]),
        "patch_xyz": np.concatenate(
            [r[:n // 2] for r in refs]).astype(np.float32),
        "patch_offsets": np.array([n // 2, n], np.int32)}


def legacy_ops(x, dev):
    """Every op of ``ops/legacy.py`` and ``neighbors.subtraction`` /
    ``aggregation`` on ``x`` (numpy, `legacy_inputs`) moved to ``dev``:
    ``{name: (outputs, seconds)}``, with the differentiable ops' input
    gradients under a cotangent of ones among their outputs."""
    from stratified_transformer_torch.ops import legacy, neighbors
    L = LEGACY
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in x.items()}
    q, r, r_ = t["queries"], t["refs"], L["radius"]
    out = {}

    def run(name, fn, *args):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args)
        res = res if isinstance(res, tuple) else (res,)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[name] = ([v.detach().cpu() for v in res],
                     time.perf_counter() - t0)
        return res

    idx, _ = run("ball_query_dense", legacy.ball_query_dense, q, r, r_,
                 L["nsample"])
    run("labelstat_idx", legacy.labelstat_idx, t["stat"], idx)
    run("labelstat_ballrange", legacy.labelstat_ballrange, q, r, t["stat"],
        r_)
    run("labelstat_and_ballquery", legacy.labelstat_and_ballquery, q, r,
        t["stat"], r_, L["nsample"])
    (dist_idx,) = run("feature_distribute", legacy.feature_distribute, q, r)

    def gather_grad(feats, ids):
        feats = feats.detach().clone().requires_grad_()
        g = legacy.feature_gather(feats, ids)
        (grad,) = torch.autograd.grad(g.sum(), feats)
        return g, grad

    run("feature_gather", gather_grad, t["anchor_feats"], dist_idx)
    run("gathering", legacy.gathering, t["ref_feats"], t["query_rows"])
    run("grouping_dense", legacy.grouping_dense, t["ref_feats"], idx)
    run("grouping_dense_int64", legacy.grouping_dense, t["int_feats"], idx)
    knn_idx, d2 = run("knn_dense", legacy.knn_dense, q, r, L["k"])
    b, c, n = t["ref_feats"].shape
    flat_idx = (knn_idx.long() + n * torch.arange(
        b, device=dev)[:, None, None]).reshape(-1, L["k"])
    mask = (d2 < r_ * r_).reshape(-1, L["k"])
    ref_rows = t["ref_feats"].permute(0, 2, 1).reshape(b * n, c)
    query_rows = torch.gather(
        t["ref_feats"], 2, t["query_rows"][:, None].expand(
            b, c, t["query_rows"].shape[1])).permute(0, 2, 1).reshape(-1, c)

    def subtraction(x1, x2):
        ins = [v.detach().clone().requires_grad_() for v in (x1, x2)]
        pos = neighbors.subtraction(*ins, flat_idx, mask)
        return (pos,) + torch.autograd.grad(pos.sum(), ins)

    def aggregation(feats, pos, w):
        ins = [v.detach().clone().requires_grad_() for v in (feats, pos, w)]
        agg = neighbors.aggregation(*ins, flat_idx, mask)
        return (agg,) + torch.autograd.grad(agg.sum(), ins)

    (pos, *_) = run("subtraction", subtraction, query_rows, ref_rows)
    run("aggregation", aggregation, ref_rows, pos, t["weight"])
    run("divide2patch", legacy.divide2patch, L["nsample"], t["patch_xyz"],
        t["patch_offsets"], L["patch_n_pad"])
    return out


def knn_near_ties(got, want, xyz):
    """Rows of the kNN index lists ``got`` (card) and ``want`` (CPU), ``[M,
    k]`` into the points ``xyz``, that differ: each must pick neighbours as
    near as the other's in every rank (float64 distances from the row's
    nearest point, the anchor itself, within KNN_TIE_ULPS of the squared
    coordinates), and at most KNN_TIE_ROWS of the rows may differ. Returns
    the rows, the largest gap and the tolerance."""
    xyz = xyz.astype(np.float64)
    centred = xyz - xyz.mean(0)
    tie = KNN_TIE_ULPS * float(np.spacing(np.float32(
        (centred ** 2).sum(1).max())))
    got, want = got.numpy(), want.numpy()
    rows = np.nonzero((got != want).any(1))[0]
    gap = 0.0
    for r in rows:
        anchor = xyz[want[r, 0]]
        d_got = np.sort(((xyz[got[r]] - anchor) ** 2).sum(1))
        d_want = np.sort(((xyz[want[r]] - anchor) ** 2).sum(1))
        gap = max(gap, float(np.abs(d_got - d_want).max()))
    if gap > tie or len(rows) > KNN_TIE_ROWS * len(got):
        raise AssertionError(
            f"legacy divide2patch: {len(rows)} of {len(got)} kNN rows differ "
            f"between the card and the CPU, largest distance gap {gap:.3e} "
            f"m^2 (near-tie tolerance {tie:.3e})")
    return {"rows": int(len(rows)), "max_gap_m2": gap, "tie_m2": tie}


def legacy_phase(x, dev):
    """Phase 18 (d): `legacy_ops` on the card and on the CPU; integer
    outputs equal (divide2patch's neighbour lists up to `knn_near_ties`),
    floats within LEGACY_RTOL / LEGACY_ATOL. Returns each op's card and
    CPU seconds and largest float difference."""
    card = legacy_ops(x, dev)
    cpu = legacy_ops(x, torch.device("cpu"))
    report = {}
    for name, (outs, secs) in card.items():
        want, cpu_s = cpu[name]
        err = 0.0
        if name == "divide2patch":
            ties = knn_near_ties(outs[0], want[0], x["patch_xyz"])
            outs, want = outs[1:], want[1:]
        for j, (g, w) in enumerate(zip(outs, want)):
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"legacy {name} output {j}: "
                                     f"{g.dtype} {tuple(g.shape)} on the "
                                     f"card, {w.dtype} {tuple(w.shape)}")
            if g.dtype.is_floating_point:
                assert_close(f"legacy {name} output {j}", g, w, LEGACY_RTOL,
                             LEGACY_ATOL)
                err = max(err, max_errors(g, w)[0])
            elif not torch.equal(g, w):
                raise AssertionError(
                    f"legacy {name} output {j}: {int((g != w).sum())} of "
                    f"{g.numel()} entries differ between the card and the "
                    "CPU")
        report[name] = {"card_s": secs, "cpu_s": cpu_s, "max_abs_err": err}
    report["divide2patch"]["near_tie_rows"] = ties
    hits = card["ball_query_dense"][0][1]
    log(f"[prep] (d) {len(report)} legacy ops at b {LEGACY['b']}, n "
        f"{LEGACY['n']}, m {LEGACY['m']} (ball hits per query "
        f"{float(hits.float().mean()):.1f}, "
        f"{float((hits == LEGACY['nsample']).float().mean()):.1%} capped): "
        "integers equal on the card and the CPU (divide2patch's kNN: "
        f"{ties['rows']} rows of near ties, largest gap "
        f"{ties['max_gap_m2']:.2e} m^2 of {ties['tie_m2']:.2e}), floats "
        f"within {LEGACY_RTOL}/{LEGACY_ATOL}; " + ", ".join(
            f"{k} {v['card_s'] * 1e3:.1f}/{v['cpu_s'] * 1e3:.0f} ms"
            for k, v in report.items()) + " (card/CPU, host clock)")
    return report


def prep_phase(dev):
    """Phase 18: raw ScanNet-layout scans -> the port's preparation tool ->
    the readers -> the shipped ScanNet YAML's eval forward on the fast
    kernels, and the legacy ops (module docstring). Returns its numbers;
    ``launches`` are the fast forward kernels' over (c)'s forwards."""
    import tempfile

    from stratified_transformer_torch.config import load_config
    from stratified_transformer_torch.data.datasets import (
        Scannetv2, scannet_scenes)
    from stratified_transformer_torch.data.loader import (
        BatchLoader, build_dataset, to_device)
    from stratified_transformer_torch.data.ply import read_ply
    from stratified_transformer_torch.models.stratified import build_model
    from stratified_transformer_torch.tools import prepare_scannet
    from stratified_transformer_torch.train.step import make_eval_step
    from stratified_transformer_torch.utils.config import load_cfg
    t_phase = time.time()
    card = card_line()
    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) raw scans -> .pth + GT txt
        t0 = time.time()
        scans = write_scannet_scans(tmp, "val", PREP_SCANS, seed=0,
                                    **SCANNET_SCENE)
        out["write_s"] = time.time() - t0
        gt_dir = os.path.join(tmp, "gt")
        t0 = time.time()
        done = prepare_scannet.main(["--data_split", "val", "--dir", tmp,
                                     "--workers", "1", "--gt_txt_out",
                                     gt_dir])
        out["prep_s"] = time.time() - t0
        out["prep_s_per_scene"] = [s for _, s in done]
        if len(done) != PREP_SCANS:
            raise AssertionError(f"the preparation tool found {len(done)} "
                                 f"of {PREP_SCANS} scans")
        # the PLY reader's share: the first scan's two files read again
        t0 = time.time()
        for suffix in ("_vh_clean_2.ply", "_vh_clean_2.labels.ply"):
            read_ply(os.path.join(tmp, "val", scans[0][0] + suffix))
        out["read_ply_s"] = time.time() - t0
        log(f"[prep] phase 18 on {card}: (a) {PREP_SCANS} raw scans of "
            f"{len(scans[0][1])} vertices and "
            f"{PREP_FACES_PER_VERTEX * len(scans[0][1])} faces written in "
            f"{out['write_s']:.2f} s; the port's prepare_scannet "
            f"{', '.join(f'{s:.2f}' for s in out['prep_s_per_scene'])} s per "
            f"scene ({out['prep_s']:.2f} s with the GT txt; reading the "
            f"first scene's two PLY files alone {out['read_ply_s']:.2f} s)")

        # (b) the readers and the GT txt
        scenes = scannet_scenes(tmp)
        for (name, xyz, rgb, nyu, inst), (sname, coord, color, label) in zip(
                scans, scenes):
            gt, sem = scannet_gt(nyu, inst)
            got_gt = np.loadtxt(os.path.join(gt_dir, name + ".txt"),
                                dtype=np.int64)
            want_coord = xyz.astype(np.float64)
            if not (sname == name + "_inst_nostuff"
                    and np.array_equal(label, sem)
                    and np.array_equal(got_gt, gt)
                    and np.allclose(coord, want_coord - want_coord.mean(0),
                                    rtol=0, atol=1e-9)
                    and np.array_equal(color, rgb / 127.5 - 1)):
                raise AssertionError(f"scan {name}: the prepared scene or "
                                     "its GT txt differs from the labels "
                                     "written")
        val = Scannetv2(split="val", data_root=tmp)
        item = val[0]
        if (len(val) != PREP_SCANS or not np.isfinite(item["xyz"]).all()
                or not set(np.unique(item["labels"]))
                <= set(np.unique(scenes[0][3]))):
            raise AssertionError("Scannetv2 does not read the prepared "
                                 "scenes")
        out["gt_points"] = [int((np.loadtxt(os.path.join(
            gt_dir, s[0] + ".txt")) > 0).sum()) for s in scans]
        log(f"[prep] (b) scannet_scenes and Scannetv2(split=val) read "
            f"{len(scenes)} scenes: labels, centred coords, colours in "
            f"[-1, 1] and GT txt ({out['gt_points']} labelled points) equal "
            "the scans'")

        # (c) the shipped YAML's eval forward per scene, fast kernels
        cfg = load_config(SCANNET_CONFIG)
        yaml_cfg = load_cfg(SCANNET_CONFIG)
        if not cfg.fast:
            raise AssertionError("the shipped ScanNet YAML does not select "
                                 "the fast forms")
        yaml_cfg["data_root"] = tmp
        loader = BatchLoader(build_dataset(yaml_cfg, "val"), cfg, yaml_cfg,
                             shuffle=False)
        t0 = time.time()
        batches = [to_device(loader.make_batch([i]), dev)
                   for i in range(PREP_SCANS)]
        out["batch_s"] = (time.time() - t0) / PREP_SCANS
        blocks = attention_blocks(cfg)
        mods = dict(attention_kernel_modules(), **fast_kernel_modules())
        model = build_model(cfg, "cuda", seed=0)
        o1_weights(model, seed=0)
        plain = build_model(dataclasses.replace(cfg, attn_impl="reference"),
                            "cuda")
        plain.load_state_dict(model.state_dict())
        eval_step = make_eval_step(int(yaml_cfg["ignore_label"]),
                                   cfg.num_classes)
        with torch.no_grad():
            eval_step(model, batches[0])        # first call: lazy set-up
            torch.cuda.synchronize()
            for m_ in mods.values():
                m_.KERNEL.launches = 0
            logits, times = [], []
            for b in batches:
                t0 = time.perf_counter()
                logits.append(eval_step(model, b)[0])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            launches = {k: m_.KERNEL.launches for k, m_ in mods.items()}
            want = {k: blocks * PREP_SCANS
                    if k in ("band_attention" + FAST,
                             "sparse_band_attention" + FAST) else 0
                    for k in mods}
            if launches != want:
                raise AssertionError(f"prepared-scene forwards launched "
                                     f"{launches}, expected {want}")
            errs = []
            for j, b in enumerate(batches):
                if not bool(torch.isfinite(logits[j]).all()):
                    raise AssertionError(f"non-finite logits, scene {j}")
                errs.append(rel_l2(logits[j], eval_step(plain, b)[0]))
        out.update(launches=launches, forward_ms=times, logits_rel_l2=errs,
                   valid_points=[int(b["offsets"][0]) for b in batches])
        log(f"[prep] (c) configs/scannetv2_stratified.yaml as shipped (fast "
            f"kernels), one eval forward per prepared scene (n_pad "
            f"{cfg.n_pad}, {out['valid_points']} points after voxelization, "
            f"batches built in {out['batch_s']:.2f} s each): "
            f"{', '.join(f'{t_:.1f}' for t_ in times)} ms (host clock, "
            f"synchronized) on {card}; launches {launches}; logits vs the "
            f"plain fast versions relative L2 "
            f"{', '.join(f'{e:.2e}' for e in errs)} (gate "
            f"{FAST_LOGITS_REL_L2})")
        bad = [e for e in errs if not e <= FAST_LOGITS_REL_L2]
        if bad:
            raise AssertionError(f"prepared-scene logits relative L2 {bad} "
                                 f"> {FAST_LOGITS_REL_L2}")
        del model, plain, batches, logits

        # (d) the legacy ops on the card and the CPU
        out["legacy"] = legacy_phase(legacy_inputs(scenes), dev)
    out["seconds"] = time.time() - t_phase
    log(f"[prep] phase 18 in {out['seconds']:.0f} s")
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
    if flag in ("--fast-only", "--swin-only", "--dp-only", "--halo-only",
                "--prep-only", "--bwd-phases", "--fwd-phases"):
        phase = {"--fast-only": fast_phase, "--swin-only": swin_phase,
                 "--dp-only": dp_phase, "--halo-only": halo_phase,
                 "--prep-only": prep_phase, "--bwd-phases": bwd_phases,
                 "--fwd-phases": fwd_phases}[flag]
        out = {"card": card_line(), "repo": REPO,
               flag[2:].replace("-only", ""): phase(dev),
               "ptxas": ptxas}
        print(json.dumps(out))
        return 0
    if flag in ("--loop-only", "--scannet-only", "--dcf-only"):
        phase = {"--loop-only": loop_phase, "--scannet-only": scannet_phase,
                 "--dcf-only": dcf_phase}[flag]
        out = {"card": card_line(), "repo": REPO,
               flag[2:].replace("-only", ""): phase(
                   dev, attention_kernel_modules()),
               "ptxas": ptxas}
        print(json.dumps(out))
        return 0
    out = {"card": card_line(), "repo": REPO}
    if flag == "--scannet-kernels-only":
        log(f"[scannet] phase 12 (a): {PIN_NOTE}")
        cfg = load_config(SCANNET_CONFIG, **FP32)
        out["ms_per_scannet_train_step"] = scannet_kernels(
            cfg, host_batch(cfg, seed=0, **SCANNET_ROOMS), dev)
        out["ptxas"] = ptxas
        print(json.dumps(out))
        return 0
    cfg = load_config(CONFIG, n_pad=N_PAD, num_scenes=SCENES, **FP32)
    log(f"[precision] {PIN_NOTE}")
    hb = host_batch(cfg, seed=0)
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
              "--dcf-only": FWD_KERNELS + BWD_KERNELS,
              "--iou-only": FWD_KERNELS,
              "--fast-only": FWD_KERNELS + BWD_KERNELS,
              "--swin-only": ("band_attention", "band_attention_bwd"),
              "--dp-only": FWD_KERNELS + BWD_KERNELS,
              "--halo-only": FWD_KERNELS,
              "--prep-only": FWD_KERNELS,
              "--bwd-phases": BWD_KERNELS,
              "--fwd-phases": FWD_KERNELS,
              "--scannet-kernels-only": FWD_KERNELS + BWD_KERNELS}


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
    cfg = load_config(CONFIG, n_pad=N_PAD, num_scenes=SCENES, **FP32)
    log(f"[precision] phases 2-13: {PIN_NOTE}")
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
    yaml_cfg = yaml_fp32(CONFIG)
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

    # ---- 13. the DCF family -----------------------------------------------
    dcf = dcf_phase(dev, kernel_mods)

    # ---- 14. the shipped YAMLs' fast forms --------------------------------
    fast = fast_phase(dev)

    # ---- 15. the Swin3D family --------------------------------------------
    swin = swin_phase(dev)

    # ---- 16. data-parallel training ----------------------------------------
    dp_out = dp_phase(dev)

    # ---- 17. sharded whole-scene inference ---------------------------------
    halo_out = halo_phase(dev)

    # ---- 18. ScanNet from raw scans; the legacy ops ----------------------
    prep = prep_phase(dev)
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
        if name in dcf["train"]["launches"]:
            entry.update(
                dcf_launches=dcf["train"]["launches"][name],
                dcf_eval_launches=dcf["eval"]["launches"][name],
                dcf_loop_launches=dcf["loop"]["launches"][name],
                dcf_iou_launches=dcf["iou"]["launches"][name])
        if name in PROBE_KERNELS:
            entry["probe_launches"] = probe_launches[name]
            entry["times_per"] = "one launch of the probe"
        else:
            entry.update(
                dp_launches=[c[name] for c in dp_out["b"]["launches"]],
                dp_loop_launches=[c[name] for c in dp_out["c"]["launches"]],
                halo_launches=[c[name] for c in halo_out["c"]["launches"]],
                halo_block_forwards=halo_out["c"]["forwards"])
        kernels.append(entry)
    for name in FAST_KERNELS:
        r, sr = fast["report"][name], fast["scannet_report"][name]
        base = name[:-len(FAST)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"stratified_transformer_torch/csrc/{base}.cu",
            "replaces": TPU_KERNELS[base] + " (fast=True)",
            "launches": fast["model"]["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": max(r["bound_by"], key=r["bound_by"].get),
            "library_ms": None, "fp32_ms": r["fp32_ms"],
            "prep_launches": prep["launches"][name],
            # largest relative L2 from the plain fast version over the
            # outputs (forward) or gradients (backward), and the fp32
            # form's smallest (the control)
            "rel_l2": r.get("out_rel_l2", r.get("grad_rel_l2")),
            "fp32_rel_l2": r.get("fp32_out_rel_l2",
                                 r.get("fp32_grad_rel_l2")),
            "scannet_ms": sr["ms"], "scannet_fp32_ms": sr["fp32_ms"],
            "scannet_plain_ms": sr["plain_ms"],
            "scannet_bound_ms": sr["bound_ms"],
            "scannet_max_abs_err": sr["max_abs_err"]})
    for name in SWIN_KERNELS + SWIN_FAST_KERNELS:
        r, sr = swin["report"][name], swin["scannet_report"][name]
        base = name.replace(SWIN, "").replace(FAST, "")
        fast_form = name.endswith(FAST)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"stratified_transformer_torch/csrc/{base}.cu",
            "replaces": TPU_KERNELS[base] + (
                " (fast=True)" if fast_form else "")
            + ", swin bins (ops/attention.py:59-72)",
            "launches": (swin["fast"]["launches"][name] if fast_form
                         else swin["launches"][base]),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": max(r["bound_by"], key=r["bound_by"].get),
            "library_ms": None,
            **({"fp32_ms": r["fp32_ms"]} if fast_form else {}),
            **({"wrapper_busy_ms": r["wrapper_busy_ms"]}
               if "wrapper_busy_ms" in r else {}),
            "scannet_ms": sr["ms"], "scannet_plain_ms": sr["plain_ms"],
            "scannet_bound_ms": sr["bound_ms"],
            "scannet_max_abs_err": sr["max_abs_err"]})
    print(json.dumps({
        "kernels": kernels,
        "times_per": "one full-width training step (12 launches of each "
                     "attention kernel; a forward kernel's time is also one "
                     "eval forward's); a probe's: one launch, and its "
                     "launches on the train step are 0; the fast (_bf16) "
                     "forms': see fast_times_per",
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
        "scannet": {k: v for k, v in scannet.items() if k != "report"},
        "dcf_times_per": "dcf_launches over phase 13 (a)'s "
                         f"{TRAIN_STEPS} training steps, dcf_eval_launches "
                         f"over its {EVAL_BATCHES} forwards, "
                         "dcf_iou_launches over (c)'s first protocol run",
        "dcf": dcf,
        "fast_times_per": "phase 14: a fast kernel's ms, fp32_ms (its fp32 "
                          "form on the same inputs, same call), plain_ms "
                          "and bound_ms per S3DIS train step (12 launches), "
                          "scannet_* per ScanNet step (18); launches over "
                          "one S3DIS train step of the shipped YAML",
        "fast": {k: v for k, v in fast.items()
                 if k not in ("report", "scannet_report")},
        "swin_times_per": "phase 15: a swin kernel's ms, plain_ms and "
                          "bound_ms per S3DIS Swin3D train step (12 launches "
                          "at phase 2's batch), scannet_* per ScanNet Swin3D "
                          "step (18, at (d)'s batch); launches over phase "
                          "15 (c)'s "
                          f"{EVAL_BATCHES} forwards and {TRAIN_STEPS} train "
                          "steps through the kernels; the fast forms' over "
                          "(f)'s forward and train step",
        "swin": {k: v for k, v in swin.items()
                 if k not in ("report", "scannet_report")},
        "dp_times_per": "phase 16: dp_launches per rank over (b)'s one DP "
                        "step with distinct batches (two ranks over gloo on "
                        "one card, n_pad 70016 each), dp_loop_launches per "
                        "rank over (c)'s driver run (rank 0 validates)",
        "dp": dp_out,
        "halo_times_per": "phase 17: halo_launches per rank over (c)'s "
                          "eval driver run (sharded, two ranks over gloo on "
                          "one card), halo_block_forwards the block "
                          "forwards per rank in it",
        "halo": halo_out,
        "prep_times_per": "phase 18: prep_launches over (c)'s "
                          f"{PREP_SCANS} eval forwards of the prepared "
                          "scenes",
        "prep": prep}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
