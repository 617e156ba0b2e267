"""Pieces of ``chip_smoke.py`` that run on the CPU: the weights its
full-width comparison runs at, its count of the least operations and bytes
an attention call needs, its pair counts per stage, and its arguments."""

import types

import numpy as np
import pytest
import torch

import chip_smoke
from stratified_transformer_torch.config import load_config
from stratified_transformer_torch.data.loader import host_batch, to_device
from stratified_transformer_torch.models.stratified import build_model
from stratified_transformer_torch.train.step import make_eval_step

torch.set_num_threads(1)

NARROW = dict(n_pad=2048, num_scenes=2, channels=(16, 32, 64, 128),
              num_heads=(1, 2, 4, 8), depths=(1, 1, 2, 1))


@pytest.fixture(scope="module")
def narrow():
    cfg = load_config(chip_smoke.CONFIG, **NARROW)
    batch = to_device(host_batch(cfg, seed=0), "cpu")
    model = build_model(cfg, "cpu", seed=0)
    chip_smoke.o1_weights(model, seed=0)
    eval_step = make_eval_step(255, cfg.num_classes)
    return cfg, batch, model, eval_step, eval_step(model, batch)[0]


def test_o1_weights_give_o1_logits(narrow):
    logits = narrow[4]
    assert bool(torch.isfinite(logits).all())
    assert 0.3 < float(logits.std()) < 10.0


@pytest.mark.parametrize("table", ["rel_query_table", "rel_key_table",
                                   "rel_value_table"])
def test_dropped_table_term_fails_the_logit_comparison(narrow, table):
    """At these weights each cRPE term moves most logits by more than the
    comparison's tolerance, so a kernel that lost one could not pass."""
    cfg, batch, model, eval_step, logits = narrow
    broken = build_model(cfg, "cpu", seed=0)
    broken.load_state_dict(model.state_dict())
    with torch.no_grad():
        for name, p in broken.named_parameters():
            if name.endswith(table):
                p.zero_()
    moved = eval_step(broken, batch)[0]
    outside = (moved - logits).abs() > (chip_smoke.LOGIT_ATOL
                                        + chip_smoke.LOGIT_RTOL * logits.abs())
    assert float(outside.float().mean()) > 0.5


def test_least_ops_per_pair_form_when_rows_have_few_pairs():
    d, h, pairs = 16, 3, 1000
    ops = chip_smoke.least_ops(pairs, pairs, pairs, h, d, 64)
    assert ops == pairs * (h * (19 * d + 5) + 24)


def test_least_ops_projects_rows_with_many_pairs():
    d, h, nb, rows, per_row = 16, 12, 40, 100, 150
    pairs = rows * per_row
    proj = 6 * nb * d * rows + 3 * pairs
    ops = chip_smoke.least_ops(pairs, rows, rows, h, d, nb)
    assert ops == h * ((4 * d + 5) * pairs + 3 * proj) + 24 * pairs
    assert ops / pairs / h < 170


def test_least_ops_bwd_per_pair_form_when_rows_have_few_pairs():
    d, h, pairs = 16, 3, 1000
    ops = chip_smoke.least_ops_bwd(pairs, pairs, pairs, h, d, 64)
    # recompute, dq, dk, dv and g·o, plus eight per-pair table terms
    assert ops == h * ((10 * d + 5) * pairs + 2 * d * pairs
                       + 8 * 6 * d * pairs) + 24 * pairs


def test_least_ops_bwd_projects_rows_with_many_pairs():
    d, h, nb, rows, per_row = 16, 12, 40, 100, 150
    pairs = rows * per_row
    proj = 6 * nb * d * rows + 3 * pairs
    ops = chip_smoke.least_ops_bwd(pairs, rows, rows, h, d, nb)
    assert ops == h * ((10 * d + 5) * pairs + 2 * d * rows + 8 * proj) \
        + 24 * pairs
    # about 2.4x the forward's least work per pair and head
    fwd = chip_smoke.least_ops(pairs, rows, rows, h, d, nb)
    assert 2.0 < ops / fwd < 3.0


def test_backward_tolerance_floor_is_relative_to_the_tensor():
    want = torch.tensor([1000.0, 0.0, 1.0])
    got = want + torch.tensor([0.4, 0.005, 0.0])
    assert chip_smoke.grads_close("x", got, want) == pytest.approx(0.4,
                                                                  rel=1e-4)
    with pytest.raises(AssertionError, match="1 of 3"):
        chip_smoke.grads_close("x", want + torch.tensor([0.0, 0.02, 0.0]),
                               want)


def test_add_timing_sums_blocks_and_takes_the_larger_bound():
    report = chip_smoke.new_report(["k"])
    # 3.35 MB moved: 1 us by bytes; 67 MFLOP: 1 us by operations
    bound, by = chip_smoke.add_timing(report, "k", 2, 0.5, 4.0, 3.35e6,
                                      2 * 67e6, 1e-6)
    assert by == "operations" and bound == pytest.approx(2e-3)
    bound, by = chip_smoke.add_timing(report, "k", 1, 0.25, 1.0, 3 * 3.35e6,
                                      67e6, 5e-7)
    assert by == "bytes" and bound == pytest.approx(3e-3)
    r = report["k"]
    assert r["ms"] == pytest.approx(1.25) and r["plain_ms"] == 9.0
    assert r["bound_ms"] == pytest.approx(7e-3)
    assert r["bound_by"] == pytest.approx({"operations": 4e-3,
                                           "bytes": 3e-3})
    assert r["max_abs_err"] == 1e-6


@pytest.mark.parametrize("fn", ["least_ops", "least_ops_bwd"])
@pytest.mark.parametrize("rows, per_row", [(1000, 1), (100, 150)])
def test_split_ops_add_up_to_the_total(fn, rows, per_row):
    """Phase 14's bound splits the least operations into the products (bf16
    operands in the fast forms) and the rest (fp32), which add up to the
    fp32 kernels' count; g·o, r, dl and the bins are never products."""
    d, h, nb = 16, 12, 40
    pairs = rows * per_row
    count = getattr(chip_smoke, fn)
    products, other = count(pairs, rows, rows, h, d, nb, split=True)
    assert products + other == count(pairs, rows, rows, h, d, nb)
    assert other >= 24 * pairs + h * 5 * pairs
    assert products >= h * 4 * d * pairs


def test_fast_bound_takes_products_at_the_bf16_peak():
    """989 TFLOP/s of products and 67 TFLOP/s of the rest may run together:
    the slower of the two sets the bound."""
    assert chip_smoke.ops_seconds(67e6) == pytest.approx(1e-6)
    assert chip_smoke.ops_seconds((989e6, 6.7e6)) == pytest.approx(1e-6)
    assert chip_smoke.ops_seconds((9.89e6, 67e6)) == pytest.approx(1e-6)
    report = chip_smoke.new_report(["k"])
    bound, by = chip_smoke.add_timing(report, "k", 1, 0.5, 4.0, 3.35e6,
                                      (2 * 989e6, 67e6), 1e-6)
    assert by == "operations" and bound == pytest.approx(2e-3)


def test_phases_2_to_13_pin_the_fp32_kernels():
    """The shipped YAML selects the fast forms; the helper that phases 2-13
    read it through keeps the fp32 kernels, as PRs 1-8 ran them."""
    from stratified_transformer_torch.config import from_cfg
    assert load_config(chip_smoke.CONFIG).fast
    for path in (chip_smoke.CONFIG, chip_smoke.SCANNET_CONFIG,
                 chip_smoke.DCF_CONFIG):
        assert not from_cfg(chip_smoke.yaml_fp32(path)).fast
    assert not load_config(chip_smoke.CONFIG, **chip_smoke.FP32).fast
    assert set(chip_smoke.FAST_KERNELS) == {
        n + "_bf16" for n in chip_smoke.FWD_KERNELS + chip_smoke.BWD_KERNELS}


@pytest.mark.parametrize("err, control, failures", [
    (1e-5, 3e-3, 0),        # within the gate, the fp32 form beyond it
    (3e-4, 3e-3, 1),        # beyond the gate
    (1e-5, 1e-4, 1),        # a gate that the fp32 form would pass
    (3e-4, 1e-4, 2),
    (1e-5, None, 0)])       # no control
def test_fast_gate_records_each_failure(monkeypatch, err, control, failures):
    monkeypatch.setattr(chip_smoke, "FAST_FAILURES", [])
    chip_smoke.fast_gate("k", err, 2e-4, control)
    assert len(chip_smoke.FAST_FAILURES) == failures


def test_plain_in_kernel_slices_rounds_the_key_masses_per_slice(monkeypatch):
    """Within `plain_in_kernel_slices` the fused attention's plain backward
    takes the kernels' row slices (here 16 rows of a 32-row tile, from each
    call's table rows): only dk and the key table's gradient move."""
    from stratified_transformer_torch.ops import plan as torch_plan
    from stratified_transformer_torch.ops.attention_fused import (
        stratified_attention_fused)
    asked = []
    monkeypatch.setattr(chip_smoke, "kernel_slice_rows",
                        lambda name, dev, nb, fast=True:
                        asked.append((name, nb, fast)) or 16)
    gen = torch.Generator().manual_seed(0)
    n_pad, h = 256, 2
    xyz = torch.rand(n_pad, 3, generator=gen) * 2
    batch = torch.repeat_interleave(torch.tensor([0, 1, 2], dtype=torch.int32),
                                    torch.tensor([100, 100, 56]))
    valid = batch < 2
    is_down = (torch.rand(n_pad, generator=gen) < 0.4) & valid
    plan = torch_plan.build_attention_plan(xyz, batch, valid, 0.5,
                                           shifted=False, is_down=is_down,
                                           sparse_cap=16)
    leaves = [torch.randn(n_pad, h, 16, generator=gen) for _ in range(3)] + [
        torch.randn(16, h, 16, 3, generator=gen) * 0.05 for _ in range(3)]
    leaves = [x.requires_grad_(True) for x in leaves]

    def grads():
        out = stratified_attention_fused(
            *leaves[:3], plan.xyz_sorted, plan.seg_start, plan.seg_end,
            plan.valid_sorted, plan.sparse_band, *leaves[3:],
            window_size=0.5, quant_size=0.125, scale=0.25, band=32, tile=32,
            s_band=64, plain=True, fast=True)
        return torch.autograd.grad(out.sum(), leaves)

    tile = grads()
    with chip_smoke.plain_in_kernel_slices(torch.device("cpu")):
        sliced = grads()
    assert asked == [("band_attention_bwd", 13, True),
                     ("sparse_band_attention_bwd", 16, True)]
    for name, a, b in zip(("q", "k", "v", "tq", "tk", "tv"), tile, sliced):
        assert torch.equal(a, b) is (name not in ("k", "tk")), name


def test_chip_smoke_refuses_unknown_arguments_or_a_missing_card(capsys):
    # without a card it exits non-zero before reading its arguments
    rc = chip_smoke.main(["--no-such-option"])
    assert rc != 0
    if not torch.cuda.is_available():
        assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("argv, want", [
    ([], None),
    (["--fwd-only"], "--fwd-only"),
    (["--bwd-only"], "--bwd-only"),
    (["--scene-only"], "--scene-only"),
    (["--loop-only"], "--loop-only"),
    (["--iou-only"], "--iou-only"),
    (["--scannet-only"], "--scannet-only"),
    (["--dcf-only"], "--dcf-only"),
    (["--fast-only"], "--fast-only"),
    (["--swin-only"], "--swin-only"),
    (["--dp-only"], "--dp-only"),
    (["--fwd-phases"], "--fwd-phases"),
    (["--prep-only"], "--prep-only"),
    (["--swin-bwd-phases"], "--swin-bwd-phases"),
    (["--swin-fwd-phases"], "--swin-fwd-phases"),
    (["--probe-only"], "--probe-only"),
    (["--gather-only"], "--gather-only"),
])
def test_parse_args_picks_the_phase_run_alone(argv, want):
    assert chip_smoke.parse_args(argv) == want
    if want is not None:
        # the kernels it builds: the forward pair for phases 4 and 10 and
        # the IoU timing, all four attention kernels for phases 11-14 and
        # 16, the two band kernels for phase 15 and the swin kernels'
        # splits (Swin3D has no far keys), all seven sources for phase 9
        # (whose cache-key processes reuse every library), the masked row
        # gather alone for phase 19
        both = chip_smoke.FWD_KERNELS + chip_smoke.BWD_KERNELS
        band = ("band_attention", "band_attention_bwd")
        assert chip_smoke.PHASE_ONLY[want] == {
            "--bwd-only": chip_smoke.BWD_KERNELS, "--loop-only": both,
            "--scannet-only": both, "--dcf-only": both, "--fast-only": both,
            "--swin-only": band, "--dp-only": both,
            "--swin-bwd-phases": band, "--swin-fwd-phases": band,
            "--probe-only": (tuple(chip_smoke.TPU_KERNELS)
                             + chip_smoke.GATHER_KERNELS),
            "--gather-only": chip_smoke.GATHER_KERNELS,
        }.get(want, chip_smoke.FWD_KERNELS)


PHASE_CUTS = ([("fwd", tag) for tag in chip_smoke.FWD_PHASE_CUTS]
              + [("bwd", tag) for tag in chip_smoke.BWD_PHASE_CUTS])


@pytest.mark.parametrize("kind,phase", PHASE_CUTS)
def test_phase_cuts_match_the_sources(kind, phase):
    """Each ``--fwd-phases`` / ``--bwd-phases`` cut of a phase names text
    that occurs exactly once in its source in ``csrc/``, so that a variant
    build cuts that phase and only it (a cut whose text a checkout lacks is
    skipped at run time, as in a parent checkout without the tensor-core
    routine); every phase cuts the tensor-core routine the fast forms run,
    and the variant sources still parse as C++ text (balanced braces)."""
    import os
    from stratified_transformer_torch.kernels import build
    cuts = (chip_smoke.FWD_PHASE_CUTS if kind == "fwd"
            else chip_smoke.BWD_PHASE_CUTS)[phase]
    tc = chip_smoke.FWD_TC if kind == "fwd" else chip_smoke.TC
    assert any(fn == tc for fn, _, _ in cuts)
    for fn, old, new in cuts:
        with open(os.path.join(build.CSRC, fn)) as f:
            text = f.read()
        assert text.count(old) == 1, (fn, old)
        cut = text.replace(old, new)
        assert cut.count("{") - cut.count("}") == (
            text.count("{") - text.count("}")), (fn, old)


@pytest.mark.parametrize("phase", list(chip_smoke.SWIN_BWD_PHASE_CUTS))
def test_swin_bwd_phase_cuts_match_the_source(phase):
    """Each ``--swin-bwd-phases`` cut names text that occurs exactly once in
    the fp32 backward routine (``csrc/attention_bwd_common.cuh``), so that a
    variant build cuts that phase and only it, and the variant still parses
    as C++ text (balanced braces); the flag's variants build the band
    backward alone and call its fp32 entry point."""
    import os
    from stratified_transformer_torch.kernels import build
    cuts = chip_smoke.SWIN_BWD_PHASE_CUTS[phase]
    assert cuts and all(fn == chip_smoke.BWD_OLD for fn, _, _ in cuts)
    for fn, old, new in cuts:
        with open(os.path.join(build.CSRC, fn)) as f:
            text = f.read()
        assert text.count(old) == 1, (fn, old)
        cut = text.replace(old, new)
        assert cut != text and cut.count("{") - cut.count("}") == (
            text.count("{") - text.count("}")), (fn, old)
    assert chip_smoke.PHASE_ONLY["--swin-bwd-phases"] == (
        "band_attention", "band_attention_bwd")


@pytest.mark.parametrize("phase", list(chip_smoke.SWIN_FWD_PHASE_CUTS))
def test_swin_fwd_phase_cuts_match_the_source(phase):
    """Each ``--swin-fwd-phases`` cut names text that occurs exactly once in
    its forward source in ``csrc/``, so that a variant build cuts that
    phase and only it, and the variant still parses as C++ text (balanced
    braces); the flag's variants build the band forward alone and call its
    fp32 entry point."""
    import os
    from stratified_transformer_torch.kernels import build
    cuts = chip_smoke.SWIN_FWD_PHASE_CUTS[phase]
    assert cuts
    for fn, old, new in cuts:
        with open(os.path.join(build.CSRC, fn)) as f:
            text = f.read()
        assert text.count(old) == 1, (fn, old)
        cut = text.replace(old, new)
        assert cut != text and cut.count("{") - cut.count("}") == (
            text.count("{") - text.count("}")), (fn, old)
    assert chip_smoke.PHASE_ONLY["--swin-fwd-phases"] == (
        "band_attention", "band_attention_bwd")


def test_bincount_iou_equals_the_port_counters():
    """The ``--iou-only`` comparison form counts what the port's
    scatter-add counters count."""
    from stratified_transformer_torch.train import metrics
    g = torch.Generator().manual_seed(0)
    target = torch.randint(0, 13, (4096,), generator=g)
    target[torch.rand(4096, generator=g) < 0.1] = 255
    pred = torch.randint(0, 13, (4096,), generator=g)
    pred[:2000] = target[:2000].clamp_max(12)
    valid = torch.arange(4096) < 3500
    got = chip_smoke.bincount_iou(pred, target, 13, 255, valid)
    want = metrics.intersection_and_union(pred, target, 13, 255, valid)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(want[0].sum()) > 0


@pytest.mark.parametrize("argv", [["--fwd"], ["--fwd-only", "--bwd-only"],
                                  ["--fwd-only", "x"], ["fwd-only"],
                                  ["--probe-only", "runs/parent"]])
def test_parse_args_refuses_anything_else(argv):
    with pytest.raises(ValueError, match="--fwd-only"):
        chip_smoke.parse_args(argv)


@pytest.mark.parametrize("flag", ["--fwd-only", "--bwd-only",
                                  "--scene-only", "--loop-only",
                                  "--iou-only", "--scannet-only",
                                  "--dcf-only", "--swin-only", "--dp-only",
                                  "--fwd-phases", "--prep-only",
                                  "--swin-bwd-phases", "--swin-fwd-phases",
                                  "--probe-only"])
def test_phase_only_runs_need_a_card(flag, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the run without a card")
    assert chip_smoke.main([flag]) != 0
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and out.out == ""


def test_log_pairs_counts_every_stage(narrow, capsys):
    cfg = narrow[0]
    hb = host_batch(cfg, seed=0)
    chip_smoke.log_pairs("eval batch 0", cfg, hb, "cpu")
    line = capsys.readouterr().out.strip()
    assert line.startswith("[pairs] eval batch 0: stage 0: ")
    stages = line.split(": ", 1)[1].split("; ")
    assert len(stages) == cfg.num_layers
    for i, part in enumerate(stages):
        words = part.replace(",", "").split()
        # "stage i: P points band B sparse S"
        assert words[0:2] == ["stage", f"{i}:"]
        points, band, far = int(words[2]), int(words[5]), int(words[7])
        # every valid point is its own band key
        assert points > 0 and band >= points and far >= 0


def test_fwd_bytes_counts_far_keys_at_the_aux_slots():
    from types import SimpleNamespace
    n, a, h, d = 256, 64, 2, 16
    q, k, v = (torch.zeros(n, h, d) for _ in range(3))
    outs = (torch.zeros(n, h, d), torch.zeros(n, h), torch.zeros(n, h))
    sb = SimpleNamespace(sb_src=torch.zeros(a, dtype=torch.int32))
    full = chip_smoke.nbytes((q, k, v) + outs)
    assert chip_smoke.fwd_bytes("band_attention", (q, k, v), outs, sb) == full
    assert chip_smoke.fwd_bytes("sparse_band_attention", (q, k, v), outs,
                                sb) == full - 2 * (n - a) * h * d * 4


SCANNET_NARROW = dict(channels=(16, 16, 32, 64, 64), num_heads=(1, 1, 2, 4, 4),
                      depths=(3, 1, 1, 2, 1), n_pad=2048, num_scenes=2)


def test_log_pairs_counts_the_scannet_stages(capsys):
    """Phase 12's ScanNet configuration: transformer stages 1-4 over the
    host pyramid's levels 1-4 (level 0 is the stem's skip level), and one
    launch of each kernel per block of stages 1-4 only."""
    cfg = load_config(chip_smoke.SCANNET_CONFIG, **SCANNET_NARROW)
    assert cfg.layer_start == 1 and chip_smoke.attention_blocks(cfg) == 5
    hb = host_batch(cfg, seed=0, **dict(chip_smoke.SCANNET_ROOMS,
                                        points=1300, voxel_max=1000))
    levels = chip_smoke.stage_levels(cfg, hb)
    assert levels[0][2] is None
    assert [len(lv[2]) for lv in levels[1:]] == [len(lv[0])
                                                 for lv in levels[1:]]
    chip_smoke.log_pairs("scannet batch 0", cfg, hb, "cpu")
    parts = capsys.readouterr().out.strip().split(": ", 1)[1].split("; ")
    assert [p.split(":")[0] for p in parts] == [
        f"stage {i}" for i in range(1, 5)]


def test_stem_key_bound_covers_the_cell_keys():
    """The bound is slots x the batch's cells (2.5-grid cells) less one, at
    or above every key the stem's cell list gives a point."""
    from stratified_transformer_torch.ops import hashing, sampling
    cfg = load_config(chip_smoke.SCANNET_CONFIG, **SCANNET_NARROW)
    g = torch.Generator().manual_seed(0)
    xyz = torch.rand(2048, 3, generator=g) * torch.tensor([1.0, 2.0, 0.5])
    offsets = torch.tensor([900, 1700])
    bound = chip_smoke.stem_key_bound(cfg, xyz, offsets)
    valid = sampling.offsets_to_valid(offsets, 2048)
    cells = hashing.window_cells(xyz, 0.05, start=hashing.masked_min(
        xyz, valid))
    keys = hashing.window_keys(cells, sampling.offsets_to_batch(offsets, 2048),
                               valid)
    hi = cells[:1700].max(0).values + 1
    assert bound == 2 * int(hi.prod()) - 1
    assert int(keys[valid].max()) <= bound


def test_cube_scene_is_a_dcf_file(tmp_path):
    """Phase 13's fabricated scenes read through the port's ``DCF`` reader:
    faces labelled 0-5, edges 6-17, each offset pointing to the centre of
    its face or edge (the sample plus its offset lies on the cube's
    surface, at the face's centre on the face's axis)."""
    from stratified_transformer_torch.data.datasets import DCF
    from stratified_transformer_torch.eval.instantiation import LOOKUP_FACE
    [path] = chip_smoke.write_cube_files(str(tmp_path), "test", 1, 0,
                                         cubes=3, points_per_cube=600,
                                         extent=2.0)
    coord, labels, offsets, feat, params = DCF.load_item(path)
    assert len(coord) == 3 * (6 * 80 + 12 * 10) and params.shape == (3, 6)
    assert sorted(set(labels.tolist())) == list(range(18))
    centre = coord + offsets
    per_cube = len(coord) // 3
    for c in range(3):
        mid, size = params[c, :3], params[c, 3:]
        rows = slice(c * per_cube, (c + 1) * per_cube)
        for f, (axis, side) in enumerate(chip_smoke.CUBE_FACES):
            at = centre[rows][labels[rows] == f]
            np.testing.assert_allclose(at, np.tile(mid + np.eye(3)[axis]
                                                   * side * size / 2,
                                                   (len(at), 1)), atol=1e-12)
        for e, (a, b) in enumerate(LOOKUP_FACE):
            (ia, sa), (ib, sb) = (chip_smoke.CUBE_FACES[a],
                                  chip_smoke.CUBE_FACES[b])
            assert ia != ib
            want = mid + (np.eye(3)[ia] * sa + np.eye(3)[ib] * sb) * size / 2
            at = centre[rows][labels[rows] == 6 + e]
            np.testing.assert_allclose(at, np.tile(want, (len(at), 1)),
                                       atol=1e-12)


def test_swin_levels_and_plans_have_no_far_keys(capsys):
    """Phase 15's levels and plans under the S3DIS Swin YAML: no member
    masks, no far-key layout, no far pairs in the ``[pairs]`` line."""
    from stratified_transformer_torch.config import load_config
    cfg = load_config(chip_smoke.SWIN_CONFIG, n_pad=2048, num_scenes=2,
                      channels=(16, 32, 64, 128), num_heads=(1, 2, 4, 8))
    hb = host_batch(cfg, seed=0)
    levels = chip_smoke.stage_levels(cfg, hb)
    assert [lv[2] for lv in levels] == [None] * cfg.num_layers
    plan = chip_smoke.build_plan(cfg, 0, levels[0], True, "cpu")
    assert plan.sparse_band is None
    chip_smoke.log_pairs("swin batch 0", cfg, hb, "cpu")
    line = capsys.readouterr().out
    assert line.count("sparse 0") == cfg.num_layers


def test_swin_bound_counts_the_swin_bins():
    """The swin bins cost fewer operations per pair than the stratified
    bins; the rest of the bound is the same."""
    args = (10000, 500, 500, 3, 16, 31)
    for fn in (chip_smoke.least_ops, chip_smoke.least_ops_bwd):
        strat = fn(*args)
        swin = fn(*args, bin_ops=chip_smoke.BIN_OPS["swin_window"])
        assert strat - swin == 10000 * (chip_smoke.BIN_OPS["stratified"]
                                        - chip_smoke.BIN_OPS["swin_window"])


def test_device_busy_reading_of_zero_fails(monkeypatch):
    """A profiled session is held complete: one record of an attention
    kernel per launch its wrapper counted, each kernel ``reps`` times over,
    some device time. A session that lost all or part of its device
    records fails its phase rather than being recorded low."""
    from stratified_transformer_torch.kernels import band_attention as bk

    def event(name, us):
        return types.SimpleNamespace(
            name=name, device_type=torch.autograd.DeviceType.CUDA,
            time_range=types.SimpleNamespace(elapsed_us=lambda: us))

    band = "void stratified::band_attention_kernel<16, 64, false, true>(...)"
    sparse = ("void stratified::sparse_band_attention_kernel<16, 64, false>"
              "(...)")
    session = []

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return session

    def launch():
        bk.KERNEL.launches += 1

    monkeypatch.setattr(bk.KERNEL, "launches", bk.KERNEL.launches)
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    session[:] = [event(band, 300.0), event("copy", 100.0)] * 2
    wall, by_name = chip_smoke.device_kernels(launch, 2)
    assert by_name == {band: (0.6, 2), "copy": (0.2, 2)}
    assert chip_smoke.profiled_busy_ms(launch, 2) == pytest.approx(0.4)
    session[:] = session[:2]
    assert chip_smoke.profile_call("forward", launch)[1] == pytest.approx(0.4)
    for lost in ([event(band, 300.0), event("copy", 100.0)],     # part
                 [event(band, 300.0), event(sparse, 50.0)] * 2,  # not ours
                 [event("copy", 100.0)] * 3,                     # uneven
                 []):                                            # all
        session[:] = lost
        with pytest.raises(AssertionError, match="lost device records"):
            chip_smoke.device_kernels(launch, 2)
    with pytest.raises(AssertionError, match="lost device records"):
        chip_smoke.profile_call("forward", lambda: None)


def test_plain_in_kernel_slices_takes_the_whole_swin_table(monkeypatch):
    """Under the swin bins the plain fast backward's row slices are asked
    for the whole 31-row table (no band slice)."""
    from stratified_transformer_torch.ops import attention as plain
    from stratified_transformer_torch.ops import attention_fused
    asked = []
    monkeypatch.setattr(chip_smoke, "kernel_slice_rows",
                        lambda name, dev, nb, fast: asked.append(
                            (name, nb)) or None)
    tables = tuple(torch.zeros(31, 1, 16, 3) for _ in range(3))
    x = torch.zeros(128, 1, 16)
    with chip_smoke.plain_in_kernel_slices(torch.device("cpu")):
        attention_fused.band_attention_bwd_plain(
            x, x, x, torch.zeros(128, 3), torch.zeros(128, dtype=torch.int32),
            torch.zeros(128, dtype=torch.int32),
            torch.zeros(128, dtype=torch.bool), x, x, torch.zeros(128, 1),
            torch.ones(128, 1), *tables, window_size=0.16, quant_size=0.01,
            scale=0.25, band=0, rpe_mode="swin_window")
    assert asked == [("band_attention_bwd", 31)]
    assert plain.band_slice(31, "swin_window") == (0, 31)


def test_legacy_phase_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    """Phase 18 (d) at a small size, the CPU against itself: every op runs
    and reports, divide2patch's rows agree."""
    monkeypatch.setitem(chip_smoke.LEGACY, "n", 512)
    monkeypatch.setitem(chip_smoke.LEGACY, "m", 64)
    monkeypatch.setitem(chip_smoke.LEGACY, "patch_n_pad", 64)
    scans = chip_smoke.write_scannet_scans(str(tmp_path), "val", 2, seed=0,
                                           points=2000, extent=2.0)
    report = chip_smoke.legacy_phase(chip_smoke.legacy_inputs(scans),
                                     torch.device("cpu"))
    assert len(report) == 13
    assert report["divide2patch"]["near_tie_rows"]["rows"] == 0
    assert "integers equal" in capsys.readouterr().out


def test_knn_near_ties_takes_ties_and_refuses_farther_picks():
    rng = np.random.default_rng(0)
    xyz = rng.uniform(0, 5, (200, 3))
    xyz[11] = xyz[10]                          # a tie at the same point
    d = ((xyz[:, None] - xyz[None]) ** 2).sum(-1)
    want = torch.from_numpy(np.argsort(d, 1, kind="stable")[:, :8])
    got = want.clone()
    row = int(np.nonzero((want == 10).any(1).numpy())[0][0])
    got[row][got[row] == 10] = 11
    ties = chip_smoke.knn_near_ties(got, want, xyz)
    assert ties["rows"] == 1 and ties["max_gap_m2"] == 0.0
    far = want.clone()
    far[0, -1] = int(np.argsort(d[0])[-1])     # the farthest point
    with pytest.raises(AssertionError, match="kNN rows differ"):
        chip_smoke.knn_near_ties(far, want, xyz)
