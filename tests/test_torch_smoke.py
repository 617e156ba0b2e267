"""Pieces of ``chip_smoke.py`` that run on the CPU: the weights its
full-width comparison runs at, its count of the least operations and bytes
an attention call needs, its pair counts per stage, and its arguments."""

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
])
def test_parse_args_picks_the_phase_run_alone(argv, want):
    assert chip_smoke.parse_args(argv) == want
    if want is not None:
        # the kernels it builds: the forward pair for phases 4 and 10 and
        # the IoU timing, all four attention kernels for phases 11 and 12
        both = chip_smoke.FWD_KERNELS + chip_smoke.BWD_KERNELS
        assert chip_smoke.PHASE_ONLY[want] == {
            "--bwd-only": chip_smoke.BWD_KERNELS, "--loop-only": both,
            "--scannet-only": both,
        }.get(want, chip_smoke.FWD_KERNELS)


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
                                  ["--fwd-only", "x"], ["fwd-only"]])
def test_parse_args_refuses_anything_else(argv):
    with pytest.raises(ValueError, match="--fwd-only"):
        chip_smoke.parse_args(argv)


@pytest.mark.parametrize("flag", ["--fwd-only", "--bwd-only",
                                  "--scene-only", "--loop-only",
                                  "--iou-only", "--scannet-only"])
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
