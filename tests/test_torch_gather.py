"""PyTorch port: the masked row gather (``ops/neighbors.py::GatherRows``,
``kernels/gather_rows.py``) on the CPU, where it runs its plain versions.

Its forward equals the expression it replaces, ``torch.where(mask, feats[idx],
fill)``, and its backward autograd's gradient of that expression, on
duplicate-heavy indices whose masked slots point at row 0 or at the row's
own index as collate makes them, with fills 0 and -inf, int32 and int64
indices and fully masked rows. The model takes it at its three gathers that
autograd differentiates, once per gather a train step, and never under
``torch.inference_mode``, ``torch.no_grad`` or for features that need no
gradient. The kernels themselves are held against these plain versions on
the card in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from stratified_transformer_torch.config import StratifiedConfig
from stratified_transformer_torch.data import loader
from stratified_transformer_torch.kernels import gather_rows as gather_k
from stratified_transformer_torch.models.kpconv import KPConv
from stratified_transformer_torch.models.stratified import build_model
from stratified_transformer_torch.ops import neighbors
from stratified_transformer_torch.ops.neighbors import GatherRows
from stratified_transformer_torch.train import schedulers
from stratified_transformer_torch.train.state import make_optimizer
from stratified_transformer_torch.train.step import make_train_step

torch.set_num_threads(1)

# a narrow S3DIS-style model (4 stages: 3 TransitionDowns, 3 Upsamples, a
# stem whose input features need no gradient) and a ScanNet-style one (5
# levels: 4 of each, and the residual KPConv block after the stem)
S3DIS = dict(num_classes=13, in_channels=6, channels=(16, 32, 64, 128),
             num_heads=(1, 2, 4, 8), depths=(1, 1, 2, 1), num_layers=4,
             n_pad=2048, num_scenes=2, tile=128, band=128,
             band_per_stage=(128, 128, 384, 192), sparse_cap=48, s_band=128,
             drop_path_rate=0.0)
SCANNET = dict(num_classes=20, in_channels=6, channels=(16, 16, 32, 64, 64),
               num_heads=(1, 1, 2, 4, 4), depths=(1, 1, 1, 2, 1),
               num_layers=5, window_size=5.0, grid_size=0.02,
               quant_size=0.005, downsample_scale=4, stem_transformer=False,
               n_pad=2048, num_scenes=2, tile=128, band=128,
               band_per_stage=(256, 256, 256, 384, 256), sparse_cap=64,
               s_band=128, drop_path_rate=0.0)
FAMILIES = {"s3dis": (S3DIS, {}, 3 + 3),
            "scannet": (SCANNET, dict(voxel_size=0.02, extent=1.0), 1 + 4 + 4)}


def _case(seed, idx_dtype, pad, rows=40, m=64, k=12):
    """``feats [rows, 5]``, ``idx``/``mask [m, k]``: unmasked slots drawn
    from 6 rows (every row named many times), masked slots (half of them,
    and the whole of every 5th row) at row 0 (``pad`` "row0") or at the
    row's own index ("own", as the down levels' kNN pads)."""
    gen = torch.Generator().manual_seed(seed)
    feats = torch.randn(rows, 5, generator=gen)
    idx = torch.randint(0, 6, (m, k), generator=gen)
    mask = torch.rand(m, k, generator=gen) < 0.5
    mask[::5] = False
    own = torch.arange(m)[:, None].expand(m, k) % rows
    idx = torch.where(mask, idx, 0 if pad == "row0" else own)
    return feats, idx.to(idx_dtype), mask


def _parent(feats, idx, mask, fill):
    g = feats[idx]
    return torch.where(mask[..., None], g, torch.full_like(g, fill))


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("fill", [0.0, -float("inf")])
@pytest.mark.parametrize("pad", ["row0", "own"])
def test_function_matches_the_indexing_expression(idx_dtype, fill, pad):
    feats, idx, mask = _case(0, idx_dtype, pad)
    x = feats.clone().requires_grad_(True)
    y = feats.clone().requires_grad_(True)
    got = GatherRows.apply(x, idx, mask, fill)
    want = _parent(y, idx.long(), mask, fill)
    assert torch.equal(got, want)
    # dyadic cotangents: every sum is exact, so any order gives the same
    g = torch.randint(-64, 64, got.shape).to(torch.float32) / 8
    gx, = torch.autograd.grad(got, x, g)
    gy, = torch.autograd.grad(want, y, g)
    assert torch.equal(gx, gy)
    # masked slots contribute nothing: rows named only by them get 0
    named = torch.zeros(feats.shape[0], dtype=torch.bool)
    named[idx.long()[mask]] = True
    assert not gx[~named].any() and gx[named].any()


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_plain_backward_adds_each_row_in_slot_order(idx_dtype):
    """The order the kernel keeps: each row's unmasked slots summed from 0
    in ascending slot order, so random fp32 values agree bit for bit."""
    feats, idx, mask = _case(1, idx_dtype, "row0", m=200, k=16)
    g = torch.randn(idx.shape + (5,), generator=torch.Generator()
                    .manual_seed(2))
    got = gather_k.gather_rows_bwd(g, idx, mask, feats.shape[0])
    want = np.zeros((feats.shape[0], 5), np.float32)
    flat_g = g.reshape(-1, 5).numpy()
    for s, (r, keep) in enumerate(zip(idx.reshape(-1).tolist(),
                                      mask.reshape(-1).tolist())):
        if keep:
            want[r] = want[r] + flat_g[s]
    assert np.array_equal(got.numpy(), want)


def test_fully_masked_rows_read_the_fill():
    feats, idx, mask = _case(3, torch.int64, "own")
    out = gather_k.gather_rows(feats, idx, mask, -float("inf"))
    assert torch.isneginf(out[::5]).all()
    assert torch.equal(out[mask], feats[idx[mask]])
    dfeats = gather_k.gather_rows_bwd(torch.ones_like(out), idx,
                                      torch.zeros_like(mask), feats.shape[0])
    assert torch.equal(dfeats, torch.zeros_like(feats))


@pytest.fixture
def gather_calls(monkeypatch):
    """A list that gets the ``fill`` of every `GatherRows` call."""
    calls = []
    apply = GatherRows.apply

    def counted(feats, idx, mask, fill):
        calls.append(fill)
        return apply(feats, idx, mask, fill)

    monkeypatch.setattr(GatherRows, "apply", counted)
    return calls


@pytest.mark.parametrize("grad", ["on", "no_grad", "inference", "frozen"])
def test_sites_take_the_function_only_where_autograd_records(gather_calls,
                                                             grad):
    feats, idx, mask = _case(4, torch.int64, "row0", rows=64, m=64)
    xyz = torch.rand(64, 3, generator=torch.Generator().manual_seed(5))
    w = feats.clone().requires_grad_(grad != "frozen")
    conv = KPConv(5, 4, 0.1)
    ctx = {"no_grad": torch.no_grad(),
           "inference": torch.inference_mode()}.get(grad)
    with ctx if ctx is not None else torch.enable_grad():
        group = neighbors.gather_group(w, idx, mask, fill=-float("inf"))
        interp = neighbors.interpolate_from_idx(xyz, xyz, w, idx[:, :3],
                                                mask[:, :3])
        conv(w, xyz, idx, mask)
    want = 3 if grad == "on" else 0
    assert gather_calls == [-float("inf"), 0.0, 0.0][:want]
    # the same values as the parent's expressions either way
    assert torch.equal(group, _parent(feats, idx, mask, -float("inf")))
    rows = feats[idx[:, :3]]
    d = torch.sqrt(((xyz[:, None] - xyz[idx[:, :3]]) ** 2).sum(-1))
    wts = neighbors.inverse_distance_weights(d, mask[:, :3])
    assert torch.equal(interp, (rows * wts[..., None]).sum(1))


def _family(name):
    kw, rooms, sites = FAMILIES[name]
    cfg = StratifiedConfig(**kw)
    batch = loader.to_device(loader.host_batch(cfg, seed=0, **rooms), "cpu")
    return cfg, build_model(cfg, "cpu", seed=0), batch, sites


def _forward(model, batch):
    return model(batch["feats"], batch["xyz"], batch["offsets"],
                 stem_nidx=batch["stem_nidx"], stem_nmask=batch["stem_nmask"],
                 pyramid=batch["pyramid"])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forwards_without_a_gradient_never_call_the_function(gather_calls,
                                                             family):
    _, model, batch, _ = _family(family)
    model.eval()
    with torch.inference_mode():
        _forward(model, batch)
    with torch.no_grad():
        _forward(model, batch)
    model.train()
    for p in model.parameters():
        p.requires_grad_(False)
    _forward(model, batch)
    assert gather_calls == []


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_calls_the_function_once_per_site(gather_calls, family):
    cfg, model, batch, sites = _family(family)
    model.train()
    opt = make_optimizer(model, schedulers.from_config(
        {"scheduler": "MultiStep", "scheduler_update": "epoch",
         "base_lr": 0.006, "epochs": 100}, 2)[0])
    step = make_train_step(255, cfg.num_classes)
    stats = step(model, opt, batch)
    assert torch.isfinite(stats["loss"])
    # the ScanNet stem's residual block (fill 0), each TransitionDown's
    # kNN group (-inf), each Upsample's 3-NN rows (0); S3DIS's stem reads
    # input features, which need no gradient
    downs = cfg.num_layers - 1
    stem = [0.0] if family == "scannet" else []
    assert gather_calls == stem + [-float("inf")] * downs + [0.0] * downs
    assert len(gather_calls) == sites
