"""PyTorch port, sharded whole-scene inference: the model's grid anchor
(``Stratified.forward(anchor=...)``, the JAX package's ``apply(...,
anchor=...)``) at narrow S3DIS-, ScanNet- and Swin3D-style configurations,
and `evaluate_scene_sharded` on a small room on two gloo ranks against
JAX's on two virtual devices. Helpers and tolerances: ``test_torch_halo.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratified_transformer_tpu.eval import voting as jax_voting
from stratified_transformer_tpu.models.stratified import (
    Stratified as JaxStratified)
from stratified_transformer_tpu.ops import attention as jax_attention
from stratified_transformer_tpu.ops.plan import (
    build_attention_plan as jax_plan)
from stratified_transformer_tpu.parallel.mesh import make_mesh
from stratified_transformer_torch.data import loader
from stratified_transformer_torch.data.datasets import SyntheticRooms
from stratified_transformer_torch.eval import voting
from stratified_transformer_torch.models.stratified import (
    Stratified, geometry_pyramid, stem_neighbors)
from stratified_transformer_torch.ops import sampling
from stratified_transformer_torch.ops.plan import build_attention_plan
from test_torch_halo import (  # noqa: F401 (_literal_bins: autouse)
    ANCHORS, ATOL, FAMILIES, RTOL, _anchor, _assert_tree_equal,
    _literal_bins, _narrow, _weights, jax_probs_fn, jax_pyramid_anchored,
    run_ranks)
from test_torch_whole_scene import literal_bins

torch.set_num_threads(1)


@pytest.mark.parametrize("anchor", sorted(ANCHORS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_with_anchor_matches_jax(family, anchor):
    """Anchored stem neighbours, pyramid (sampler indices, kNN tables,
    members) and every stage's plans bit-identical to JAX's; the logits of
    ``forward(anchor=...)`` within RTOL / ATOL of ``apply(anchor=...)``;
    and the anchor moves the grids (the offset anchor's pyramid differs
    from the batch-min one's)."""
    cfg, jcfg = _narrow(family, down_quota="cells", num_scenes=2)
    hb = loader.host_batch(cfg, seed=0, **FAMILIES[family][1])
    xyz, off = torch.from_numpy(hb["xyz"]), torch.from_numpy(
        hb["offsets"]).long()
    a = _anchor(anchor, hb["xyz"], hb["offsets"])
    at = torch.from_numpy(a)
    nidx, nmask, pyr = jax.jit(lambda x, o, a_: jax_pyramid_anchored(
        jcfg, x, o, a_))(hb["xyz"], hb["offsets"], a)
    got_stem = stem_neighbors(cfg, xyz, off, at)
    _assert_tree_equal(got_stem, (nidx, nmask), "stem")
    got = geometry_pyramid(cfg, xyz, off, at)
    _assert_tree_equal(got, pyr, "pyramid")
    if anchor == "offset" and cfg.use_stratified:
        plain = geometry_pyramid(cfg, xyz, off)
        assert any(not torch.equal(g["is_down"], p["is_down"]) for g, p in
                   zip(got["stage_down"], plain["stage_down"]))
    # every stage's plans on its level
    levels = [(xyz, off)]
    for lvl in got["down"]:
        levels.append((levels[-1][0][lvl["idx"]], lvl["offsets"]))
    for si, i in enumerate(range(cfg.layer_start, cfg.num_layers)):
        lx, loff = levels[i]
        m = lx.shape[0]
        batch = sampling.offsets_to_batch(loff, m)
        valid = sampling.offsets_to_valid(loff, m)
        is_down = got["stage_down"][si]["is_down"] if cfg.use_stratified \
            else None
        d_pad = m // cfg.downsample_scale + cfg.num_scenes
        aux = ((d_pad + 127) // 128) * 128 if is_down is not None else None
        for parity in (False, True):
            p = build_attention_plan(
                lx, batch, valid, cfg.window_sizes()[i], shifted=parity,
                is_down=is_down, sparse_cap=cfg.sparse_cap, aux_pad=aux,
                anchor=at)
            w = jax_plan(lx.numpy(), batch.numpy(), valid.numpy(),
                         cfg.window_sizes()[i], shifted=parity,
                         is_down=None if is_down is None else is_down.numpy(),
                         sparse_cap=cfg.sparse_cap, aux_pad=aux, anchor=a)
            for field in ("order", "inv_order", "seg_start", "seg_end",
                          "valid_sorted", "xyz_sorted", "grid_start"):
                _assert_tree_equal(getattr(p, field), getattr(w, field),
                                   f"stage {i} {parity} {field}")
            if is_down is not None:
                _assert_tree_equal(tuple(p.sparse_band),
                                   tuple(w.sparse_band), f"stage {i} band")
    variables, state = _weights(jcfg, hb)
    model = Stratified(cfg)
    model.load_state_dict(state, strict=True)
    model.eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(hb["feats"]), xyz, off,
                       anchor=at)[0].numpy()
    want = np.asarray(jax.jit(lambda f, x, o, a_: JaxStratified(jcfg).apply(
        variables, f, x, o, training=False, stem_nidx=nidx, stem_nmask=nmask,
        pyramid=pyr, anchor=a_)[0])(hb["feats"], hb["xyz"], hb["offsets"], a))
    n = int(hb["offsets"][-1])
    np.testing.assert_allclose(logits[:n], want[:n], rtol=RTOL, atol=ATOL)


# ---- evaluate_scene_sharded ------------------------------------------------

# a small room of NARROW's model on two ranks, with a halo below its
# receptive field so that the blocks do not each hold the whole chunk; two
# TTA passes (none, a rotation) keep the JAX side's time down
SCENE = dict(points=1200, extent=1.5)
SCENE_HALO, SCENE_PAD, SCENE_TTA = 0.4, 1024, (0, 2)


@pytest.fixture(scope="module")
def scene_job():
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_attention, "relative_position_index",
                      literal_bins)
        cfg, jcfg = _narrow("s3dis", n_pad=SCENE_PAD, num_scenes=1,
                            down_quota="cells")
        variables, state = _weights(jcfg, loader.host_batch(cfg, seed=0))
        coord, feat, _, _ = SyntheticRooms(num_scenes=1, seed=999,
                                           **SCENE).raw_scene(0)
        mesh2 = make_mesh(2)
        block = jax_probs_fn(jcfg, variables)
        apply = jax_probs_fn(dataclasses.replace(jcfg, n_pad=3 * SCENE_PAD),
                             variables)

        @jax.jit
        def predict_blocks(feats_b, xyz_b, offsets_b):
            return jax.vmap(block)(feats_b, xyz_b,
                                   offsets_b.astype(jnp.int32))

        def jax_scene(halo_cap, collective=True):
            stats = {}
            pred, probs = jax_voting.evaluate_scene_sharded(
                predict_blocks, coord, feat, 13, mesh=mesh2,
                halo_width=SCENE_HALO, block_pad=SCENE_PAD,
                transforms=[jax_voting.tta_transforms("s3dis")[i]
                            for i in SCENE_TTA], stats=stats,
                apply_probs=(lambda f, x, o: apply(
                    f, x, o.astype(jnp.int32))) if collective else None,
                core_pad=SCENE_PAD if collective else 0, halo_cap=halo_cap)
            return pred, probs, stats

        yield dict(cfg=cfg, state=state, coord=coord, feat=feat,
                   jax_scene=jax_scene)


def test_evaluate_scene_sharded_matches_jax(scene_job, tmp_path):
    """`evaluate_scene_sharded` on two ranks (the exchange, and host
    replication alone) against JAX's on a 2-device mesh: probabilities
    within the whole-scene test's tolerance, argmaxes equal where the top
    two differ, the counters equal; with a ``halo_cap`` of one tile the
    halo overflows in every chunk: JAX accepts the chunks degraded, the
    port re-runs each through host replication and logs it (divergence
    iii), so its result equals its host-replication run."""
    s = scene_job
    tfms = [voting.tta_transforms("s3dis")[i] for i in SCENE_TTA]
    kw = dict(halo_width=SCENE_HALO, block_pad=SCENE_PAD, transforms=tfms)
    job = {"model": ("stratified", dataclasses.asdict(s["cfg"]), s["state"]),
           "coord": s["coord"], "feat": s["feat"], "num_classes": 13,
           "calls": [("scene", dict(kw, core_pad=SCENE_PAD,
                                    halo_cap=SCENE_PAD)),
                     ("scene", dict(kw, core_pad=SCENE_PAD, halo_cap=128)),
                     ("scene", kw)]}
    coll, capped, host = run_ranks(job, 2, tmp_path)
    chunks = coll["stats"]["collective_chunks"]
    assert chunks > len(SCENE_TTA)
    for got, (pred, probs, stats) in ((coll, s["jax_scene"](SCENE_PAD)),
                                      (host, s["jax_scene"](
                                          0, collective=False))):
        np.testing.assert_allclose(got["probs"], probs, rtol=0, atol=1e-5)
        top2 = np.sort(probs, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-4
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(got["pred"][clear], pred[clear])
        assert got["stats"] == stats
    _, _, jstats = s["jax_scene"](128)
    assert jstats["collective_chunks"] == chunks
    assert jstats["halo_cap_dropped"] > 0
    assert "collective_rerun_chunks" not in jstats
    assert capped["stats"]["collective_rerun_chunks"] == chunks
    assert capped["stats"].get("collective_chunks", 0) == 0
    assert capped["stats"]["halo_cap_dropped"] == jstats["halo_cap_dropped"]
    assert len(capped["log"]) == chunks
    assert all("re-run through host replication" in line
               for line in capped["log"])
    np.testing.assert_array_equal(capped["probs"], host["probs"])
