"""PyTorch port, sharded whole-scene inference on ``tests/test_halo.py``'s
corridor: host replication and both halo exchanges on four gloo ranks
against the JAX package's on four virtual devices, and against the
whole-scene forward. Helpers and tolerances: ``test_torch_halo.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratified_transformer_tpu.models.stratified import (
    Stratified as JaxStratified)
from stratified_transformer_tpu.ops import attention as jax_attention
from stratified_transformer_tpu.parallel import halo as jax_halo
from stratified_transformer_tpu.parallel.mesh import make_mesh
from stratified_transformer_torch.config import StratifiedConfig
from stratified_transformer_torch.convert import from_flax
from stratified_transformer_torch.models.stratified import Stratified
from stratified_transformer_torch.parallel import halo
from test_halo import _real_model_setup
from test_torch_halo import (  # noqa: F401 (_literal_bins: autouse)
    ATOL, EXACT, RTOL, _literal_bins, jax_probs_fn, run_ranks)
from test_torch_whole_scene import literal_bins

torch.set_num_threads(1)


def _corridor():
    """``tests/test_halo.py``'s corridor and model (its seed), the JAX
    model's own initial weights, both packages' configs at a capacity."""
    jcfg, coord, feat = _real_model_setup(np.random.default_rng(123))
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(StratifiedConfig)
              if hasattr(jcfg, f.name)}
    fields["attn_impl"] = "fused"
    n = len(coord)
    n_full = ((n + 127) // 128) * 128
    xyz = np.zeros((n_full, 3), np.float32)
    xyz[:n] = coord - coord.min(0)
    feats = np.zeros((n_full, 6), np.float32)
    feats[:n] = np.concatenate([feat, xyz[:n]], 1)
    offsets = np.array([n], np.int32)
    jfull = dataclasses.replace(jcfg, n_pad=n_full, attn_impl="reference")
    variables = jax.tree_util.tree_map(np.asarray, JaxStratified(jfull).init(
        jax.random.PRNGKey(0), feats, xyz, offsets))
    return dict(jcfg=jcfg, fields=fields, coord=coord, feat=feat,
                inputs=(feats, xyz, offsets), n_full=n_full,
                variables=variables,
                state=from_flax(variables["params"],
                                variables["batch_stats"]))


@pytest.fixture(scope="module")
def corridor():
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_attention, "relative_position_index",
                      literal_bins)
        c = _corridor()
        n = len(c["coord"])
        jcfg = c["jcfg"]
        c["hw"] = halo.receptive_halo(StratifiedConfig(**c["fields"]))
        c["block_pad"] = ((n // 2 + 127) // 128) * 128
        c["core_pad"] = ((n // 4 + 255) // 128) * 128
        c["halo_cap"] = ((n // 8 + 127) // 128) * 128
        c["wide"] = max(float(np.diff(np.quantile(
            c["coord"][:, 0], np.linspace(0, 1, 5)))[1:-1].min()) * 1.2,
            c["hw"])
        c["halo_cap_ag"] = ((int(0.45 * n) + 127) // 128) * 128
        feats, xyz, offsets = c["inputs"]
        c["jax_full"] = np.asarray(jax.jit(jax_probs_fn(
            dataclasses.replace(jcfg, n_pad=c["n_full"]), c["variables"]))(
                feats, xyz, offsets))[:n]
        yield c


def _jax_paths(c):
    """JAX's host replication (halo and sub-window halo), its ``ppermute``
    exchange (likewise), its ``allgather`` exchange and its overflowed
    exchange, on a 4-device mesh: each ``(probs, stats)``."""
    mesh4 = make_mesh(4)
    jcfg, v = c["jcfg"], c["variables"]
    block = jax_probs_fn(dataclasses.replace(jcfg, n_pad=c["block_pad"]), v)

    @jax.jit
    def predict_blocks(feats_b, xyz_b, offsets_b):
        return jax.vmap(block)(feats_b, xyz_b, offsets_b.astype(jnp.int32))

    out = {}
    for key, width in (("host", c["hw"]), ("host_bad", 0.05)):
        stats = {}
        out[key] = (jax_halo.sharded_scene_probs(
            predict_blocks, c["coord"], c["feat"], jcfg.num_classes,
            mesh=mesh4, n_pad=c["block_pad"], halo=width, stats=stats),
            stats)
    for key, width, cap in (("ppermute", c["hw"], c["halo_cap"]),
                            ("ppermute_bad", 0.05, c["halo_cap"]),
                            ("allgather", c["wide"], c["halo_cap_ag"]),
                            ("huge", 1e9, c["halo_cap"])):
        apply = jax_probs_fn(dataclasses.replace(
            jcfg, n_pad=c["core_pad"] + 2 * cap), v)
        stats = {}
        out[key] = (jax_halo.sharded_scene_probs_collective(
            lambda f, x, o, apply=apply: apply(f, x, o.astype(jnp.int32)),
            c["coord"], c["feat"], jcfg.num_classes, mesh=mesh4,
            core_pad=c["core_pad"], halo_cap=cap, halo=width, stats=stats),
            stats)
    return out


def test_sharded_paths_match_jax(corridor, tmp_path):
    """On four ranks: host replication and both exchanges equal the
    whole-scene forward within EXACT where the halo covers the receptive
    field, and JAX's sharded probabilities within RTOL / ATOL, stats
    equal; the sub-window halo (0.05 m) diverges by more than 100x; a huge
    halo overflows ``halo_cap`` with JAX's count (divergence iii: the port
    raises before its forward where JAX accepts the chunk); a core slab
    beyond ``core_pad`` raises `CoreSlabOverflow`."""
    c = corridor
    n = len(c["coord"])
    ncls = c["jcfg"].num_classes
    coll = dict(core_pad=c["core_pad"], halo_cap=c["halo_cap"])
    calls = [("host", dict(n_pad=c["block_pad"], halo=c["hw"])),
             ("host", dict(n_pad=c["block_pad"], halo=0.05)),
             ("collective", dict(coll, halo=c["hw"])),
             ("collective", dict(coll, halo=0.05)),
             ("collective", dict(core_pad=c["core_pad"],
                                 halo_cap=c["halo_cap_ag"],
                                 halo=c["wide"])),
             ("collective", dict(coll, halo=1e9)),
             ("collective", dict(coll, core_pad=32, halo=c["hw"]))]
    job = {"model": ("stratified", c["fields"], c["state"]),
           "coord": c["coord"], "feat": c["feat"], "num_classes": ncls,
           "calls": calls}
    got = dict(zip(["host", "host_bad", "ppermute", "ppermute_bad",
                    "allgather", "huge", "core"],
                   run_ranks(job, 4, tmp_path)))

    # the port's whole-scene forward, against JAX's
    model = Stratified(StratifiedConfig(**dict(c["fields"],
                                               n_pad=c["n_full"])))
    model.load_state_dict(c["state"], strict=True)
    feats, xyz, offsets = (torch.from_numpy(a) for a in c["inputs"])
    full = halo.block_predict(model.eval())(
        feats, xyz, offsets.long()).numpy()[:n]
    np.testing.assert_allclose(full, c["jax_full"], rtol=RTOL, atol=ATOL)

    want = _jax_paths(c)
    assert got["ppermute"]["stats"]["collective_ppermute_scenes"] == 1
    assert got["allgather"]["stats"]["collective_allgather_scenes"] == 1
    for key in ("host", "host_bad", "ppermute", "ppermute_bad", "allgather"):
        probs, stats = got[key]["probs"], got[key]["stats"]
        np.testing.assert_allclose(probs, want[key][0], rtol=RTOL, atol=ATOL,
                                   err_msg=key)
        assert stats == want[key][1], key
    exact = {key: float(np.abs(got[key]["probs"] - full).max())
             for key in ("host", "ppermute", "allgather")}
    assert got["host"]["stats"]["truncated_halo_points"] == 0
    assert max(exact.values()) <= EXACT, exact
    for key in ("host_bad", "ppermute_bad"):
        err = float(np.abs(got[key]["probs"] - full).max())
        assert err > 100 * max(max(exact.values()), 1e-9) and err > 1e-5, (
            key, err)
    # (iii): JAX counts the overflow and returns the degraded chunk
    assert want["huge"][1]["halo_cap_dropped"] > 0
    assert got["huge"]["error"] == "HaloCapOverflow"
    assert got["huge"]["dropped"] == want["huge"][1]["halo_cap_dropped"]
    assert got["huge"]["stats"] == want["huge"][1]
    assert got["core"]["error"] == "CoreSlabOverflow"
