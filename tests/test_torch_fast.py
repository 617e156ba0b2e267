"""PyTorch port, the bf16 fast mode that the shipped YAMLs select
(``rpe_precision``/``qk_precision: default``): the plain fast versions of
the four attention kernels, the fused attention and its VJP, and a narrow
model against the JAX package on the CPU; the config keys; the stage-3
divergence; and (marked ``cuda``) each fast kernel against its plain fast
version on the card.

On the CPU, a JAX contraction at DEFAULT precision is an fp32 contraction:
JAX's fast mode rounds only where its band forward stages bf16 or casts p
and the bin masses (``fused_attention.py:196-244,646-668``). The port
rounds every operand of a product that the TPU kernels contract at DEFAULT
(``ops/attention.py``, ``fast``). So the band forward agrees with JAX to
fp32 precision, and the rest to bf16 precision.

The JAX modules are imported inside the tests (`jax_modules`), so that the
card's machine, which has no JAX, runs the ``cuda`` tests with

    python -m pytest tests/test_torch_fast.py -q --noconftest -m cuda
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from stratified_transformer_torch.config import (
    StratifiedConfig, from_cfg, load_config)
from stratified_transformer_torch.kernels import band_attention as band_k
from stratified_transformer_torch.kernels import band_attention_bwd as band_bwd_k
from stratified_transformer_torch.kernels import block_limits
from stratified_transformer_torch.kernels import sparse_band_attention as sparse_k
from stratified_transformer_torch.kernels import (
    sparse_band_attention_bwd as sparse_bwd_k)
from stratified_transformer_torch.ops import attention as plain
from stratified_transformer_torch.ops import plan as torch_plan
from stratified_transformer_torch.ops.attention_fused import (
    stratified_attention_fused)
from stratified_transformer_torch.utils.config import (
    load_cfg, merge_cfg_from_list)

torch.set_num_threads(1)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
SHIPPED = ("s3dis_stratified.yaml", "scannetv2_stratified.yaml",
           "dcf_stratified.yaml")

H, D = 2, 16
WS, QUANT = 0.5, 0.125
NBINS = 2 * int((2 * WS + 1e-4) // QUANT)
SCALE = D ** -0.5
TILE, BAND, WCHUNK, S_BAND = 32, 32, 32, 64
# Where both sides round the same operands (the band forward): fp32 sums in
# another order, the JAX suite's tolerance between its own paths
# (tests/test_pallas_attention.py:63-64). Measured: acc equal, m and den
# within 3e-7.
RTOL, ATOL = 2e-4, 2e-5
# Where JAX computes fp32 on the CPU and the port rounds to bf16 (unit
# roundoff 2^-9): relative L2 over the tensor. Measured: 1.4e-3 to 2.5e-3
# (forward), 3.2e-3 to 6.1e-3 (gradients).
BF16_REL_L2 = 1e-2
# The fast and fp32 forms differ by more than this (max abs): the rounding
# really happens. Measured: ~1e-2.
ROUNDING_SEEN = 1e-6


def jax_modules():
    """The JAX package's modules these tests hold the port against."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    if jax.default_backend() != "cpu":
        pytest.skip("holds the port against the JAX package on the CPU, "
                    "where tests/conftest.py pins it")
    from stratified_transformer_tpu.ops import attention as jax_attn
    from stratified_transformer_tpu.ops import plan as jax_plan
    from stratified_transformer_tpu.ops.attention_fused import (
        stratified_attention_fused as jax_fused)
    from stratified_transformer_tpu.ops.pallas import fused_attention as fa
    from stratified_transformer_tpu.ops.pallas import (
        fused_attention_bwd as fab)
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, attn=jax_attn, plan=jax_plan, fused=jax_fused,
        band=fa.band_attention, sparse=fa.sparse_band_attention,
        band_bwd=fab.band_attention_bwd,
        sparse_bwd=fab.sparse_band_attention_bwd)


def _case(J, seed, n_valid=100, n_pad=128):
    """``tests/test_pallas_attention.py::_setup`` at d = 16: both packages'
    plans of one random cloud, q/k/v in window order, cRPE tables."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 2, (n_pad, 3)).astype(np.float32)
    batch = np.sort(rng.integers(0, 2, n_valid)).astype(np.int32)
    batch = np.concatenate([batch, np.full(n_pad - n_valid, 2, np.int32)])
    valid = np.arange(n_pad) < n_valid
    q, k, v, g = (rng.normal(size=(n_pad, H, D)).astype(np.float32)
                  for _ in range(4))
    is_down = (rng.uniform(size=n_pad) < 0.4) & valid
    tables = tuple((rng.normal(size=(NBINS, H, D, 3)) * 0.05
                    ).astype(np.float32) for _ in range(3))
    jp = J.plan.build_attention_plan(
        J.jnp.asarray(xyz), J.jnp.asarray(batch), J.jnp.asarray(valid), WS,
        shifted=False, is_down=J.jnp.asarray(is_down), sparse_cap=16)
    tp = torch_plan.build_attention_plan(
        torch.from_numpy(xyz), torch.from_numpy(batch),
        torch.from_numpy(valid), WS, shifted=False,
        is_down=torch.from_numpy(is_down), sparse_cap=16)
    o = np.asarray(jp.order)
    return jp, tp, (q[o], k[o], v[o]), g, tables


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def test_band_plain_fast_matches_pallas_fast():
    """The band forward's bf16 staging and casts round the same operands in
    both packages: fp32 agreement."""
    J = jax_modules()
    jp, tp, qkv, _, tables = _case(J, 0)
    kw = dict(window_size=WS, quant_size=QUANT, scale=SCALE, band=BAND,
              tile=TILE)
    want = J.band(*map(J.jnp.asarray, qkv), jp.xyz_sorted, jp.seg_start,
                  jp.seg_end, jp.valid_sorted, *map(J.jnp.asarray, tables),
                  **kw, w_chunk=WCHUNK, interpret=True, fast=True)
    args = tuple(map(_t, qkv)) + (tp.xyz_sorted, tp.seg_start, tp.seg_end,
                                  tp.valid_sorted) + tuple(map(_t, tables))
    got = plain.band_attention_plain(*args, **kw, fast=True)
    for g_, w_, name in zip(got, want, ("acc", "m", "den")):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    fp32 = plain.band_attention_plain(*args, **kw)
    assert _max_abs(got[0], fp32[0]) > ROUNDING_SEEN
    assert float(got[2].max()) > 0


def test_sparse_plain_fast_against_pallas_fast():
    """JAX's sparse forward stages fp32 and its DEFAULT products are fp32
    on the CPU; the port rounds them: bf16 agreement."""
    J = jax_modules()
    jp, tp, qkv, _, tables = _case(J, 1)
    kw = dict(window_size=WS, quant_size=QUANT, scale=SCALE, s_band=S_BAND,
              tile=TILE)
    want = J.sparse(*map(J.jnp.asarray, qkv), jp.sparse_band,
                    *map(J.jnp.asarray, tables), **kw, w_chunk=WCHUNK,
                    interpret=True, fast=True)
    args = tuple(map(_t, qkv)) + (tp.sparse_band,) + tuple(map(_t, tables))
    got = plain.sparse_band_attention_plain(*args, **kw, fast=True)
    for g_, w_, name in zip(got, want, ("acc", "m", "den")):
        assert _rel_l2(g_.numpy(), w_) <= BF16_REL_L2, name
    fp32 = plain.sparse_band_attention_plain(*args, **kw)
    assert _max_abs(got[0], fp32[0]) > ROUNDING_SEEN
    assert float(got[2].max()) > 0


def _residuals(J, jp, qkv, tables):
    """The merged fp32 forward of JAX's kernels (out, m, den), which both
    backward halves take."""
    kw = dict(window_size=WS, quant_size=QUANT, scale=SCALE, tile=TILE)
    parts = [J.band(*map(J.jnp.asarray, qkv), jp.xyz_sorted, jp.seg_start,
                    jp.seg_end, jp.valid_sorted, *map(J.jnp.asarray, tables),
                    **kw, band=BAND, w_chunk=WCHUNK, interpret=True),
             J.sparse(*map(J.jnp.asarray, qkv), jp.sparse_band,
                      *map(J.jnp.asarray, tables), **kw, s_band=S_BAND,
                      w_chunk=WCHUNK, interpret=True)]
    return tuple(np.asarray(x) for x in plain.merge(
        [tuple(_t(np.asarray(a)) for a in p) for p in parts]))


@pytest.mark.parametrize("half", ["band", "sparse"])
def test_bwd_plain_fast_against_pallas_fast(half):
    """Both backward kernels stage fp32 in JAX and round only in their
    DEFAULT products, fp32 on the CPU: bf16 agreement of every gradient."""
    J = jax_modules()
    jp, tp, qkv, g, tables = _case(J, 2)
    out, m, den = _residuals(J, jp, qkv, tables)
    kw = dict(window_size=WS, quant_size=QUANT, scale=SCALE, tile=TILE)
    res = (g, out, m, den)
    if half == "band":
        want = J.band_bwd(*map(J.jnp.asarray, qkv), jp.xyz_sorted,
                          jp.seg_start, jp.seg_end, jp.valid_sorted,
                          *map(J.jnp.asarray, res),
                          *map(J.jnp.asarray, tables), **kw, band=BAND,
                          w_chunk=WCHUNK, interpret=True, fast=True)
        args = tuple(map(_t, qkv)) + (
            tp.xyz_sorted, tp.seg_start, tp.seg_end, tp.valid_sorted
        ) + tuple(map(_t, res)) + tuple(map(_t, tables))
        fn = plain.band_attention_bwd_plain
        kw["band"] = BAND
    else:
        want = J.sparse_bwd(*map(J.jnp.asarray, qkv), jp.sparse_band,
                            *map(J.jnp.asarray, res),
                            *map(J.jnp.asarray, tables), **kw, s_band=S_BAND,
                            w_chunk=WCHUNK, interpret=True, fast=True)
        args = tuple(map(_t, qkv)) + (tp.sparse_band,) + tuple(
            map(_t, res)) + tuple(map(_t, tables))
        fn = plain.sparse_band_attention_bwd_plain
        kw["s_band"] = S_BAND
    got = fn(*args, **kw, fast=True)
    for g_, w_, name in zip(got, want, ("dq", "dk", "dv", "dtq", "dtk",
                                        "dtv")):
        assert _rel_l2(g_.numpy(), w_) <= BF16_REL_L2, name
    fp32 = fn(*args, **kw)
    assert _max_abs(got[0], fp32[0]) > ROUNDING_SEEN


def test_fused_fast_forward_and_vjp_against_jax():
    """`stratified_attention_fused` at ``fast`` against JAX's at
    ``default`` (interpret mode), forward and VJP in q, k, v and the
    tables, on the CPU through the kernels' wrappers."""
    J = jax_modules()
    jp, tp, qkv, g, tables = _case(J, 3)
    kw = dict(window_size=WS, quant_size=QUANT, scale=SCALE, band=BAND,
              tile=TILE, s_band=S_BAND)

    def jax_loss(q, k, v, a, b, c):
        out = J.fused(q, k, v, jp.xyz_sorted, jp.seg_start, jp.seg_end,
                      jp.valid_sorted, sparse_band=jp.sparse_band,
                      table_q=a, table_k=b, table_v=c, **kw,
                      w_chunk=WCHUNK, interpret=True,
                      rpe_precision="default", qk_precision="default")
        return J.jnp.sum(out * g), out

    (_, want_out), want_grads = J.jax.value_and_grad(
        jax_loss, argnums=tuple(range(6)), has_aux=True)(
            *map(J.jnp.asarray, qkv + tables))

    def port(fast):
        leaves = [_t(x).requires_grad_(True) for x in qkv + tables]
        out = stratified_attention_fused(
            *leaves[:3], tp.xyz_sorted, tp.seg_start, tp.seg_end,
            tp.valid_sorted, tp.sparse_band, *leaves[3:], **kw, fast=fast)
        (out * _t(g)).sum().backward()
        return out.detach(), [x.grad for x in leaves]

    out, grads = port(True)
    assert _rel_l2(out.numpy(), want_out) <= BF16_REL_L2
    for g_, w_, name in zip(grads, want_grads, "q k v tq tk tv".split()):
        assert _rel_l2(g_.numpy(), w_) <= BF16_REL_L2, name
    out32, grads32 = port(False)
    assert _max_abs(out, out32) > ROUNDING_SEEN
    assert _max_abs(grads[0], grads32[0]) > ROUNDING_SEEN


# ---- the stage-3 divergence (ROADMAP section 3)
# JAX runs stage 3 on its jnp path (fused_stages: 3), which on the CPU
# computes fp32 at "default" (a DEFAULT contraction is fp32 there; the bf16
# one-hot is exact); the port runs stage 3 through its kernels' fast form.
# Measured: the jnp path equals the port's fp32 form within 5.4e-7 and
# differs from its fast form by 2.3e-3 relative L2.
STAGE3_DIVERGENCE = (1e-4, BF16_REL_L2)


def test_stage3_divergence_is_bf16_rounding():
    J = jax_modules()
    jp, tp, qkv, _, tables = _case(J, 4)
    kw = dict(window_size=WS, quant_size=QUANT, scale=SCALE, band=BAND,
              tile=TILE, s_band=S_BAND)
    jnp_out = np.asarray(J.attn.stratified_attention(
        *map(J.jnp.asarray, qkv), jp.xyz_sorted, jp.seg_start, jp.seg_end,
        jp.valid_sorted, sparse_band=jp.sparse_band,
        table_q=J.jnp.asarray(tables[0]), table_k=J.jnp.asarray(tables[1]),
        table_v=J.jnp.asarray(tables[2]), rpe_precision="default",
        qk_precision="default", **kw))
    with torch.no_grad():
        ours = {fast: stratified_attention_fused(
            *map(_t, qkv), tp.xyz_sorted, tp.seg_start, tp.seg_end,
            tp.valid_sorted, tp.sparse_band, *map(_t, tables), **kw,
            fast=fast).numpy() for fast in (False, True)}
    np.testing.assert_allclose(ours[False], jnp_out, rtol=RTOL, atol=ATOL)
    lo, hi = STAGE3_DIVERGENCE
    assert lo <= _rel_l2(ours[True], jnp_out) <= hi


# ---- the backward's key masses per row slice (ROADMAP section 3)
# The CUDA backward kernels sum a key's dl per bin over their block's R rows
# and round that mass (a row slice of the 128-row tile); the TPU kernel sums
# over the whole tile. `slice_rows` gives the plain fast versions the
# kernels' form. Only dk and dtk take the key masses. The cases are the
# fast kernels' block heights (64 for the band half at S3DIS's and Swin3D's
# tables, 32 for the far-key half and ScanNet's band half, 16 beyond); the
# far-key half of this case (one 128-row tile), measured: 1.2e-4 to 2.4e-4
# (dk) and 3.5e-4 to 7.8e-4 (dtk) at 64, 32 and 16 rows, against 3.2e-3 to
# 5.7e-3 between the fast and fp32 forms.
SLICE_DIVERGENCE = (1e-5, 2e-3)
SLICE_TILE = 128


@pytest.mark.parametrize("slice_rows", [64, 32, 16])
def test_key_mass_slices_divergence(slice_rows):
    J = jax_modules()
    jp, tp, qkv, g, tables = _case(J, 5)
    res = tuple(map(_t, (g,) + _residuals(J, jp, qkv, tables)))
    args = tuple(map(_t, qkv)) + (tp.sparse_band,) + res + tuple(
        map(_t, tables))
    kw = dict(window_size=WS, quant_size=QUANT, scale=SCALE,
              tile=SLICE_TILE, s_band=S_BAND, fast=True)
    fn = plain.sparse_band_attention_bwd_plain
    tile, sliced = fn(*args, **kw), fn(*args, **kw, slice_rows=slice_rows)
    assert all(torch.equal(a, b) for a, b in zip(
        tile, fn(*args, **kw, slice_rows=SLICE_TILE)))
    lo, hi = SLICE_DIVERGENCE
    for i, name in enumerate(("dq", "dk", "dv", "dtq", "dtk", "dtv")):
        if name in ("dk", "dtk"):
            assert lo <= _rel_l2(sliced[i], tile[i]) <= hi, name
        else:
            assert torch.equal(sliced[i], tile[i]), name


# ---- the config keys


def test_bf16_staging_equals_bf16_round():
    """The fast backward wrappers' operand copies (`kernels.stage_bf16`:
    q after its fp32 scaling, k, v, g, the table slices) are bit-equal to
    ``ops/attention.py::bf16_round`` of the same fp32 values, which the
    plain fast versions take: rounded to nearest, ties to even, on values
    that sit on ties, at bf16's extremes and beyond them."""
    from stratified_transformer_torch.kernels import (
        pack_tables, pack_tables_bf16, stage_bf16, xyz_valid)
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 1 << 16, 4096, dtype=np.uint32)
    # fp32 values at bf16 ties (low half 0x8000), beside them, and exact
    ties = np.concatenate([(bits << 16) | low for low in
                           (0x8000, 0x7FFF, 0x8001, 0)]).view(np.float32)
    x = torch.from_numpy(np.concatenate([
        ties[np.isfinite(ties)],
        rng.normal(size=4096).astype(np.float32) * 10.0 ** rng.integers(
            -30, 30, 4096),
        np.float32([3.3895314e38, -3.3895314e38, 3.4028235e38, 1e-45,
                    -0.0, 0.0])]))
    for scale in (None, 0.25, 16 ** -0.5):
        got = stage_bf16(x, scale)
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        want = plain.bf16_round(x if scale is None else x * scale)
        assert torch.equal(got.float().view(torch.int32),
                           want.view(torch.int32)), scale
    tables = tuple(torch.randn(64, 3, 16, 3) for _ in range(2)) + (None,)
    for a, b in zip(pack_tables_bf16(tables, 12, 40),
                    pack_tables(tables, 12, 40)):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.float(), plain.bf16_round(b))
    xyz = torch.randn(10, 3, dtype=torch.float64)
    valid = torch.arange(10) < 7
    rec = xyz_valid(xyz, valid)
    assert rec.dtype == torch.float32 and rec.shape == (10, 4)
    assert torch.equal(rec[:, :3], xyz.float())
    assert torch.equal(rec[:, 3], valid.float())


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_yamls_select_the_fast_forms(name):
    cfg = from_cfg(load_cfg(os.path.join(CONFIGS, name)))
    assert (cfg.rpe_precision, cfg.qk_precision) == ("default", "default")
    assert cfg.fast and cfg.compute_dtype is None


@pytest.mark.parametrize("rpe, qk, fast", [
    ("highest", "highest", False), ("default", "highest", False),
    ("highest", "default", False), ("default", "default", True)])
def test_fast_needs_both_precisions_default(rpe, qk, fast):
    """``ops/attention_fused.py:229`` of the JAX package: one "highest" keeps
    the kernels fp32, as the ``highest`` override of chip_smoke.py's phases
    2-13 does."""
    cfg = from_cfg(merge_cfg_from_list(
        load_cfg(os.path.join(CONFIGS, "s3dis_stratified.yaml")),
        ["rpe_precision", rpe, "qk_precision", qk]))
    assert cfg.fast is fast


def test_compute_dtype_is_read_and_bad_values_refused():
    path = os.path.join(CONFIGS, "s3dis_stratified.yaml")
    cfg = from_cfg(merge_cfg_from_list(load_cfg(path),
                                       ["compute_dtype", "bfloat16"]))
    assert cfg.compute_dtype == "bfloat16"
    for key, value in (("compute_dtype", "float16"),
                       ("rpe_precision", "high"), ("qk_precision", "bf16")):
        with pytest.raises(ValueError, match=key):
            dataclasses.replace(load_config(path), **{key: value})


@pytest.mark.parametrize("name", SHIPPED)
def test_eval_drivers_build_the_fast_model(name):
    """The eval driver (``test.py``) and the box-mAP / layout drivers
    (``test_iou.py``, ``test_layoutrm.py``) build their model through
    ``from_cfg``: the shipped YAMLs run the fast forms there, and the
    ``highest`` override runs fp32."""
    from stratified_transformer_torch.eval import driver, iou_driver
    yaml_cfg = load_cfg(os.path.join(CONFIGS, name))
    assert driver.eval_config(yaml_cfg).fast
    assert iou_driver.offset_config(yaml_cfg).fast
    pinned = merge_cfg_from_list(yaml_cfg, ["rpe_precision", "highest",
                                            "qk_precision", "highest"])
    assert not driver.eval_config(pinned).fast


def test_train_driver_runs_the_fast_model(tmp_path):
    """One narrow epoch of the train driver on the shipped S3DIS YAML: every
    attention block takes the fast forms, and the losses are finite."""
    from stratified_transformer_torch.train import driver
    opts = ["channels", "[16,32,64,128]", "num_heads", "[1,2,4,8]",
            "depths", "[1,1,2,1]", "max_batch_points", "2048",
            "batch_size", "2", "voxel_max", "900", "data_name", "synthetic",
            "synthetic_scenes", "2", "synthetic_points", "1500", "epochs",
            "1", "evaluate", "False", "use_tensorboard", "False",
            "save_path", str(tmp_path)]
    model, summary = driver.run(merge_cfg_from_list(
        load_cfg(os.path.join(CONFIGS, "s3dis_stratified.yaml")), opts),
        "cpu", log=lambda _: None)
    attn = [m for m in model.modules()
            if type(m).__name__ == "WindowAttention"]
    assert len(attn) == 5 and all(a.fast for a in attn)
    assert summary["steps"] == 1
    assert all(np.isfinite(it["loss"]) for it in summary["iters"])


# ---- the narrow model against JAX's

NARROW = dict(num_classes=13, in_channels=6, channels=(16, 32, 64, 128),
              num_heads=(1, 2, 4, 8), depths=(1, 1, 2, 1), num_layers=4,
              n_pad=2048, num_scenes=2, tile=128, band=128,
              band_per_stage=(128, 128, 384, 192), sparse_cap=48, s_band=128,
              drop_path_rate=0.0)
# Logits after five attention blocks, a U-Net and two BatchNorms, the JAX
# model on its Pallas path in interpret mode (stage 3 on its jnp path):
# JAX rounds the band forward only, the port every product of the four
# kernels (and, with compute_dtype, both round the blocks' dense layers to
# bf16 on their own). Relative L2 over the valid rows; measured 6.3e-4
# (fast) and 3.7e-3 (bf16 compute), against 1.2e-3 and 6.6e-3 between each
# package's bf16 and fp32 runs.
MODEL_REL_L2 = {None: 2e-3, "bfloat16": 1e-2}
# the train step's loss, a mean over ~1900 points' cross-entropies
LOSS_RTOL = 1e-3


def _model_pair(compute_dtype):
    """The JAX model at ``default`` (``compute_dtype`` as given) and the
    port's with the same converted random weights, on one host batch."""
    J = jax_modules()
    from stratified_transformer_tpu.models.stratified import (
        Stratified as JaxStratified, StratifiedConfig as JaxConfig)
    from stratified_transformer_torch.convert import from_flax
    from stratified_transformer_torch.data import loader
    from stratified_transformer_torch.models.stratified import Stratified
    from test_torch_model import _random_variables
    cfg = StratifiedConfig(**NARROW, rpe_precision="default",
                           qk_precision="default",
                           compute_dtype=compute_dtype)
    assert cfg.fast
    hb = loader.host_batch(cfg, seed=0)
    jcfg = JaxConfig(**NARROW, sampler="grid", attn_impl="fused",
                     pallas_interpret=True, rpe_precision="default",
                     qk_precision="default", compute_dtype=compute_dtype)
    jmodel = JaxStratified(jcfg)
    shapes = J.jax.eval_shape(lambda: jmodel.init(
        {"params": J.jax.random.PRNGKey(0)}, hb["feats"], hb["xyz"],
        hb["offsets"], training=False, stem_nidx=hb["stem_nidx"],
        stem_nmask=hb["stem_nmask"], pyramid=hb["pyramid"]))
    rng = np.random.default_rng(5)
    params = _random_variables(shapes["params"], rng)
    stats = _random_variables(shapes["batch_stats"], rng)
    model = Stratified(cfg)
    model.load_state_dict(from_flax(params, stats), strict=True)
    return J, jmodel, params, stats, model, hb, loader.to_device(hb, "cpu")


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_narrow_model_fast_against_jax(compute_dtype):
    """Eval logits and one train step's loss (drop-path off) of the narrow
    S3DIS-style model at ``default``, and with ``compute_dtype: bfloat16``,
    against the JAX model's on the same weights and host batch."""
    J, jmodel, params, stats, model, hb, batch = _model_pair(compute_dtype)
    from stratified_transformer_tpu.train.step import (
        make_eval_step as jax_make_eval_step,
        make_train_step as jax_make_train_step)
    from stratified_transformer_tpu.train.state import (
        TrainState, make_optimizer as jax_make_optimizer)
    from stratified_transformer_torch.train.state import make_optimizer
    from stratified_transformer_torch.train.step import (
        make_eval_step, make_train_step)

    eval_step = jax_make_eval_step(255, 13)
    j_logits, _, _ = J.jax.jit(lambda p, s, b: eval_step(types.SimpleNamespace(
        params=p, batch_stats=s, apply_fn=jmodel.apply), b))(params, stats, hb)
    model.eval()
    t_logits, _, _ = make_eval_step(255, 13)(model, batch)
    n = int(hb["offsets"][-1])
    assert t_logits.dtype == torch.float32
    assert _rel_l2(t_logits.numpy()[:n], np.asarray(j_logits)[:n]) <= \
        MODEL_REL_L2[compute_dtype]

    tx = jax_make_optimizer(params, lambda step: 0.006, 0.01, 0.1)
    jstate = TrainState(step=J.jnp.zeros((), J.jnp.int32), params=params,
                        batch_stats=stats, opt_state=tx.init(params), tx=tx,
                        apply_fn=jmodel.apply)
    _, j_stats = J.jax.jit(jax_make_train_step(255, 13))(
        jstate, hb, J.jax.random.PRNGKey(0))
    model.train()
    t_stats = make_train_step(255, 13)(
        model, make_optimizer(model, lambda epoch: 0.006), batch, None)
    np.testing.assert_allclose(float(t_stats["loss"]),
                               float(j_stats["loss"]), rtol=LOSS_RTOL)
    # the step reached every attention table through the fast backward
    assert float(model.layer_2.blocks_1.attn.rel_key_table.grad.abs().max()
                 ) > 1e-6


def test_model_blocks_take_the_config():
    """``fast`` and ``compute_dtype`` reach every block; the dense layers
    keep fp32 parameters and compute in bf16."""
    from stratified_transformer_torch.models.stratified import Stratified
    cfg = StratifiedConfig(**NARROW, rpe_precision="default",
                           qk_precision="default", compute_dtype="bfloat16")
    model = Stratified(cfg)
    blocks = [m for m in model.modules()
              if type(m).__name__ == "WindowAttention"]
    assert len(blocks) == sum(cfg.depths)
    assert all(b.fast and b.dtype == torch.bfloat16 for b in blocks)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    mlp = model.layer_0.blocks_0.mlp
    y = mlp(torch.randn(5, cfg.channels[0]))
    assert y.dtype == torch.bfloat16


# ---- the fast kernels on the card

# chip_smoke.py's phase 14 gates: the plain fast versions round the same
# operands at the same running maxima as the kernels and (given
# ``slice_rows``) sum the key masses over the same rows, so only fp32 sums
# in another order differ, flipping a bf16 rounding here and there:
# relative L2 over the tensor, not per entry. The fp32 forms, held against
# the same plain fast versions, must land beyond the gates (controls). m and
# den sum fp32 values of the same rounded products: the fp32 tolerance.
FAST_OUT_REL_L2, FAST_GRAD_REL_L2 = 2e-4, 5e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _cuda_case(dev, seed, n_pad=2688, n_valid=2500, h=12, ws=0.64,
               quant=0.04):
    """Stage 2 of the S3DIS configuration by default (band 384, 12 heads,
    64 bins per axis, a band slice of 40); ws 0.4 / quant 0.02 gives
    ScanNet's 80-bin tables (a band slice of 48)."""
    gen = torch.Generator().manual_seed(seed)
    xyz = torch.rand(n_pad, 3, generator=gen) * 2.0
    batch = torch.cat([torch.zeros(n_valid // 2, dtype=torch.int32),
                       torch.ones(n_valid - n_valid // 2, dtype=torch.int32),
                       torch.full((n_pad - n_valid,), 2, dtype=torch.int32)])
    valid = torch.arange(n_pad) < n_valid
    is_down = (torch.rand(n_pad, generator=gen) < 0.3) & valid
    plan = torch_plan.build_attention_plan(
        xyz.to(dev), batch.to(dev), valid.to(dev), ws, shifted=True,
        is_down=is_down.to(dev), sparse_cap=16)
    nbins = 2 * int((2 * ws + 1e-4) // quant)
    q, k, v, g = (torch.randn(n_pad, h, 16, generator=gen).to(dev)
                  for _ in range(4))
    tables = tuple((torch.randn(nbins, h, 16, 3, generator=gen) * 0.05
                    ).to(dev) for _ in range(3))
    kw = dict(window_size=ws, quant_size=quant, scale=16 ** -0.5)
    return plan, (q, k, v), g, tables, kw


def _assert_fast_triple(got, want, fp32):
    assert _rel_l2(got[0].cpu(), want[0].cpu()) <= FAST_OUT_REL_L2
    assert _rel_l2(fp32[0].cpu(), want[0].cpu()) > FAST_OUT_REL_L2
    for g_, w_ in zip(got[1:], want[1:]):
        torch.testing.assert_close(g_, w_, rtol=RTOL, atol=ATOL)


def _launches():
    return {m.__name__.rsplit(".", 1)[1]: (m.KERNEL.launches,
                                           m.KERNEL_FAST.launches)
            for m in (band_k, sparse_k, band_bwd_k, sparse_bwd_k)}


# the fast forward kernels' cases: S3DIS's tables at stage 2's shape,
# ScanNet's, and ScanNet's with a tile of padding rows (no row has a key)
FAST_FWD_CASES = {
    "s3dis": {},
    "scannet": dict(ws=0.4, quant=0.02, n_pad=512, n_valid=450, h=3),
    "empty_rows": dict(ws=0.4, quant=0.02, n_pad=640, n_valid=450, h=3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("tables_of", list(FAST_FWD_CASES))
def test_fast_fwd_kernels_match_plain_fast(cuda_device, tables_of):
    """Both fast forward kernels (on the tensor cores) against the plain
    fast versions at the block height their limits pick (64 rows for every
    table size), with the fp32 forms as controls; rows with no key come
    out as m = -1e30, den = 0, acc = 0 exactly."""
    plan, qkv, _, tables, kw = _cuda_case(cuda_device, 11,
                                          **FAST_FWD_CASES[tables_of])
    for name in ("band_attention", "sparse_band_attention"):
        assert block_limits(name, cuda_device, fast=True)[0] == 64, name
    band = 384 if tables_of == "s3dis" else 128
    geom = (plan.xyz_sorted, plan.seg_start, plan.seg_end, plan.valid_sorted)
    before = _launches()
    with torch.no_grad():
        got = [band_k.band_attention(*qkv, *geom, *tables, **kw, band=band,
                                     tile=128, fast=True),
               sparse_k.sparse_band_attention(*qkv, plan.sparse_band,
                                              *tables, **kw, s_band=128,
                                              tile=128, fast=True)]
        want = [plain.band_attention_plain(*qkv, *geom, *tables, **kw,
                                           band=band, tile=128, fast=True),
                plain.sparse_band_attention_plain(*qkv, plan.sparse_band,
                                                  *tables, **kw, s_band=128,
                                                  tile=128, fast=True)]
        torch.cuda.synchronize()
        after = _launches()
        fp32 = [band_k.band_attention(*qkv, *geom, *tables, **kw, band=band,
                                      tile=128),
                sparse_k.sparse_band_attention(*qkv, plan.sparse_band,
                                               *tables, **kw, s_band=128,
                                               tile=128)]
    for name in ("band_attention", "sparse_band_attention"):
        assert after[name] == (before[name][0], before[name][1] + 1), name
    for g_, w_, f_ in zip(got, want, fp32):
        _assert_fast_triple(g_, w_, f_)
        assert float(w_[2].max()) > 0
        empty = w_[1] == plain.NEG_INF
        assert bool(empty.any())
        assert bool((g_[1][empty] == plain.NEG_INF).all())
        assert bool((g_[2][empty] == 0).all())
        assert bool((g_[0][empty] == 0).all())
    if tables_of == "empty_rows":
        assert not bool(plan.valid_sorted[512:].any())


# The fast backward kernels' block heights by table size (the tables' rows
# per axis: S3DIS's band slice of 40 and far-key 64, ScanNet's 48 and 80),
# and cases that reach the 32-row band and the 16-row blocks: (ws, quant) of each case, the
# heights its band and far-key halves take, or None for a half whose table
# no block of the fast form takes (of 200 rows per axis, the band slice
# has 104; the far keys' 200 are beyond any block).
FAST_BWD_CASES = {
    "s3dis": (0.64, 0.04, 64, 32),
    "scannet": (0.4, 0.02, 64, 32),
    "band16": (0.4, 0.008, 16, None),
    "sparse16": (0.4, 0.016, 32, 16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("tables_of", list(FAST_BWD_CASES))
def test_fast_bwd_kernels_match_plain_fast(cuda_device, tables_of):
    """Both fast backward kernels (on the tensor cores) against the plain
    fast versions in the kernels' row slices, at S3DIS's and ScanNet's
    table sizes and at every block height the fast limits pick: phase 14's
    gates, each with its fp32 control."""
    ws, quant, band_rows, sparse_rows = FAST_BWD_CASES[tables_of]
    small = dict(n_pad=512, n_valid=450, h=3)
    plan, qkv, g, tables, kw = _cuda_case(
        cuda_device, 12, ws=ws, quant=quant,
        **({} if tables_of == "s3dis" else small))
    band = 384 if tables_of == "s3dis" else 128
    geom = (plan.xyz_sorted, plan.seg_start, plan.seg_end, plan.valid_sorted)
    nbf = tables[0].shape[0]
    # the key masses are summed over the kernels' row slices
    rows = {name: block_limits(name, cuda_device, nb, fast=True)[0]
            for name, nb in (("band_attention_bwd",
                              plain.band_table_slice(nbf)[1]),
                             ("sparse_band_attention_bwd", nbf))}
    assert rows == {"band_attention_bwd": band_rows,
                    "sparse_band_attention_bwd": sparse_rows or 0}
    with torch.no_grad():
        res = (g,) + plain.merge([
            plain.band_attention_plain(*qkv, *geom, *tables, **kw, band=band,
                                       tile=128, fast=True),
            plain.sparse_band_attention_plain(*qkv, plan.sparse_band,
                                              *tables, **kw, s_band=128,
                                              tile=128, fast=True)])
        runs = {"band_attention_bwd": (
            lambda f: band_bwd_k.band_attention_bwd(
                *qkv, *geom, *res, *tables, **kw, band=band, tile=128,
                fast=f),
            lambda r: plain.band_attention_bwd_plain(
                *qkv, *geom, *res, *tables, **kw, band=band, tile=128,
                fast=True, slice_rows=r))}
        if sparse_rows:
            runs["sparse_band_attention_bwd"] = (
                lambda f: sparse_bwd_k.sparse_band_attention_bwd(
                    *qkv, plan.sparse_band, *res, *tables, **kw, s_band=128,
                    tile=128, fast=f),
                lambda r: plain.sparse_band_attention_bwd_plain(
                    *qkv, plan.sparse_band, *res, *tables, **kw, s_band=128,
                    tile=128, fast=True, slice_rows=r))
        else:
            with pytest.raises(ValueError, match="table rows"):
                sparse_bwd_k.sparse_band_attention_bwd(
                    *qkv, plan.sparse_band, *res, *tables, **kw, s_band=128,
                    tile=128, fast=True)
        for name, (kernel, plain_fast) in runs.items():
            before = _launches()
            got = kernel(True)
            torch.cuda.synchronize()
            after = _launches()
            assert after[name] == (before[name][0], before[name][1] + 1), name
            want = plain_fast(rows[name])
            fp32 = kernel(False)
            for gn, a, b, c in zip(("dq", "dk", "dv", "dtq", "dtk", "dtv"),
                                   got, want, fp32):
                assert _rel_l2(a.cpu(), b.cpu()) <= FAST_GRAD_REL_L2, \
                    (name, gn)
                assert _rel_l2(c.cpu(), b.cpu()) > FAST_GRAD_REL_L2, \
                    (name, gn)
            assert float(want[1].abs().max()) > 1e-2


@pytest.mark.cuda
def test_fast_limits_take_the_shipped_tables(cuda_device):
    """The fast forms' own limits: S3DIS's and ScanNet's tables fit every
    one of them; the forward takes 64-row blocks at every table size; the
    backward picks its block height from its own shared memory: the band
    half 64 rows for S3DIS's slice of 40, Swin3D's 31 and ScanNet's 48 (the
    fp32 form: 32); the far-key half 32 rows for S3DIS's 64 and ScanNet's
    80 (the fp32 form: 16)."""
    for name, nb in (("band_attention", 48), ("sparse_band_attention", 80)):
        rows, max_nb = block_limits(name, cuda_device, fast=True)
        assert (rows, max_nb >= nb) == (64, True), name
    for name, nb, want in (("band_attention_bwd", 40, 64),
                           ("band_attention_bwd", 31, 64),
                           ("band_attention_bwd", 48, 64),
                           ("sparse_band_attention_bwd", 64, 32),
                           ("sparse_band_attention_bwd", 80, 32)):
        rows, max_nb = block_limits(name, cuda_device, nb, fast=True)
        assert (rows, max_nb >= nb) == (want, True), (name, nb)
        assert rows >= block_limits(name, cuda_device, nb)[0]
