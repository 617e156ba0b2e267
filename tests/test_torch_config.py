"""PyTorch port, configuration: the YAML reader against the JAX driver's
``build_model_config`` on one device (the ScanNet YAML's in
``test_torch_scannet.py``), the Swin3D family's ``arch``,
``use_stratified`` and ``rpe_mode`` and its ``attn_impl`` rule; the DCF
family's offset-head keys."""

import dataclasses
import logging
import os

import pytest

from stratified_transformer_torch.config import from_cfg, load_config
from stratified_transformer_torch.utils.config import load_cfg as torch_load
from stratified_transformer_tpu.utils.config import load_cfg as jax_load
from train import build_model_config

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def test_s3dis_config_matches_jax_driver():
    path = os.path.join(CONFIGS, "s3dis_stratified.yaml")
    ours = load_config(path)
    theirs = build_model_config(jax_load(path), 1)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.channels == (48, 96, 192, 384)
    assert ours.num_heads == (3, 6, 12, 24)
    assert ours.depths == (2, 2, 6, 2)
    for name in ("window_sizes", "grid_sizes", "quant_sizes"):
        assert getattr(ours, name)() == getattr(theirs, name)(), name
    assert [ours.stage_band(i) for i in range(4)] == [128, 128, 384, 192]


# the Swin3D family: the shipped YAMLs, and the keys set on the S3DIS
# stratified YAML (explicit keys win over ``arch``, train.py:49-83)
SWIN_CASES = {
    "s3dis_swin3d.yaml": ("s3dis_swin3d.yaml", {}),
    "scannetv2_swin3d.yaml": ("scannetv2_swin3d.yaml", {}),
    "plain windows, stratified bins": (
        "s3dis_stratified.yaml", {"use_stratified": False}),
    "arch with explicit stratified bins": (
        "s3dis_swin3d.yaml", {"rpe_mode": "stratified"}),
}


@pytest.mark.parametrize("case", sorted(SWIN_CASES))
def test_swin_family_is_read_as_the_jax_driver_reads_it(case):
    """Every field equals ``build_model_config``'s but ``attn_impl``: under
    ``rpe_mode: swin_window`` the port builds its main path ("fused"),
    where the JAX package's key selects nothing (its one implementation of
    the mode, ``models/attention.py:100-109``)."""
    name, keys = SWIN_CASES[case]
    cfg = torch_load(os.path.join(CONFIGS, name))
    cfg.update(keys)
    ours, theirs = from_cfg(cfg), build_model_config(cfg, 1)
    for f in dataclasses.fields(ours):
        if f.name != "attn_impl":
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.use_stratified is False
    swin = ours.rpe_mode == "swin_window"
    assert ours.attn_impl == ("fused" if swin else theirs.attn_impl)
    if name.endswith("_swin3d.yaml") and not keys:
        assert swin and theirs.attn_impl == "reference"
        # window / quant is 16 at every stage: 31 table rows
        assert {int(w / q) for w, q in zip(ours.window_sizes(),
                                           ours.quant_sizes())} == {16}


def test_swin_bins_with_stratified_keys_are_refused():
    """``use_stratified: True`` with ``rpe_mode: swin_window``: the JAX
    package asserts the mode is window-dense (``ops/attention.py:
    461-465``)."""
    cfg = torch_load(os.path.join(CONFIGS, "s3dis_swin3d.yaml"))
    cfg["use_stratified"] = True
    with pytest.raises(ValueError, match="window-dense"):
        from_cfg(cfg)
    with pytest.raises(ValueError, match="rpe_mode"):
        dataclasses.replace(load_config(
            os.path.join(CONFIGS, "s3dis_stratified.yaml")),
            rpe_mode="swin")


def test_attn_impl_rule_under_the_swin_bins(caplog):
    """The shipped Swin YAMLs say ``attn_impl: reference``: ``from_cfg``
    builds the main path and logs one line saying so; a config built with
    "reference" keeps the plain versions, and the stratified YAMLs keep
    what they say."""
    cfg = torch_load(os.path.join(CONFIGS, "s3dis_swin3d.yaml"))
    assert cfg["attn_impl"] == "reference"
    # the drivers' logger does not propagate (utils/logger.py): listen on it
    # directly, and on it alone
    logger = logging.getLogger("st_torch")
    propagate = logger.propagate
    logger.addHandler(caplog.handler)
    logger.propagate = False
    try:
        with caplog.at_level("INFO", logger="st_torch"):
            assert from_cfg(cfg).attn_impl == "fused"
    finally:
        logger.removeHandler(caplog.handler)
        logger.propagate = propagate
    assert len(caplog.records) == 1
    assert "swin_window" in caplog.records[0].getMessage()
    ref = dataclasses.replace(from_cfg(cfg), attn_impl="reference")
    assert ref.attn_impl == "reference"
    strat = torch_load(os.path.join(CONFIGS, "s3dis_stratified.yaml"))
    strat["attn_impl"] = "reference"
    assert from_cfg(strat).attn_impl == "reference"


def test_dcf_family_is_accepted():
    """The DCF YAML reads into the S3DIS backbone with the offset head (its
    equality with the JAX driver's config: ``test_torch_dcf.py``)."""
    cfg = from_cfg(torch_load(os.path.join(CONFIGS, "dcf_stratified.yaml")))
    assert cfg.with_regressor and cfg.activation == "Relu"
    assert cfg.num_classes == 18


def test_unknown_attention_impl_is_refused():
    with pytest.raises(ValueError, match="attn_impl"):
        dataclasses.replace(load_config(
            os.path.join(CONFIGS, "s3dis_stratified.yaml")), attn_impl="jnp")


def test_on_device_sampling_keys_are_read_as_the_jax_driver_reads_them():
    cfg = torch_load(os.path.join(CONFIGS, "s3dis_stratified.yaml"))
    cfg.update(sampler="blocked_fps", down_quota="cells", knn_chunk=256,
               neighbor_method="brute", neighbor_cap=16, grid_knn_chunk=512)
    ours, theirs = from_cfg(cfg), build_model_config(cfg, 1)
    for name in ("sampler", "down_quota", "knn_chunk", "neighbor_method",
                 "neighbor_cap", "grid_knn_chunk"):
        assert getattr(ours, name) == getattr(theirs, name), name
    for name, bad in (("sampler", "poisson"), ("down_quota", "batch"),
                      ("neighbor_method", "kdtree")):
        with pytest.raises(ValueError, match=name):
            dataclasses.replace(ours, **{name: bad})


@pytest.mark.parametrize("value", ["Relu", "Tanh"])
def test_activation_is_read_as_the_jax_driver_reads_it(value):
    cfg = torch_load(os.path.join(CONFIGS, "dcf_stratified.yaml"))
    cfg["activation"] = value
    assert from_cfg(cfg).activation == build_model_config(cfg, 1).activation
    assert from_cfg(cfg).activation == value


def test_unknown_activation_in_the_yaml_is_refused():
    cfg = torch_load(os.path.join(CONFIGS, "dcf_stratified.yaml"))
    cfg["activation"] = "LeakyRelu"
    with pytest.raises(ValueError, match="activation 'LeakyRelu'"):
        from_cfg(cfg)
