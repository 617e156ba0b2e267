"""PyTorch port, configuration: the YAML reader against the JAX driver's
``build_model_config`` on one device (the ScanNet YAML's in
``test_torch_scannet.py``), and the model families the port does not run
yet refused by name; the DCF family's offset-head keys."""

import dataclasses
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


@pytest.mark.parametrize("name, refused", [
    ("s3dis_swin3d.yaml", "arch: swin3d_transformer"),
])
def test_unported_families_are_refused(name, refused):
    with pytest.raises(ValueError, match=refused):
        from_cfg(torch_load(os.path.join(CONFIGS, name)))


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


# the ROADMAP queue 1 item that ports each refused family: Swin3D is item 5
ROADMAP_ITEM = {"use_stratified": 5, "arch": 5}


@pytest.mark.parametrize("key, value", [
    ("use_stratified", False), ("arch", "swin3d_transformer")])
def test_refusals_name_their_roadmap_item(key, value):
    cfg = torch_load(os.path.join(CONFIGS, "s3dis_stratified.yaml"))
    cfg[key] = value
    with pytest.raises(ValueError, match=(
            f"{key}: {value} \\(ROADMAP queue 1 item {ROADMAP_ITEM[key]}\\)")):
        from_cfg(cfg)


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
