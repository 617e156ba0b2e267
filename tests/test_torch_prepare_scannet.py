"""The port's ScanNet preparation tool (``stratified_transformer_torch/
tools/prepare_scannet.py``) against the repository's JAX-side tool
(``tools/prepare_scannet.py``), on fabricated scans in ScanNet's raw layout
(`chip_smoke.write_scannet_scans`, phase 18 (a)'s fabricator at a few
hundred vertices).

The JAX-side tool is loaded by path and driven through ``process_scene``
and ``write_gt_txt``: its ``main`` forks a pool, which is unsafe in a
process that has started JAX's threads. The ``.pth`` tuples must be equal
array by array, dtypes included, and the GT txt files byte-identical.
"""

import importlib.util
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from stratified_transformer_torch.data.datasets import (
    Scannetv2, scannet_scenes)
from stratified_transformer_torch.data.ply import read_ply
from stratified_transformer_torch.tools import prepare_scannet

ROOT = pathlib.Path(__file__).resolve().parents[1]
POINTS = 600


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_prepare_scannet", ROOT / "tools" / "prepare_scannet.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """Two labelled scans in ``val`` and one in ``test``."""
    root = tmp_path_factory.mktemp("scans")
    val = chip_smoke.write_scannet_scans(str(root), "val", 2, seed=3,
                                         points=POINTS, extent=2.0)
    test = chip_smoke.write_scannet_scans(str(root), "test", 1, seed=9,
                                          points=POINTS, extent=2.0,
                                          labels=False)
    return root, val, test


def copy_of(root, tmp_path, name):
    dst = tmp_path / name
    shutil.copytree(root, dst)
    return dst


def test_fabricated_scans_are_scannet_layout(scans):
    root, val, test = scans
    name, xyz, rgb, nyu, inst = val[0]
    base = os.path.join(root, "val", name)
    mesh = read_ply(base + "_vh_clean_2.ply")
    assert mesh["vertex"].dtype.names == ("x", "y", "z", "red", "green",
                                          "blue", "alpha")
    assert len(mesh["face"]) == chip_smoke.PREP_FACES_PER_VERTEX * len(xyz)
    assert all(len(f) == 3 for f in mesh["face"][:10])
    labels = read_ply(base + "_vh_clean_2.labels.ply")["vertex"]
    assert labels["label"].dtype == np.uint16
    np.testing.assert_array_equal(labels["label"], nyu)
    for ids in (chip_smoke.SCANNET_NYU40, chip_smoke.UNMAPPED_NYU40):
        assert set(ids) <= set(np.unique(nyu).tolist())
    assert (inst == -100).any() and (inst >= 0).any()
    assert sorted(os.listdir(os.path.join(root, "test"))) == [
        test[0][0] + "_vh_clean_2.ply"]


@pytest.mark.parametrize("split", ["val", "test"])
def test_pth_files_match_the_jax_tool(scans, jax_tool, tmp_path, split):
    root, _, _ = scans
    ours, theirs = copy_of(root, tmp_path, "port"), copy_of(
        root, tmp_path, "jax")
    labelled = split != "test"
    for d, tool in ((ours, prepare_scannet), (theirs, jax_tool)):
        for f in sorted((d / split).glob("*_vh_clean_2.ply")):
            tool.process_scene(str(f), labelled)
    pths = sorted(p.name for p in (ours / split).glob("*.pth"))
    assert pths and pths == sorted(
        p.name for p in (theirs / split).glob("*.pth"))
    for name in pths:
        got = torch.load(ours / split / name, weights_only=False)
        want = torch.load(theirs / split / name, weights_only=False)
        assert len(got) == len(want) == (4 if labelled else 2)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)

    if labelled:
        for d, tool in ((ours, prepare_scannet), (theirs, jax_tool)):
            for p in sorted((d / split).glob("*.pth")):
                tool.write_gt_txt(str(p), str(d / "gt"))
        txt = sorted(p.name for p in (ours / "gt").iterdir())
        assert len(txt) == 2 and txt == sorted(
            p.name for p in (theirs / "gt").iterdir())
        for name in txt:
            assert ((ours / "gt" / name).read_bytes()
                    == (theirs / "gt" / name).read_bytes())


def test_main_prepares_what_the_readers_load(scans, tmp_path, capsys):
    root, val, _ = scans
    d = copy_of(root, tmp_path, "main")
    done = prepare_scannet.main(["--data_split", "val", "--dir", str(d),
                                 "--workers", "1", "--gt_txt_out",
                                 str(d / "gt")])
    assert [os.path.basename(f) for f, _ in done] == [
        s[0] + "_vh_clean_2.ply" for s in val]
    assert all(s > 0 for _, s in done)
    assert "2 scenes in val" in capsys.readouterr().out
    scenes = scannet_scenes(str(d))
    assert [s[0] for s in scenes] == [s[0] + "_inst_nostuff" for s in val]
    for (name, xyz, rgb, nyu, inst), (_, coord, color, label) in zip(
            val, scenes):
        gt, sem = chip_smoke.scannet_gt(nyu, inst)
        np.testing.assert_array_equal(label, sem)
        np.testing.assert_allclose(
            coord, xyz - xyz.astype(np.float64).mean(0), rtol=0, atol=1e-9)
        np.testing.assert_array_equal(color, rgb / 127.5 - 1)
        np.testing.assert_array_equal(
            np.loadtxt(d / "gt" / (name + ".txt"), dtype=np.int64), gt)
        assert (gt > 1000).any() and (gt == 0).any()
    ds = Scannetv2(split="val", data_root=str(d), voxel_size=0.02,
                   voxel_max=400)
    item = ds[1]
    assert len(ds) == 2 and len(item["xyz"]) <= 400
    assert set(np.unique(item["labels"])) <= set(np.unique(scenes[1][3]))


def test_main_in_a_spawned_pool_writes_what_the_loop_does(scans, tmp_path):
    """``--workers 2`` runs the scans in spawned processes."""
    root, _, _ = scans
    serial, pooled = copy_of(root, tmp_path, "serial"), copy_of(
        root, tmp_path, "pool")
    for d, workers in ((serial, "1"), (pooled, "2")):
        prepare_scannet.main(["--data_split", "val", "--dir", str(d),
                              "--workers", workers])
    names = sorted(p.name for p in (serial / "val").glob("*.pth"))
    assert len(names) == 2
    for name in names:
        for g, w in zip(torch.load(pooled / "val" / name, weights_only=False),
                        torch.load(serial / "val" / name,
                                   weights_only=False)):
            assert np.array_equal(g, w)
