"""PyTorch port, the two probes (``stratified_transformer_torch/tools``) and
the build-cache key of ``kernels/build.py``, on the CPU.

The bin formula's plain version is the literal fp32 sequence of the JAX
package's probe formula (``tools/bin_math_probe.py:50-52``), as the CUDA
kernel computes it. The JAX formula itself, run on the CPU jitted and
through the same ``pallas_call`` in interpret mode, is XLA's rewrite of it
(reciprocal products, folded constants, a fused multiply-add); the tests
pin that rewrite down exactly and bound its difference from the literal
sequence. The cache key is computed in fresh processes with a stub
``nvcc --version`` string (no nvcc here)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke
from stratified_transformer_torch.kernels import build
from stratified_transformer_torch.tools import bin_math_probe, cache_key_probe

ROOT = pathlib.Path(__file__).resolve().parents[1]
WS, QS = bin_math_probe.WS, bin_math_probe.QS


def _jax_formula(x):
    # tools/bin_math_probe.py:50-52, as written there
    r = jnp.round(x * 1e5) / 1e5
    return jnp.floor((r + 2.0 * WS - 1e-4) / QS).astype(jnp.int32)


def _jax_pallas(x):
    # the probe's pallas_call (tools/bin_math_probe.py:54-61), interpreted
    def kernel(x_ref, o_ref):
        o_ref[:] = _jax_formula(x_ref[:])
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
        interpret=True)(x)


def test_sweep_is_the_jax_probes():
    rel = bin_math_probe.sweep()
    assert rel.shape == (256, 256) and rel.dtype == np.float32
    bounds = (np.arange(64) * QS - 2 * WS + 1e-4).astype(np.float32)
    flat = rel.reshape(-1)
    np.testing.assert_array_equal(flat[-256:-192], bounds)
    np.testing.assert_array_equal(flat[-192:-128],
                                  np.nextafter(bounds, -np.inf))
    np.testing.assert_array_equal(flat[-64:], bounds + 1e-5)
    lattice = np.round(np.random.default_rng(0).uniform(
        -2 * WS, 2 * WS, (1 << 16) - 256) * 1e5) / 1e5
    np.testing.assert_array_equal(flat[:-256], lattice.astype(np.float32))


def _literal_f32(rel):
    """The formula as its literal fp32 sequence, each step rounded once."""
    f32 = np.float32
    r = np.round(rel * f32(1e5)) / f32(1e5)
    return np.floor(((r + f32(2 * WS)) - f32(1e-4)) / f32(QS)).astype(
        np.int32)


def _xla_cpu_rewrite(rel):
    """What XLA on the CPU computes for the probe's formula: the divisions by
    constants become products with their fp32 reciprocals, the two
    constants fold into one, and the first product and the sum contract
    into a fused multiply-add (one rounding), emulated in fp64."""
    f32, f64 = np.float32, np.float64
    r = np.round(rel * f32(1e5)).astype(f64)
    c = f64(f32(f32(2 * WS) - f32(1e-4)))
    t = (r * f64(f32(1) / f32(1e5)) + c).astype(f32)
    return np.floor(t * (f32(1) / f32(QS))).astype(np.int32)


def test_bin_formula_plain_is_the_literal_sequence():
    rel = bin_math_probe.sweep()
    got = bin_math_probe.bin_formula_plain(torch.from_numpy(rel), WS, QS)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _literal_f32(rel))
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        bin_math_probe.bin_formula(torch.from_numpy(rel), WS, QS).numpy(),
        _literal_f32(rel))


@pytest.mark.parametrize("path", ["jit", "pallas_interpret"])
def test_jax_probe_formula_on_cpu(path):
    """The JAX probe's formula on the CPU is XLA's rewrite of it, not the
    literal sequence that the port's kernel and plain version compute: the
    two differ by one bin on a few values at bin bounds."""
    rel = bin_math_probe.sweep()
    fn = jax.jit(_jax_formula) if path == "jit" else _jax_pallas
    want = np.asarray(fn(jnp.asarray(rel)))
    np.testing.assert_array_equal(want, _xla_cpu_rewrite(rel))
    got = bin_math_probe.bin_formula_plain(torch.from_numpy(rel), WS,
                                           QS).numpy()
    # the port differs from JAX exactly where the literal sequence differs
    # from XLA's rewrite (87 values of the sweep), and by one bin there
    expected = _literal_f32(rel) != _xla_cpu_rewrite(rel)
    np.testing.assert_array_equal(np.argwhere(got != want),
                                  np.argwhere(expected))
    assert int(expected.sum()) == 87
    assert int(np.abs(got.astype(np.int64) - want).max()) <= 1


def test_bin_math_probe_counts_on_cpu():
    rel = bin_math_probe.sweep()
    r = bin_math_probe.probe(torch.device("cpu"))
    literal_vs_gt = int((_literal_f32(rel)
                         != bin_math_probe.ground_truth(rel)).sum())
    assert r["values"] == 65536
    assert r["kernel_vs_cpu"] == r["kernel_vs_device_ops"] == 0
    assert r["examples"] == []
    assert r["cpu_vs_fp64"] == r["kernel_vs_fp64"] == literal_vs_gt
    assert r["device_ops_vs_fp64"] == literal_vs_gt
    # fp32 and fp64 bins differ only near bin bounds
    assert literal_vs_gt < 4 * 64


def test_bin_math_probe_cli_on_cpu(capsys):
    assert bin_math_probe.main(["--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["kernel_vs_cpu"] == 0


def test_times_two_plain():
    x = torch.randn(128, 128, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(cache_key_probe.times_two(x), x * 2,
                               rtol=0, atol=0)
    assert float(cache_key_probe.times_two(torch.ones(128, 128)).sum()) \
        == 32768.0


# the sizes at which the CUDA kernels take n % 4 tails one element a
# thread, and (the last) a vector pass with a partial last chunk and a tail;
# chip_smoke.py's phase 9 and tests/test_torch_cuda.py hold the kernels to
# the plain versions there
TAIL_SIZES = (1, 3, 5, 4097, 65539, (1 << 20) + 1203)


@pytest.mark.parametrize("n", TAIL_SIZES)
@pytest.mark.parametrize("offset", [0, 1])
def test_bin_formula_plain_at_tail_sizes(n, offset):
    flat = chip_smoke.sweep_tiles(n // (1 << 16) + 1).reshape(-1)
    x = flat[offset:offset + n]
    want = _literal_f32(x.numpy())
    got = bin_math_probe.bin_formula(x, WS, QS)
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        bin_math_probe.bin_formula_plain(x, WS, QS).numpy(), want)


@pytest.mark.parametrize("n", TAIL_SIZES)
def test_times_two_plain_at_tail_sizes(n):
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(
        n + 1).astype(np.float32))[1:]      # a view one element in
    for got in (cache_key_probe.times_two(x),
                cache_key_probe.times_two_plain(x)):
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), x.numpy() * 2)


@pytest.mark.parametrize("tiles", [1, 3])
def test_sweep_tiles_repeat_the_sweep(tiles):
    rel = bin_math_probe.sweep()
    got = chip_smoke.sweep_tiles(tiles)
    assert got.shape == (256 * tiles, 256) and got.dtype == torch.float32
    for t in range(tiles):
        np.testing.assert_array_equal(got[256 * t:256 * (t + 1)].numpy(),
                                      rel)


def test_bin_formula_plain_on_tiles_against_fp64():
    """The plain version at a tiled size differs from the fp64 bins by the
    same count in every tile (the sweep's), at the same places."""
    tiles = 16
    x = chip_smoke.sweep_tiles(tiles)
    got = bin_math_probe.bin_formula_plain(x, WS, QS).numpy()
    gt = bin_math_probe.ground_truth(x.numpy())
    one = int((_literal_f32(bin_math_probe.sweep())
               != bin_math_probe.ground_truth(bin_math_probe.sweep())).sum())
    per_tile = (got != gt).reshape(tiles, -1)
    assert per_tile.sum(1).tolist() == [one] * tiles
    assert (per_tile == per_tile[:1]).all()
    assert 0 < one < 4 * 64


def test_library_inputs_follow_includes():
    assert build._inputs("band_attention_bwd", build.CSRC) == [
        "attention_bwd_common.cuh", "attention_bwd_tc.cuh",
        "attention_common.cuh", "band_attention_bwd.cu", "tensor_core.cuh"]
    # the probes share their elementwise pass, which their keys follow
    assert build._inputs("cache_key_probe", build.CSRC) == [
        "cache_key_probe.cu", "elementwise.cuh"]
    assert build._inputs("bin_math_probe", build.CSRC) == [
        "bin_math_probe.cu", "elementwise.cuh"]
    assert build.sources() == [
        "band_attention", "band_attention_bwd", "bin_math_probe",
        "cache_key_probe", "gather_rows", "sparse_band_attention",
        "sparse_band_attention_bwd"]
    assert build._inputs("gather_rows", build.CSRC) == ["gather_rows.cu"]


# One fresh process: the cache key of band_attention_bwd under a stub nvcc
# version, as it stands and with one component changed.
_KEYS = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from stratified_transformer_torch.kernels import build
csrc, edited = sys.argv[2], sys.argv[3]
def key(csrc=csrc):
    return build.cache_key(build.key_components("band_attention_bwd", csrc))
build._nvcc_version = "nvcc stub: release 12.9, V12.9.0"
out = {"base": key(), "edited_source": key(edited),
       "repo_csrc": key(build.CSRC)}
out["components"] = build.key_components("band_attention_bwd", csrc)
build._nvcc_version = "nvcc stub: release 12.8, V12.8.93"
out["other_nvcc"] = key()
build._nvcc_version = "nvcc stub: release 12.9, V12.9.0"
build.NVCC_FLAGS = build.NVCC_FLAGS + ["-lineinfo"]
out["other_flags"] = key()
print(json.dumps(out))
"""


def test_cache_key_stable_across_processes_and_complete(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    edited = tmp_path / "edited"
    shutil.copytree(build.CSRC, edited)
    header = edited / "attention_common.cuh"
    data = bytearray(header.read_bytes())
    data[-2] = ord(" ") if data[-2] != ord(" ") else ord("\t")
    header.write_bytes(bytes(data))
    # a source that band_attention_bwd.cu does not include leaves its key
    (csrc / "cache_key_probe.cu").write_text("// edited\n")
    env = dict(os.environ, PYTHONHASHSEED="random")
    runs = [json.loads(subprocess.run(
        [sys.executable, "-c", _KEYS, str(ROOT), str(csrc), str(edited)],
        capture_output=True, text=True, check=True, timeout=120, cwd=ROOT,
        env=env).stdout.strip().splitlines()[-1]) for _ in range(2)]
    assert runs[0] == runs[1]
    keys = runs[0]
    assert keys["base"] == build.cache_key(keys["components"])
    assert keys["repo_csrc"] == keys["base"]
    for changed in ("edited_source", "other_nvcc", "other_flags"):
        assert keys[changed] != keys["base"], changed
    comp = keys["components"]
    assert comp["nvcc_version"].startswith("nvcc stub")
    assert comp["flags"] == " ".join(build.NVCC_FLAGS)
    assert sorted(comp["files"]) == [
        "attention_bwd_common.cuh", "attention_bwd_tc.cuh",
        "attention_common.cuh", "band_attention_bwd.cu", "tensor_core.cuh"]
