"""The PyTorch port and its chip smoke script import nothing of JAX, flax
or the JAX package, not even its numpy-only modules, and no scikit-learn,
which the card machine does not have."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "stratified_transformer_torch").rglob("*.py")
    if "_build" not in p.parts) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "stratified_transformer_tpu", "sklearn")


def imported_modules(source):
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_imports(rel):
    source = (ROOT / rel).read_text()
    bad = [m for m in imported_modules(source)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_forbidden_import_is_detected():
    src = "import numpy\nfrom jax import numpy as jnp\n"
    assert "jax" in list(imported_modules(src))


def test_sklearn_import_is_detected():
    """The DCF evaluation clusters with the port's own DBSCAN."""
    src = "def f():\n    from sklearn.cluster import DBSCAN\n"
    assert [m.split(".")[0] for m in imported_modules(src)
            if m.split(".")[0] in FORBIDDEN] == ["sklearn"]
    assert {"stratified_transformer_torch/eval/dbscan.py",
            "stratified_transformer_torch/eval/instantiation.py",
            "stratified_transformer_torch/eval/scene_prep.py",
            "stratified_transformer_torch/eval/iou_driver.py"} <= set(FILES)


def test_the_whole_scene_modules_are_checked():
    assert {"stratified_transformer_torch/ops/neighbors.py",
            "stratified_transformer_torch/ops/sampling.py",
            "stratified_transformer_torch/eval/voting.py",
            "stratified_transformer_torch/eval/driver.py"} <= set(FILES)


def test_the_training_loop_modules_are_checked():
    """``tools/orbax_to_torch.py`` imports the JAX package on purpose (it
    reads its checkpoints) and is outside the port."""
    assert {"stratified_transformer_torch/train/audit.py",
            "stratified_transformer_torch/utils/logger.py",
            "stratified_transformer_torch/data/loader.py",
            "stratified_transformer_torch/train/driver.py"} <= set(FILES)
    assert "tools/orbax_to_torch.py" not in FILES


def test_the_parallel_modules_are_checked():
    assert {"stratified_transformer_torch/parallel/__init__.py",
            "stratified_transformer_torch/parallel/mesh.py",
            "stratified_transformer_torch/parallel/dp.py"} <= set(FILES)


def test_the_sharded_modules_are_checked():
    """Sharded inference's modules, and the test worker that runs them on
    ranks without JAX."""
    assert {"stratified_transformer_torch/parallel/halo.py",
            "stratified_transformer_torch/parallel/mesh.py"} <= set(FILES)
    source = (ROOT / "tests" / "torch_halo_worker.py").read_text()
    assert not [m for m in imported_modules(source)
                if m.split(".")[0] in FORBIDDEN]


def test_the_preparation_and_legacy_modules_are_checked():
    """ScanNet's preparation tool of the port reads scans with the port's
    own PLY reader (the repository's ``tools/prepare_scannet.py`` imports
    the JAX package's, and is outside the port)."""
    assert {"stratified_transformer_torch/ops/legacy.py",
            "stratified_transformer_torch/tools/prepare_scannet.py",
            "stratified_transformer_torch/data/transforms.py",
            "stratified_transformer_torch/train/schedulers.py"} <= set(FILES)
    assert "tools/prepare_scannet.py" not in FILES
