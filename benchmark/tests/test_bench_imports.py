"""No module the benchmark loads has the top-level name of JAX or of the
JAX package, and the reference loads nothing of the program: by the
sources' import statements and by what a fresh process holds after
importing them. Names are compared whole (the part before the first dot):
the port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

from benchlib import common

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM = "stratified_transformer_torch"


def _imports(root):
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    for a in node.names:
                        yield path, a.name.split(".", 1)[0]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    yield path, node.module.split(".", 1)[0]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like_name", sys)
    monkeypatch.setitem(sys.modules, "stratified_transformer_tpu_x", sys)
    assert common.forbidden_modules() == [
        m for m in common.FORBIDDEN if m in {
            k.split(".", 1)[0] for k in sys.modules}]
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert "jaxlib" in common.forbidden_modules()


def test_harness_sources_import_no_jax():
    bad = [(p, m) for p, m in _imports(BENCH) if m in common.FORBIDDEN]
    assert not bad


def test_reference_sources_import_nothing_of_the_program():
    forbidden = set(common.FORBIDDEN) | {PROGRAM}
    bad = [(p, m) for p, m in _imports(os.path.join(BENCH, "reference"))
           if m in forbidden]
    assert not bad


@pytest.mark.parametrize("modules, forbidden", [
    (["reference.run", "reference.models.stratified"],
     common.FORBIDDEN + (PROGRAM,)),
    (["benchlib.runner", "benchlib.train_cell", "benchlib.eval_cell",
      "benchlib.probe", "stratified_transformer_torch.models.stratified",
      "stratified_transformer_torch.train.driver",
      "stratified_transformer_torch.eval.driver"], common.FORBIDDEN),
])
def test_a_fresh_process_holds_none(modules, forbidden):
    code = ("import sys; sys.path[:0] = [%r, %r]; " % (
        BENCH, os.path.dirname(BENCH))
        + "".join(f"import {m}; " for m in modules)
        + "print(sorted({k.split('.', 1)[0] for k in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    tops = set(eval(out.strip().splitlines()[-1]))
    assert not tops & set(forbidden)
