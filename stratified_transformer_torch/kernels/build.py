"""Build the CUDA sources in ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``) at first use into ``_build/``
inside the package (git-ignored). The library's file name carries its cache
key: a hash of the flags, of every file that goes in (the ``.cu`` and the
headers it includes from ``csrc/``) and of ``nvcc --version``'s output
(`key_components`). An edited source or another compiler gets a new
library; a library built under the same key, by this process or another,
is reused. Builds of several sources run in parallel (`build_all`).

The bin arithmetic must not be contracted into FMAs or approximated:
``--use_fast_math`` is never passed, and the kernels spell it with ``_rn``
intrinsics.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each source built by
# this process
build_logs: Dict[str, str] = {}
# `nvcc --version`'s output, read once per process (`nvcc_version`)
_nvcc_version: Optional[str] = None
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def nvcc_version() -> str:
    """`nvcc --version`'s output, read once per process."""
    global _nvcc_version
    if _nvcc_version is None:
        _nvcc_version = subprocess.run(
            [nvcc_path(), "--version"], capture_output=True, text=True,
            check=True).stdout
    return _nvcc_version


def sources(csrc: str = CSRC) -> List[str]:
    """The names of the sources in ``csrc`` (one library each)."""
    return sorted(fn[:-3] for fn in os.listdir(csrc) if fn.endswith(".cu"))


def _inputs(name: str, csrc: str) -> List[str]:
    """``<name>.cu`` and the ``csrc`` headers it includes, transitively."""
    todo, seen = [f"{name}.cu"], []
    while todo:
        fn = todo.pop()
        if fn in seen:
            continue
        seen.append(fn)
        with open(os.path.join(csrc, fn)) as f:
            todo += [inc for inc in _INCLUDE.findall(f.read())
                     if os.path.exists(os.path.join(csrc, inc))]
    return sorted(seen)


def key_components(name: str, csrc: str = CSRC) -> dict:
    """What the cache key of ``<name>.cu`` covers: the nvcc flags, the
    sha256 of each file that goes in, and `nvcc_version`."""
    files = {}
    for fn in _inputs(name, csrc):
        with open(os.path.join(csrc, fn), "rb") as f:
            files[fn] = hashlib.sha256(f.read()).hexdigest()
    return {"flags": " ".join(NVCC_FLAGS), "files": files,
            "nvcc_version": nvcc_version()}


def cache_key(components: dict) -> str:
    return hashlib.sha256(
        json.dumps(components, sort_keys=True).encode()).hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR,
                        f"lib{name}-{cache_key(key_components(name))}.so")


def _start(name: str):
    """Start nvcc for ``csrc/<name>.cu``; None if the library is built."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: Sequence[str]) -> List[str]:
    """Build every named source, all nvcc processes started together;
    returns the library paths."""
    jobs = {n: _start(n) for n in names}
    errors = []
    for n, job in jobs.items():
        if job is not None:
            try:
                _finish(n, job)
            except RuntimeError as e:   # report every failed source
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        if name not in _libs:
            (path,) = build_all([name])
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]
