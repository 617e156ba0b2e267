"""Does a second process reuse the kernels that ``kernels/build.py`` built?

The port's counterpart of the JAX package's ``tools/cache_key_probe.py``.
Builds (or finds built) every source in ``csrc/``, runs the ``x * 2``
kernel (``csrc/cache_key_probe.cu``) on a ``[128,128]`` tensor of ones,
and prints one JSON line with, for every source, each component of its
cache key (the nvcc flags, the sha256 of each file that goes in, the
output of ``nvcc --version``), the key, the library path and whether this
process built the library or reused it, and the result's sum (32768).
Run it twice, in two fresh processes: the second should report the same
keys and ``"reused"`` for every library.

    python -m stratified_transformer_torch.tools.cache_key_probe
"""

from __future__ import annotations

import json
import sys

import torch

from stratified_transformer_torch.kernels import (
    CudaKernel, I, P, build, check_cuda_inputs, ptr, stream_of)

KERNEL = CudaKernel("cache_key_probe", "times_two", [P, P, I, P])
# an empty kernel on the grid KERNEL takes for n elements: the launch floor
# that chip_smoke.py reads the kernel's times against (on no path)
FLOOR = CudaKernel("cache_key_probe", "times_two_floor", [I, P])


def times_two_plain(x):
    return x.to(torch.float32) * 2.0


def times_two(x):
    """``x * 2`` through the kernel (plain version for a CPU tensor)."""
    if x.device.type == "cpu":
        return times_two_plain(x)
    dev = check_cuda_inputs("times_two", (x,))
    x = x.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        KERNEL(ptr(x), ptr(out), x.numel(), stream_of(dev))
    return out


def report():
    """Builds every source (or finds it built) and describes its cache
    key; the dict the probe prints."""
    names = build.sources()
    paths = build.build_all(names)
    out = {}
    for name, path in zip(names, paths):
        comp = build.key_components(name)
        out[name] = {"key": build.cache_key(comp), "components": comp,
                     "library": path,
                     "built_by": ("this process" if name in build.build_logs
                                  else "reused")}
    return out


def main():
    if not torch.cuda.is_available():
        print("cache_key_probe: no CUDA device is available", file=sys.stderr)
        return 2
    libs = report()
    y = times_two(torch.ones(128, 128, device="cuda"))
    print(json.dumps({"sources": libs, "sum": float(y.sum()),
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
