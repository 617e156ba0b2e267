"""Does the card compute the cRPE bin formula differently from the host?

The port's counterpart of the JAX package's ``tools/bin_math_probe.py``.
The formula in its division form,

    bin = floor((round(x * 1e5) / 1e5 + 2*ws - 1e-4) / qs)

runs over a dense sweep of relative coordinates (random 1e-5 lattice
values, the 64 exact bin bounds, their 1-ulp neighbours and bounds + 1e-5;
seed 0, ``[256,256]`` fp32) in three ways: the CUDA kernel
(``csrc/bin_math_probe.cu``), its plain PyTorch version on the CPU, and
the same torch ops on the card. Prints how many bins differ between them,
how many of each differ from the fp64 ground truth, and up to 10 examples,
then one JSON line.

    python -m stratified_transformer_torch.tools.bin_math_probe [--device cuda|cpu]

With ``--device cpu`` the wrapper runs the plain version, so only the
counts against fp64 say anything.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from stratified_transformer_torch.kernels import (
    CudaKernel, F, I, P, check_cuda_inputs, ptr, stream_of)

KERNEL = CudaKernel("bin_math_probe", "bin_formula", [P, P, I, F, F, P])
# an empty kernel on the grid KERNEL takes for n elements: the launch floor
# that chip_smoke.py reads the kernel's times against (on no path)
FLOOR = CudaKernel("bin_math_probe", "bin_formula_floor", [I, P])

WS, QS = 0.64, 0.04            # stage 2 of the S3DIS configuration
N_BOUNDS = 64


def sweep(ws=WS, qs=QS, seed=0):
    """The probe's ``[256,256]`` fp32 sweep (the JAX probe's, value for
    value)."""
    n = 1 << 16
    rng = np.random.default_rng(seed)
    bounds = (np.arange(N_BOUNDS) * qs - 2 * ws + 1e-4).astype(np.float32)
    lattice = np.round(rng.uniform(-2 * ws, 2 * ws, n - 4 * N_BOUNDS)
                       * 1e5) / 1e5
    rel = np.concatenate([
        lattice.astype(np.float32), bounds,
        np.nextafter(bounds, np.float32(-np.inf)),
        np.nextafter(bounds, np.float32(np.inf)),
        (bounds + np.float32(1e-5)).astype(np.float32)]).astype(np.float32)
    return rel[: (len(rel) // 256) * 256].reshape(-1, 256)


def bin_formula_plain(x, ws, qs):
    """The formula in fp32 torch ops, in the kernel's order; every division
    is by a tensor of the divisor (PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal)."""
    x = x.to(torch.float32)

    def full(c):
        return torch.full_like(x, c)
    r = torch.round(x * full(1e5)) / full(1e5)
    t = (r + full(2.0 * ws)) - full(1e-4)
    return torch.floor(t / full(qs)).to(torch.int32)


def bin_formula(x, ws, qs):
    """The kernel's bins for ``x`` (plain version for a CPU tensor)."""
    if x.device.type == "cpu":
        return bin_formula_plain(x, ws, qs)
    dev = check_cuda_inputs("bin_formula", (x,))
    x = x.to(torch.float32).contiguous()
    out = torch.empty(x.shape, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        KERNEL(ptr(x), ptr(out), x.numel(), float(np.float32(2.0 * ws)),
               float(np.float32(qs)), stream_of(dev))
    return out


def ground_truth(rel, ws=WS, qs=QS):
    """fp64 bins of the sweep."""
    r64 = np.round(rel.astype(np.float64) * 1e5) / 1e5
    return np.floor((r64 + 2.0 * ws - 1e-4) / qs).astype(np.int64)


def probe(device, ws=WS, qs=QS):
    """Counts of differing bins (see the module docstring) as a dict."""
    rel = sweep(ws, qs)
    x = torch.from_numpy(rel)
    kern = bin_formula(x.to(device), ws, qs).cpu().numpy()
    cpu = bin_formula_plain(x, ws, qs).numpy()
    dev_ops = bin_formula_plain(x.to(device), ws, qs).cpu().numpy()
    gt = ground_truth(rel, ws, qs)
    diff = np.argwhere(kern != cpu)[:10]
    return {
        "device": str(device), "values": int(rel.size),
        "kernel_vs_cpu": int((kern != cpu).sum()),
        "kernel_vs_device_ops": int((kern != dev_ops).sum()),
        "kernel_vs_fp64": int((kern != gt).sum()),
        "cpu_vs_fp64": int((cpu != gt).sum()),
        "device_ops_vs_fp64": int((dev_ops != gt).sum()),
        "examples": [{"rel": float(rel[i, j]), "kernel": int(kern[i, j]),
                      "cpu": int(cpu[i, j])} for i, j in diff],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bin_math_probe: no CUDA device (pass --device cpu)",
              file=sys.stderr)
        return 2
    r = probe(torch.device(args.device))
    print(f"total {r['values']} values; kernel vs plain version on the CPU: "
          f"{r['kernel_vs_cpu']} differ; kernel vs the same torch ops on "
          f"{r['device']}: {r['kernel_vs_device_ops']} differ")
    for e in r["examples"]:
        print(f"  rel={e['rel']!r}  kernel={e['kernel']}  cpu={e['cpu']}")
    print(f"kernel vs fp64 ground truth: {r['kernel_vs_fp64']} differ; "
          f"CPU ops: {r['cpu_vs_fp64']}; {r['device']} ops: "
          f"{r['device_ops_vs_fp64']}")
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
