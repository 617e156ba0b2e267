"""Random weights from the run's seed, made on the model's device in two
large draws and handed to the program and to the reference alike.

Leaves are filled in the order of their sorted names, so the values depend
only on the names and shapes: Linear weights and cRPE tables normal(0,
0.02) clipped to +-2 std, KPConv kernels He-uniform, biases 0, norm
weights 1.
"""

from __future__ import annotations

import math

import torch


def spec(module):
    """``[(name, shape)]`` of ``module``'s parameters, sorted by name."""
    return sorted((n, tuple(p.shape)) for n, p in module.named_parameters())


def generate(leaves, seed, device):
    """``{name: tensor}`` for ``leaves`` (`spec`), drawn on ``device`` from
    ``torch.Generator(device).manual_seed(seed)``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(math.prod(s) for _, s in leaves)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, pos = {}, 0
    for name, shape in leaves:
        n = math.prod(shape)
        if name.endswith("kernel_weights"):
            limit = math.sqrt(6.0 / (shape[0] * shape[1]))
            t = uniform[pos:pos + n] * (2 * limit) - limit
        elif name.endswith("_table") or (name.endswith(".weight")
                                         and len(shape) == 2):
            t = (normal[pos:pos + n] * 0.02).clamp(-0.04, 0.04)
        elif name.endswith(".weight"):
            t = torch.ones(n, device=device)
        elif name.endswith(".bias"):
            t = torch.zeros(n, device=device)
        else:
            raise ValueError(f"no rule for the parameter {name} {shape}")
        out[name] = t.reshape(shape)
        pos += n
    return out


@torch.no_grad()
def load(module, seed):
    """Fill ``module``'s parameters (on their device) from ``seed``."""
    dev = next(module.parameters()).device
    values = generate(spec(module), seed, dev)
    for name, p in module.named_parameters():
        p.copy_(values[name])
