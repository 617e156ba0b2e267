"""The benchmark's plain reference: a frozen copy of the port's plain path
(``attn_impl: reference``), in plain PyTorch, numpy and scipy, that imports
nothing of the program.

Copied from ``stratified_transformer_torch``: ``config.py`` (the YAML ->
`StratifiedConfig` rules, without the sharded keys), ``models/`` (the
model, without the kernel wrappers and without weight initialisation: the
benchmark hands the weights in), ``ops/`` (plans, windows, hashing,
on-device sampling and neighbour search, the plain attention and its
autograd Function), ``data/pyramid.py`` and ``data/host_neighbors.py`` (the
host tier's pyramid and radius neighbours), ``train/losses.py`` and
``train/schedulers.py``. Departures: the attention Function runs the plain
versions only, and its product operands take a rounding given by the
caller (fp32, the shipped bf16, or the control's lower precision).
`run` holds the entry points: the train steps and the eval forward.
"""
