"""Data parallelism and sharded inference (the JAX package's
``parallel/``): process groups, rank processes and the collectives of
sharded inference (`mesh`), the data-parallel training step (`dp`), whose
SyncBN runs inside the model (`models.layers.MaskedBatchNorm`), and
whole-scene inference over spatial slabs with receptive halos (`halo`).

The JAX package drives a mesh of devices from one process (``shard_map``,
gradient ``pmean`` and SyncBN ``psum`` over its ``data`` axis); the port
runs one process per rank joined by a ``torch.distributed`` process group
(NCCL between cards, gloo on the CPU) and reduces with explicit
all-reduces (the reference's DDP + SyncBatchNorm, ``train.py:88-105,
152-161``).
"""

from stratified_transformer_torch.parallel.mesh import (  # noqa: F401
    init_group, initialize_multihost, spawn,
)
from stratified_transformer_torch.parallel.dp import (  # noqa: F401
    all_reduce_grads, make_dp_train_step,
)
