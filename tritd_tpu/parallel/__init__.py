"""Multi-chip sharding layer: mesh helpers, sharded ADMM, multi-host
bootstrap (jax.distributed across hosts; see parallel/distributed.py)."""

from .mesh import make_mesh, slab_sharding, replicated, pad_to_multiple
from .sharded_admm import tritd_admm_sharded, tritd_admm_auto, tritd_admm_batch_sharded
from .distributed import (
    initialize_distributed,
    make_host_chip_mesh,
    make_global_slab_mesh,
)

__all__ = [
    "make_mesh",
    "slab_sharding",
    "replicated",
    "pad_to_multiple",
    "tritd_admm_sharded",
    "tritd_admm_auto",
    "tritd_admm_batch_sharded",
    "initialize_distributed",
    "make_host_chip_mesh",
    "make_global_slab_mesh",
]
