"""Device-mesh helpers for multi-chip TriTD.

The reference is single-process MATLAB (SURVEY §2.5 — no parallelism of any
kind); the scaling design shards the data tensor along mode-1 slabs (axis
name "slab") and optionally batches independent problems along a "data"
axis. Collectives are jax.lax.psum inside shard_map. The mesh follows the
algorithm alone: the cards of one host reach each other at one rate.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_slab: int | None = None, n_data: int = 1, devices=None) -> Mesh:
    """1-D or 2-D mesh over the available devices: ("data", "slab")."""
    devices = list(devices if devices is not None else jax.devices())
    if n_slab is None:
        n_slab = len(devices) // n_data
    use = devices[: n_data * n_slab]
    arr = np.array(use).reshape(n_data, n_slab)
    return Mesh(arr, ("data", "slab"))


def slab_sharding(mesh: Mesh) -> NamedSharding:
    """Mode-1 slab sharding for (n1, n2, n3) tensors."""
    return NamedSharding(mesh, P("slab", None, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(x, axis: int, multiple: int):
    """Zero-pad one axis up to a multiple (returns padded array and the
    original size). Zero rows are algebraically inert in every TriTD
    contraction (they contribute zero to Grams/RHS), so no masking is needed
    downstream."""
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x, size
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - size)
    import jax.numpy as jnp

    return jnp.pad(x, pad), size
