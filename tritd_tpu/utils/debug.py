"""Numerical-debugging helpers (SURVEY §5 race-detection/sanitizer row).

The reference is single-threaded MATLAB with no sanitizers; the JAX
equivalents are jit purity + NaN trapping + deterministic collectives (races
are structurally impossible under jit/shard_map — every reduction order is
fixed at compile time). These helpers switch the relevant JAX debug modes.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def nan_debug():
    """Trap NaNs at the op level (`jax_debug_nans`) — recompiles affected
    functions un-fused, so use for diagnosis only."""
    prev = jax.config.read("jax_debug_nans")
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


@contextlib.contextmanager
def strict_determinism():
    """Bitwise-deterministic mode: disables autotuning-dependent reductions
    where supported (x64 off is unchanged; collectives under shard_map are
    already deterministic)."""
    prev = jax.config.read("jax_default_matmul_precision")
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        yield
    finally:
        jax.config.update("jax_default_matmul_precision", prev)


def check_finite(tree, where: str = "") -> None:
    """Host-side assertion that every leaf of a pytree is finite."""
    import numpy as np

    for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
        arr = np.asarray(leaf)
        if not np.isfinite(arr).all():
            raise FloatingPointError(
                f"non-finite values in leaf {i}"
                + (f" at {where}" if where else "")
            )
