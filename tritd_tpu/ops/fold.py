"""Mode-n matricization (unfold) and its inverse (fold) for 3-way tensors.

Counterpart of the reference's ``unfold`` kernel
(`fast_robust_triple_tensor/unfold.m:1-14`). The reference uses MATLAB
column-major reshapes; here we fix ONE documented row-major convention and use
it consistently everywhere, so all downstream identities (design matrices,
normal equations, core reshapes) hold exactly.

Convention (row-major, "own mode first, remaining modes (other, last)"):

    unfold(X, 1)[i, t*n2 + j] = X[i, j, t]      shape (n1, n2*n3)
    unfold(X, 2)[j, t*n1 + i] = X[i, j, t]      shape (n2, n1*n3)
    unfold(X, 3)[t, j*n1 + i] = X[i, j, t]      shape (n3, n1*n2)

This matches the *column ordering* of the MATLAB reference (its columns are
also ordered with the last tensor mode major), so materialized design
matrices agree with the reference up to its (q,s)-pair row permutation.

Core flatteners: the three TriTD cores A:(n1,r,r), B:(r,n2,r), C:(r,r,n3)
are flattened with the (r,r) index pair in row-major order:

    core_a_mat[i, p*r + q] = A[i, p, q]         shape (n1, r*r)
    core_b_mat[q*r + s, j] = B[q, j, s]         shape (r*r, n2)
    core_c_mat[q*r + s, t] = C[q, s, t]         shape (r*r, n3)

All functions are pure reshape/transposes — zero-FLOP, fused by XLA.
"""

from __future__ import annotations

import jax.numpy as jnp


def unfold(x: jnp.ndarray, mode: int) -> jnp.ndarray:
    """Mode-n matricization of a 3-way tensor (mode in {1, 2, 3}).

    Mirrors `fast_robust_triple_tensor/unfold.m:1-14` under the row-major
    convention documented in the module docstring.
    """
    n1, n2, n3 = x.shape
    if mode == 1:
        return jnp.transpose(x, (0, 2, 1)).reshape(n1, n3 * n2)
    if mode == 2:
        return jnp.transpose(x, (1, 2, 0)).reshape(n2, n3 * n1)
    if mode == 3:
        return jnp.transpose(x, (2, 1, 0)).reshape(n3, n2 * n1)
    raise ValueError(f"mode must be 1, 2 or 3, got {mode}")


def fold(xn: jnp.ndarray, mode: int, shape: tuple[int, int, int]) -> jnp.ndarray:
    """Inverse of :func:`unfold`: rebuild the 3-way tensor from its mode-n
    matricization. ``fold(unfold(x, m), m, x.shape) == x``."""
    n1, n2, n3 = shape
    if mode == 1:
        return xn.reshape(n1, n3, n2).transpose(0, 2, 1)
    if mode == 2:
        return xn.reshape(n2, n3, n1).transpose(2, 0, 1)
    if mode == 3:
        return xn.reshape(n3, n2, n1).transpose(2, 1, 0)
    raise ValueError(f"mode must be 1, 2 or 3, got {mode}")


# ----------------------------------------------------------------------------
# Core flatteners — the (r, r) pair index is always row-major (first r major).
# The reference's per-row reshape loops (`triple_decomp_ADMM.m:111-130`,
# reshape_A_from_A1 / reshape_B_from_B2 / reshape_C_from_C3) become single
# zero-copy reshapes under a fixed pair convention.
# ----------------------------------------------------------------------------


def core_a_mat(a: jnp.ndarray) -> jnp.ndarray:
    """A:(n1,r,r) -> (n1, r*r) with columns (p, q) row-major."""
    n1, r, _ = a.shape
    return a.reshape(n1, r * r)


def core_a_from_mat(a1: jnp.ndarray, r: int) -> jnp.ndarray:
    """(n1, r*r) -> A:(n1,r,r). Inverse of :func:`core_a_mat`."""
    n1 = a1.shape[0]
    return a1.reshape(n1, r, r)


def core_b_mat(b: jnp.ndarray) -> jnp.ndarray:
    """B:(r,n2,r) -> (r*r, n2) with rows (q, s) row-major."""
    r, n2, _ = b.shape
    return jnp.transpose(b, (0, 2, 1)).reshape(r * r, n2)


def core_b_from_mat(b2: jnp.ndarray, r: int) -> jnp.ndarray:
    """(n2, r*r) row-per-j layout -> B:(r,n2,r). Used after the mode-2 solve
    where each row j holds vec(B[:, j, :])."""
    n2 = b2.shape[0]
    return b2.reshape(n2, r, r).transpose(1, 0, 2)


def core_c_mat(c: jnp.ndarray) -> jnp.ndarray:
    """C:(r,r,n3) -> (r*r, n3) with rows (q, s) row-major."""
    r, _, n3 = c.shape
    return c.reshape(r * r, n3)


def core_c_from_mat(c3: jnp.ndarray, r: int) -> jnp.ndarray:
    """(n3, r*r) row-per-t layout -> C:(r,r,n3). Used after the mode-3 solve
    where each row t holds vec(C[:, :, t])."""
    n3 = c3.shape[0]
    return c3.reshape(n3, r, r).transpose(1, 2, 0)
