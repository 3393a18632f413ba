"""TriTD design matrices and triple-product reconstruction.

The reference builds three r^2 x (n*n) "design" matrices F, G, H each ADMM
iteration (`fast_robust_triple_tensor/build{F,G,H}.m`) and GEMMs against them.
Two distinct contraction semantics coexist in the reference:

* **hadamard** (the variant every exercised code path uses — local functions
  in `fast_robust_triple_tensor/triple_decomp_ADMM.m:132-160` shadow the
  standalone files):

      F[(q,s), (j,t)] = B[q,j,s] * C[q,s,t]
      G[(p,s), (i,t)] = A[i,p,s] * C[p,s,t]
      H[(p,q), (i,j)] = A[i,p,q] * B[p,j,q]
      L[i,j,t] = sum_{q,s} A[i,q,s] B[q,j,s] C[q,s,t]

  i.e. a CP decomposition of rank r^2 with factor matrices reshaped from
  three coupled 3-way cores.

* **full** (Qi et al. 2021 triple product; standalone
  `origin_triple_tensor/build{F,G,H}.m:4-11`):

      F[(q,s), (j,t)] = sum_p B[p,j,s] C[p,q,t]
      G[(p,s), (i,t)] = sum_q A[i,q,s] C[p,q,t]
      H[(p,q), (i,j)] = sum_s A[i,q,s] B[p,j,s]
      L[i,j,t] = sum_{p,q,s} A[i,q,s] B[p,j,s] C[p,q,t]

Index conventions follow :mod:`tritd_tpu.ops.fold`: row pairs are row-major
(first index major), columns are ordered with the last tensor mode major, so
``unfold(X, 1) @ F.T`` etc. line up exactly.

The solvers NEVER materialize these matrices — see
:mod:`tritd_tpu.ops.normal_eq` for the Hadamard-of-Grams normal equations.
The materializers here exist as the reference-parity oracle for tests and for
the explicit-Kronecker baseline the paper claims speedups against
(`origin_triple_tensor/kronF.m`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Variant = str  # "hadamard" | "full"

#: Precision of every float32 contraction on the TriTD path (here and in
#: :mod:`tritd_tpu.ops.normal_eq`). A GPU may otherwise run f32 dots in TF32
#: (~3 decimal digits), and the C solve's ridge is only 1e-9: on an H100,
#: TF32 put taxi's err_hist 8.4e-3 from the float64 emulator and highway's
#: 6.0e-3 from the CPU solve, both far past their bars. Full f32 costs
#: 13-14% of the solve time there (PERF.md, precision).
PRECISION = jax.lax.Precision.HIGHEST

VARIANTS = ("hadamard", "full")


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")


def build_f(b: jnp.ndarray, c: jnp.ndarray, variant: Variant = "hadamard") -> jnp.ndarray:
    """Design matrix for the mode-1 (A) update, shape (r*r, n3*n2).

    Columns ordered (t major, j minor) to match ``unfold(X, 1)``.
    Reference: `fast_robust_triple_tensor/buildF.m:17-22` (hadamard spec in
    comments `buildF.m:5-16`), `origin_triple_tensor/buildF.m:4-6` (full).
    """
    _check_variant(variant)
    r, n2, _ = b.shape
    _, _, n3 = c.shape
    if variant == "hadamard":
        f4 = jnp.einsum("qjs,qst->qstj", b, c, precision=PRECISION)
    else:
        f4 = jnp.einsum("pjs,pqt->qstj", b, c, precision=PRECISION)
    return f4.reshape(r * r, n3 * n2)


def build_g(a: jnp.ndarray, c: jnp.ndarray, variant: Variant = "hadamard") -> jnp.ndarray:
    """Design matrix for the mode-2 (B) update, shape (r*r, n3*n1).

    Reference: `fast_robust_triple_tensor/buildG.m:17-22`,
    `origin_triple_tensor/buildG.m:6-11` (full).
    """
    _check_variant(variant)
    n1, r, _ = a.shape
    _, _, n3 = c.shape
    if variant == "hadamard":
        g4 = jnp.einsum("ips,pst->psti", a, c, precision=PRECISION)
    else:
        g4 = jnp.einsum("iqs,pqt->psti", a, c, precision=PRECISION)
    return g4.reshape(r * r, n3 * n1)


def build_h(a: jnp.ndarray, b: jnp.ndarray, variant: Variant = "hadamard") -> jnp.ndarray:
    """Design matrix for the mode-3 (C) update, shape (r*r, n2*n1).

    Reference: `fast_robust_triple_tensor/buildH.m:17-22`,
    `origin_triple_tensor/buildH.m:6-11` (full).
    """
    _check_variant(variant)
    n1, r, _ = a.shape
    _, n2, _ = b.shape
    if variant == "hadamard":
        h4 = jnp.einsum("ipq,pjq->pqji", a, b, precision=PRECISION)
    else:
        h4 = jnp.einsum("iqs,pjs->pqji", a, b, precision=PRECISION)
    return h4.reshape(r * r, n2 * n1)


def triple_product(
    a: jnp.ndarray, b: jnp.ndarray, c: jnp.ndarray, variant: Variant = "hadamard"
) -> jnp.ndarray:
    """Reconstruction L = TriTD(A, B, C), shape (n1, n2, n3).

    hadamard: L[i,j,t] = sum_{q,s} A[i,q,s] B[q,j,s] C[q,s,t]
    full:     L[i,j,t] = sum_{p,q,s} A[i,q,s] B[p,j,s] C[p,q,t]

    Computed as one (n1, r^2) x (r^2, n2*n3) GEMM after a cheap r^2-scale
    pre-contraction, the layout of
    `fast_robust_triple_tensor/triple_product.m:6-7`.

    The pre-contraction emits W with (j, t) column order so the GEMM output
    reshapes straight to (n1, n2, n3), with no (n1, n3, n2) transpose of
    the full tensor afterwards.
    """
    _check_variant(variant)
    n1, r, _ = a.shape
    _, n2, _ = b.shape
    _, _, n3 = c.shape
    if variant == "hadamard":
        # W[(q,s), (j,t)] = B[q,j,s] * C[q,s,t]  — cost O(r^2 n2 n3)
        w = jnp.einsum("qjs,qst->qsjt", b, c, precision=PRECISION).reshape(r * r, n2 * n3)
    else:
        # W[(q,s), (j,t)] = sum_p B[p,j,s] C[p,q,t]  — cost O(r^3 n2 n3)
        w = jnp.einsum("pjs,pqt->qsjt", b, c, precision=PRECISION).reshape(r * r, n2 * n3)
    l1 = jnp.matmul(a.reshape(n1, r * r), w, precision=PRECISION)  # O(n1 n2 n3 r^2)
    return l1.reshape(n1, n2, n3)


def triple_product_naive(
    a: jnp.ndarray, b: jnp.ndarray, c: jnp.ndarray, variant: Variant = "hadamard"
) -> jnp.ndarray:
    """Direct einsum oracle for tests (spec: the commented quadruple loops in
    `fast_robust_triple_tensor/buildF.m:5-16` and the naive loop in
    `fast_robust_triple_tensor/test.m:142-160`)."""
    _check_variant(variant)
    if variant == "hadamard":
        return jnp.einsum("iqs,qjs,qst->ijt", a, b, c, precision=PRECISION)
    return jnp.einsum("iqs,pjs,pqt->ijt", a, b, c, precision=PRECISION)


def kron_f(b: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Explicit-Kronecker O(n^3 r^4)-to-build baseline for the full variant,
    kept (like `origin_triple_tensor/kronF.m:4-6`) as the slow reference the
    Kronecker-free path claims speedup against. Returns the same matrix as
    ``build_f(b, c, "full")``."""
    r, n2, _ = b.shape
    _, _, n3 = c.shape
    # F = (I_r (x) B_(2)^pairs) style construction, written directly:
    # F[(q,s),(t,j)] = sum_p B[p,j,s] C[p,q,t]
    bm = b.transpose(2, 1, 0).reshape(r * n2, r)  # [(s,j), p]
    cm = c.transpose(0, 1, 2).reshape(r, r * n3)  # [p, (q,t)]
    f = jnp.matmul(bm, cm, precision=PRECISION)  # [(s,j), (q,t)]
    f = f.reshape(r, n2, r, n3)  # [s, j, q, t]
    return f.transpose(2, 0, 3, 1).reshape(r * r, n3 * n2)


def kron_g(a: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Explicit-Kronecker counterpart of ``build_g(a, c, "full")``
    (`origin_triple_tensor/kronG.m`): G[(p,s),(t,i)] = sum_q A[i,q,s] C[p,q,t]."""
    n1, r, _ = a.shape
    _, _, n3 = c.shape
    am = a.transpose(2, 0, 1).reshape(r * n1, r)  # [(s,i), q]
    cm = c.transpose(1, 0, 2).reshape(r, r * n3)  # [q, (p,t)]
    g = jnp.matmul(am, cm, precision=PRECISION)  # [(s,i), (p,t)]
    g = g.reshape(r, n1, r, n3)  # [s, i, p, t]
    return g.transpose(2, 0, 3, 1).reshape(r * r, n3 * n1)


def kron_h(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Explicit-Kronecker counterpart of ``build_h(a, b, "full")``
    (`origin_triple_tensor/kronH.m`): H[(p,q),(j,i)] = sum_s A[i,q,s] B[p,j,s]."""
    n1, r, _ = a.shape
    _, n2, _ = b.shape
    am = a.transpose(1, 0, 2).reshape(r * n1, r)  # [(q,i), s]
    bm = b.transpose(2, 0, 1).reshape(r, r * n2)  # [s, (p,j)]
    h = jnp.matmul(am, bm, precision=PRECISION)  # [(q,i), (p,j)]
    h = h.reshape(r, n1, r, n2)  # [q, i, p, j]
    return h.transpose(2, 0, 3, 1).reshape(r * r, n2 * n1)
