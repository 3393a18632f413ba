"""Kronecker-free normal equations for the TriTD mode updates.

This is the per-chip speed-of-light upgrade over the reference, which
materializes F/G/H each iteration (`triple_decomp_ADMM.m:75-77,85-86,92-93`)
and pays O(n^3 r^2) memory traffic per build. The Grams factorize, so the
designs never need to exist:

hadamard variant (see :mod:`tritd_tpu.ops.designs` for the contractions):

    F F^T[(q,s),(q',s')] = (sum_j B[q,j,s] B[q',j,s'])   # GramB, one GEMM
                         * (sum_t C[q,s,t] C[q',s',t])   # GramC, one GEMM
    G G^T = GramA (.) GramC      H H^T = GramA (.) GramB

with GramA = Af^T Af for Af = A reshaped (n1, r^2), and GramB/GramC the
(r^2, r^2) Grams of the (r^2, n)-flattened B and C cores. Right-hand sides
are single three-operand einsums (one O(n1 n2 n3 r^2) GEMM + a cheap
contraction each):

    rhs_1[i,(q,s)] = sum_{j,t} X[i,j,t] B[q,j,s] C[q,s,t]
    rhs_2[j,(p,s)] = sum_{i,t} X[i,j,t] A[i,p,s] C[p,s,t]
    rhs_3[t,(p,q)] = sum_{i,j} X[i,j,t] A[i,p,q] B[p,j,q]

Per-mode cost drops from the reference's O(n^3 r^2) build + O(n^3 r^2) GEMM +
pinv to O(n^3 r^2) fused GEMM + O(n r^4) Gram + O(r^6) solve, with zero
F/G/H memory traffic.

full variant: the Grams couple through the shared p/q/s contraction index but
still reduce to r^6-scale contractions of the same three (r^2, r^2) Grams —
no n-sized work beyond the GEMMs.

Every function here is shape-polymorphic, jit-safe, and differentiable.
The sharded path (:mod:`tritd_tpu.parallel`) psum-reduces exactly these
Grams/RHS (O(r^4) + O(n r^2) words per iteration).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .designs import PRECISION, _check_variant


# ----------------------------------------------------------------------------
# Core Grams — each one GEMM of shape (r^2, n) x (n, r^2).
# ----------------------------------------------------------------------------


def gram_a(a: jnp.ndarray) -> jnp.ndarray:
    """GramA[(p,q),(p',q')] = sum_i A[i,p,q] A[i,p',q'] — (r^2, r^2)."""
    n1, r, _ = a.shape
    af = a.reshape(n1, r * r)
    return jnp.matmul(af.T, af, precision=PRECISION)


def gram_b(b: jnp.ndarray) -> jnp.ndarray:
    """GramB[(q,s),(q',s')] = sum_j B[q,j,s] B[q',j,s'] — (r^2, r^2)."""
    r, n2, _ = b.shape
    bm = b.transpose(0, 2, 1).reshape(r * r, n2)
    return jnp.matmul(bm, bm.T, precision=PRECISION)


def gram_c(c: jnp.ndarray) -> jnp.ndarray:
    """GramC[(q,s),(q',s')] = sum_t C[q,s,t] C[q',s',t] — (r^2, r^2)."""
    r, _, n3 = c.shape
    cm = c.reshape(r * r, n3)
    return jnp.matmul(cm, cm.T, precision=PRECISION)


# ----------------------------------------------------------------------------
# Normal-equation matrices K = (design)(design)^T, (r^2, r^2), SPD.
# ----------------------------------------------------------------------------


def combine_grams(
    mode: int,
    ga: jnp.ndarray | None,
    gb: jnp.ndarray | None,
    gc: jnp.ndarray | None,
    variant: str = "hadamard",
) -> jnp.ndarray:
    """Combine precomputed core Grams into the mode's normal-equation matrix.

    Split out of :func:`gram_mode` so the sharded path can psum-reduce GramA
    across mode-1 slabs before combining (O(r^4) words of collective traffic
    per iteration — the north-star communication budget)."""
    _check_variant(variant)
    if variant == "hadamard":
        if mode == 1:
            return gb * gc
        if mode == 2:
            return ga * gc
        if mode == 3:
            return ga * gb
        raise ValueError(f"mode must be 1, 2 or 3, got {mode}")
    some = ga if ga is not None else gb
    rr = some.shape[0]
    r = int(round(rr**0.5))
    ga4 = ga.reshape(r, r, r, r) if ga is not None else None  # [q,s,q',s']
    gb4 = gb.reshape(r, r, r, r) if gb is not None else None  # [p,s,p',s']
    gc4 = gc.reshape(r, r, r, r) if gc is not None else None  # [p,q,p',q']
    if mode == 1:
        # F F^T[(q,s),(q',s')] = sum_{p,p'} GB[p,s,p',s'] GC[p,q,p',q']
        k = jnp.einsum("psPS,pqPQ->qsQS", gb4, gc4, precision=PRECISION)
    elif mode == 2:
        # G G^T[(p,s),(p',s')] = sum_{q,q'} GA[q,s,q',s'] GC[p,q,p',q']
        k = jnp.einsum("qsQS,pqPQ->psPS", ga4, gc4, precision=PRECISION)
    elif mode == 3:
        # H H^T[(p,q),(p',q')] = sum_{s,s'} GA[q,s,q',s'] GB[p,s,p',s']
        k = jnp.einsum("qsQS,psPS->pqPQ", ga4, gb4, precision=PRECISION)
    else:
        raise ValueError(f"mode must be 1, 2 or 3, got {mode}")
    return k.reshape(r * r, r * r)


def gram_mode(
    mode: int,
    a: jnp.ndarray,
    b: jnp.ndarray,
    c: jnp.ndarray,
    variant: str = "hadamard",
) -> jnp.ndarray:
    """K = F F^T (mode 1) / G G^T (mode 2) / H H^T (mode 3) without ever
    materializing the design matrix."""
    ga = gram_a(a) if mode in (2, 3) else None
    gb = gram_b(b) if mode in (1, 3) else None
    gc = gram_c(c) if mode in (1, 2) else None
    return combine_grams(mode, ga, gb, gc, variant)


def rhs_mode(
    mode: int,
    x: jnp.ndarray,
    a: jnp.ndarray,
    b: jnp.ndarray,
    c: jnp.ndarray,
    variant: str = "hadamard",
    einsum_dtype=None,
) -> jnp.ndarray:
    """Right-hand side unfold(X, mode) @ design^T, shape (n_mode, r^2),
    computed as a direct three-operand einsum (no design materialization).

    einsum_dtype: optional lower-precision input dtype (e.g. bfloat16) for
    the O(n^3 r^2) contraction — accumulation stays float32 via
    preferred_element_type, trading ~3 mantissa decimal digits on the RHS
    for throughput. The Grams/solves always stay float32, and without it
    the contraction runs at :data:`PRECISION`."""
    _check_variant(variant)
    r = a.shape[1]
    # Output in the FACTOR dtype: x may arrive pre-cast to the low-precision
    # einsum dtype (the solver stores the carried T that way), and the ridge
    # solves downstream must stay full precision.
    out_dtype = a.dtype
    # Accumulation dtype: float32 when the inputs were deliberately
    # down-cast (the bf16 MXU knob), else the factor dtype itself — a
    # hard-coded float32 here would silently truncate float64 runs.
    acc_dtype = jnp.float32 if einsum_dtype is not None else out_dtype
    # the bf16 opt-in asks for narrow products; everything else is full f32
    prec = None if einsum_dtype is not None else PRECISION
    if einsum_dtype is not None:
        x = x.astype(einsum_dtype)
        a = a.astype(einsum_dtype)
        b = b.astype(einsum_dtype)
        c = c.astype(einsum_dtype)
    if variant == "hadamard":
        if mode == 1:
            rhs = jnp.einsum("ijt,qjs,qst->iqs", x, b, c, optimize="optimal", preferred_element_type=acc_dtype, precision=prec)
        elif mode == 2:
            rhs = jnp.einsum("ijt,ips,pst->jps", x, a, c, optimize="optimal", preferred_element_type=acc_dtype, precision=prec)
        elif mode == 3:
            rhs = jnp.einsum("ijt,ipq,pjq->tpq", x, a, b, optimize="optimal", preferred_element_type=acc_dtype, precision=prec)
        else:
            raise ValueError(f"mode must be 1, 2 or 3, got {mode}")
    else:
        if mode == 1:
            rhs = jnp.einsum("ijt,pjs,pqt->iqs", x, b, c, optimize="optimal", preferred_element_type=acc_dtype, precision=prec)
        elif mode == 2:
            rhs = jnp.einsum("ijt,iqs,pqt->jps", x, a, c, optimize="optimal", preferred_element_type=acc_dtype, precision=prec)
        elif mode == 3:
            rhs = jnp.einsum("ijt,iqs,pjs->tpq", x, a, b, optimize="optimal", preferred_element_type=acc_dtype, precision=prec)
        else:
            raise ValueError(f"mode must be 1, 2 or 3, got {mode}")
    n_mode = rhs.shape[0]
    return rhs.reshape(n_mode, r * r).astype(out_dtype)


def gram_and_rhs(
    mode: int,
    x: jnp.ndarray,
    a: jnp.ndarray,
    b: jnp.ndarray,
    c: jnp.ndarray,
    variant: str = "hadamard",
    einsum_dtype=None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(K, rhs) for the ridge system of the given mode update."""
    return (
        gram_mode(mode, a, b, c, variant=variant),
        rhs_mode(mode, x, a, b, c, variant=variant, einsum_dtype=einsum_dtype),
    )


# ----------------------------------------------------------------------------
# Ridge solve — replaces the reference's SVD-based `pinv(K + alpha I)`
# (`triple_decomp_ADMM.m:77-78,86,93`) with an SPD Cholesky solve (no SVD
# on the hot path). `pinv` and `lstsq` kept as compat fallbacks for
# near-singular unridged systems.
# ----------------------------------------------------------------------------

SOLVE_METHODS = ("cholesky", "pinv", "lstsq")


@functools.partial(jax.jit, static_argnames=("method",))
def ridge_solve(
    k: jnp.ndarray,
    rhs: jnp.ndarray,
    alpha: jnp.ndarray | float,
    method: str = "cholesky",
) -> jnp.ndarray:
    """Solve rows @ (K + alpha I) = rhs for rows, i.e. rhs @ inv(K + alpha I).

    K is SPD (a Gram), so Cholesky is exact where pinv is approximate; the
    reference's alpha=1e-9 mode-3 system can be near-singular, hence the
    pinv/lstsq escape hatches (SURVEY §7 risk b).
    """
    m = k.shape[0]
    kr = k + jnp.asarray(alpha, k.dtype) * jnp.eye(m, dtype=k.dtype)
    if method == "cholesky":
        cho = jax.scipy.linalg.cho_factor(kr, lower=True)
        # Solve K Z = rhs^T, answer = Z^T  (K symmetric).
        return jax.scipy.linalg.cho_solve(cho, rhs.T).T
    if method == "pinv":
        return jnp.matmul(rhs, jnp.linalg.pinv(kr), precision=PRECISION)
    if method == "lstsq":
        return jnp.linalg.lstsq(kr, rhs.T)[0].T
    raise ValueError(f"method must be one of {SOLVE_METHODS}, got {method!r}")
