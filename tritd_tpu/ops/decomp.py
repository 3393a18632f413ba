"""Classic CP / Tucker decomposition algorithms — the Tensor Toolbox v3.1
algorithm surface (SURVEY §2.3: "CP/Tucker algorithms", `Contents.m:17-50`).

The reference vendors Tensor Toolbox twice and its drivers exercise only the
class surface (:mod:`tritd_tpu.ops.kruskal`); these are the headline
algorithms of that library (`cp_als.m`, `tucker_als.m`, `hosvd.m`) rebuilt
for XLA: N-way generic, jit'd `lax.while_loop` bodies, MTTKRP as one fused
einsum per mode (never materializing the Khatri-Rao product), and
QR/eigh-based orthonormal bases instead of host-side SVDs where possible.

These also serve as internal building blocks: SOFIA's batch init is a masked
variant of `cp_als` (`other_methods/sofia/sofia_als.m:51`), and HOSVD is the
standard spectral initializer for Tucker-structured baselines.
"""

from __future__ import annotations

import functools
import string

import jax
import jax.numpy as jnp

from .kruskal import cp_normalize, ktensor_full

_LETTERS = string.ascii_lowercase


def mttkrp(x: jnp.ndarray, factors, mode: int) -> jnp.ndarray:
    """Matricized-tensor times Khatri-Rao product for the given mode
    (Tensor Toolbox `mttkrp`), as ONE einsum — the Khatri-Rao matrix
    (prod n_i, R) never materializes, so the whole contraction tiles onto
    the MXU with O(prod n_i * R) FLOPs and no extra HBM traffic."""
    n = x.ndim
    tensor_spec = _LETTERS[:n]
    operands, specs = [x], [tensor_spec]
    for ax, u in enumerate(factors):
        if ax == mode:
            continue
        operands.append(u)
        specs.append(f"{_LETTERS[ax]}r")
    out = f"{_LETTERS[mode]}r"
    return jnp.einsum(",".join(specs) + "->" + out, *operands, optimize="optimal")


def _factor_grams(factors):
    return [u.T @ u for u in factors]


@functools.partial(jax.jit, static_argnames=("rank", "max_iters", "tol"))
def _cp_als_run(x, factors0, rank: int, max_iters: int, tol: float):
    n = x.ndim
    norm_x = jnp.linalg.norm(x.ravel())
    eye = jnp.eye(rank, dtype=x.dtype)

    def body(carry):
        factors, _fit, _delta, it = carry
        factors = list(factors)
        for mode in range(n):
            rhs = mttkrp(x, factors, mode)  # (n_mode, R)
            # Hadamard product of the other modes' R x R Grams
            # (`cp_als.m` "Y = prod(UtU(:,:,[1:n-1,n+1:N]),3)").
            g = jnp.ones((rank, rank), x.dtype)
            for ax in range(n):
                if ax != mode:
                    g = g * (factors[ax].T @ factors[ax])
            # rows @ inv(G): solve the SPD system instead of pinv. The jitter
            # is scale-relative and above the dtype's eps so overcomplete
            # ranks (R > n_mode, singular Gram) stay finite instead of
            # collapsing to NaN.
            eps = jnp.finfo(x.dtype).eps
            jitter = 32 * eps * (jnp.trace(g) / rank + 1.0)
            cho = jax.scipy.linalg.cho_factor(g + jitter * eye, lower=True)
            factors[mode] = jax.scipy.linalg.cho_solve(cho, rhs.T).T
        # fit = 1 - ||X - full||/||X||, computed without materializing `full`:
        # ||full||^2 = 1^T (hadamard of Grams) 1, <X, full> = <mttkrp_N, U_N>.
        g_all = jnp.ones((rank, rank), x.dtype)
        for u in factors:
            g_all = g_all * (u.T @ u)
        norm_full_sq = jnp.sum(g_all)
        inner = jnp.sum(mttkrp(x, factors, n - 1) * factors[n - 1])
        resid_sq = jnp.maximum(norm_x**2 + norm_full_sq - 2.0 * inner, 0.0)
        fit = 1.0 - jnp.sqrt(resid_sq) / norm_x
        return tuple(factors), fit, jnp.abs(fit - _fit), it + 1

    def cond(carry):
        _factors, _fit, delta, it = carry
        return (it < max_iters) & (delta >= tol)

    init = (tuple(factors0), jnp.asarray(-jnp.inf, x.dtype), jnp.asarray(jnp.inf, x.dtype), jnp.asarray(0, jnp.int32))
    factors, fit, _delta, iters = jax.lax.while_loop(cond, body, init)
    return list(factors), fit, iters


def cp_als(
    x: jnp.ndarray,
    rank: int,
    max_iters: int = 50,
    tol: float = 1e-4,
    key: jax.Array | None = None,
    init_factors=None,
    init: str = "random",
):
    """CP decomposition by alternating least squares (`cp_als.m` semantics:
    per-mode MTTKRP + Hadamard-Gram solve, fit-change stop).

    init: "random" (uniform factors — the toolbox default; seed-sensitive,
    can stall in local optima exactly as the original does) or "nvecs"
    (per-mode leading singular bases, the toolbox's deterministic option —
    recommended; columns beyond n_mode are padded with random normals for
    overcomplete ranks).

    Returns dict with `weights`, `factors` (column-normalized), `fit`
    (1 - relative error), `n_iters`.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    if init_factors is None:
        keys = jax.random.split(key, x.ndim)
        if init == "nvecs":
            init_factors = []
            for mode, (k, s) in enumerate(zip(keys, x.shape)):
                u = _leading_basis(x, mode, min(rank, s))
                if rank > s:
                    pad = jax.random.normal(k, (s, rank - s), x.dtype)
                    u = jnp.concatenate([u, pad], axis=1)
                init_factors.append(u.astype(x.dtype))
        elif init == "random":
            init_factors = [
                jax.random.uniform(k, (s, rank), x.dtype)
                for k, s in zip(keys, x.shape)
            ]
        else:
            raise ValueError(f'init must be "random" or "nvecs", got {init!r}')
    factors, fit, iters = _cp_als_run(x, init_factors, rank, max_iters, tol)
    factors, weights = cp_normalize(factors)
    return {
        "weights": weights,
        "factors": factors,
        "fit": fit,
        "n_iters": iters,
    }


def _leading_basis(x: jnp.ndarray, mode: int, rank: int) -> jnp.ndarray:
    """Top-`rank` left singular vectors of unfold(x, mode), via eigh on the
    (n_mode, n_mode) Gram (no SVD of the fat unfolding)."""
    n = x.ndim
    perm = (mode,) + tuple(ax for ax in range(n) if ax != mode)
    xm = jnp.transpose(x, perm).reshape(x.shape[mode], -1)
    gram = xm @ xm.T
    _w, v = jnp.linalg.eigh(gram)  # ascending eigenvalues
    return v[:, ::-1][:, :rank]


def tucker_hosvd(x: jnp.ndarray, ranks) -> dict:
    """Truncated higher-order SVD (`hosvd.m` semantics): per-mode leading
    left-singular basis, core = X times_n U_n^T."""
    ranks = tuple(ranks)
    factors = [_leading_basis(x, m, r) for m, r in enumerate(ranks)]
    core = tucker_ttm(x, factors, transpose=True)
    return {"core": core, "factors": factors}


def tucker_ttm(x: jnp.ndarray, factors, transpose: bool = False) -> jnp.ndarray:
    """Multilinear product X times_n U_n (or U_n^T) over all modes —
    Tensor Toolbox `ttm(X, U, 'all')`."""
    n = x.ndim
    tensor_spec = list(_LETTERS[:n])
    out_letters = _LETTERS[n : 2 * n]
    operands, specs = [x], ["".join(tensor_spec)]
    for ax, u in enumerate(factors):
        operands.append(u)
        if transpose:
            specs.append(f"{_LETTERS[ax]}{out_letters[ax]}")
        else:
            specs.append(f"{out_letters[ax]}{_LETTERS[ax]}")
    return jnp.einsum(
        ",".join(specs) + "->" + out_letters[:n], *operands, optimize="optimal"
    )


@functools.partial(jax.jit, static_argnames=("ranks", "max_iters", "tol"))
def _hooi_run(x, factors0, ranks, max_iters: int, tol: float):
    n = x.ndim
    norm_x = jnp.linalg.norm(x.ravel())

    def body(carry):
        factors, _fit, _delta, it = carry
        factors = list(factors)
        for mode in range(n):
            # Project all other modes, then take the leading basis of the
            # result's mode unfolding (`tucker_als.m` core iteration).
            proj = [
                factors[ax] if ax != mode else jnp.eye(x.shape[mode], dtype=x.dtype)
                for ax in range(n)
            ]
            y = tucker_ttm(x, proj, transpose=True)
            factors[mode] = _leading_basis(y, mode, ranks[mode])
        core = tucker_ttm(x, factors, transpose=True)
        # ||X - [core; U]||^2 = ||X||^2 - ||core||^2 for orthonormal U.
        resid_sq = jnp.maximum(norm_x**2 - jnp.sum(core**2), 0.0)
        fit = 1.0 - jnp.sqrt(resid_sq) / norm_x
        return tuple(factors), fit, jnp.abs(fit - _fit), it + 1

    def cond(carry):
        _factors, _fit, delta, it = carry
        return (it < max_iters) & (delta >= tol)

    init = (tuple(factors0), jnp.asarray(-jnp.inf, x.dtype), jnp.asarray(jnp.inf, x.dtype), jnp.asarray(0, jnp.int32))
    factors, fit, _delta, iters = jax.lax.while_loop(cond, body, init)
    core = tucker_ttm(x, list(factors), transpose=True)
    return core, list(factors), fit, iters


def tucker_hooi(
    x: jnp.ndarray,
    ranks,
    max_iters: int = 50,
    tol: float = 1e-4,
) -> dict:
    """Tucker decomposition by HOOI (`tucker_als.m` semantics: HOSVD init,
    per-mode projected leading basis, fit-change stop)."""
    ranks = tuple(int(r) for r in ranks)
    init = tucker_hosvd(x, ranks)["factors"]
    core, factors, fit, iters = _hooi_run(x, init, ranks, max_iters, tol)
    return {
        "core": core,
        "factors": factors,
        "fit": fit,
        "n_iters": iters,
    }
