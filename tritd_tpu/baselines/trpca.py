"""t-SVD and sum-of-nuclear-norms tensor RPCA competitors.

Reference: `other_methods/Low-rank-...-master/lib/compete_methods/
{trpca_tnn.m, trpca_snn.m}` with `proximal_operator/prox_tnn.m` (FFT along
mode 3 + per-frontal-slice SVT) — vendored in the TT-TRPCA repo and
exercised by its `Demo_TRPCA.m`; part of the SURVEY §2.3 inventory.

Notes: the tubal prox is a batched complex SVD in the FFT domain
(vmapped over frontal slices — one batched kernel instead of the MATLAB
per-slice loop); conjugate symmetry of the real FFT means the result of the
inverse FFT is real up to roundoff (we take .real like MATLAB's ifft on the
reconstructed symmetric spectrum).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops.shrinkage import prox_l1
from ..ops.svt import svt_ref_compat


def prox_tnn(y: jnp.ndarray, rho: jnp.ndarray | float) -> jnp.ndarray:
    """Proximal operator of the tensor nuclear norm (t-SVD, `prox_tnn.m`):
    FFT along mode 3, soft-threshold singular values of every frontal slice,
    inverse FFT."""
    yf = jnp.fft.fft(y, axis=2)
    slices = jnp.moveaxis(yf, 2, 0)  # (n3, n1, n2) complex

    def shrink(m):
        u, s, vh = jnp.linalg.svd(m, full_matrices=False)
        s = jnp.maximum(s - rho, 0.0)
        return (u * s[None, :].astype(u.dtype)) @ vh

    xf = jax.vmap(shrink)(slices)
    x = jnp.fft.ifft(jnp.moveaxis(xf, 0, 2), axis=2)
    return jnp.real(x)


@functools.partial(
    jax.jit, static_argnames=("lam", "mu0", "rho", "max_mu", "max_iter", "has_origin")
)
def _trpca_tnn_run(x, origin, lam, mu0, rho, max_mu, max_iter, has_origin):
    dim = x.shape
    zeros = jnp.zeros(dim, x.dtype)
    norm_origin = jnp.linalg.norm(origin.ravel()) if has_origin else 1.0

    def body(it, carry):
        l, s, y, err_hist = carry
        mu = jnp.minimum(mu0 * rho**it, max_mu)
        l = prox_tnn(-s + x - y / mu, 1.0 / mu)
        s = prox_l1(-l + x - y / mu, lam / mu)
        dy = l + s - x
        y = y + mu * dy
        if has_origin:
            err_hist = err_hist.at[it].set(
                jnp.linalg.norm((origin - l).ravel()) / norm_origin
            )
        return (l, s, y, err_hist)

    carry0 = (zeros, zeros, zeros, jnp.full((max_iter,), jnp.nan, x.dtype))
    l, s, _, err_hist = jax.lax.fori_loop(0, max_iter, body, carry0)
    return l, s, err_hist


def trpca_tnn(
    x: jnp.ndarray,
    lam: float | None = None,
    origin: jnp.ndarray | None = None,
    mu: float = 1e-4,
    rho: float = 1.1,
    max_mu: float = 1e10,
    max_iter: int = 100,
):
    """TNN tensor RPCA: min ||L||_* + lam ||S||_1 s.t. X = L + S
    (`trpca_tnn.m`, defaults lambda = 1/sqrt(max(n1,n2)*n3))."""
    n1, n2, n3 = x.shape
    if lam is None:
        lam = 1.0 / (max(n1, n2) * n3) ** 0.5
    has_origin = origin is not None
    dummy = origin if has_origin else x
    return _trpca_tnn_run(
        x, dummy, float(lam), float(mu), float(rho), float(max_mu),
        int(max_iter), has_origin,
    )


@functools.partial(
    jax.jit, static_argnames=("alpha", "mu0", "rho", "max_mu", "max_iter")
)
def _trpca_snn_run(x, alpha, mu0, rho, max_mu, max_iter):
    dim = x.shape
    k = len(dim)
    zeros = jnp.zeros(dim, x.dtype)
    norm_x = jnp.linalg.norm(x.ravel())

    def unfold_i(t, i):
        return jnp.moveaxis(t, i, 0).reshape(dim[i], -1)

    def fold_i(m, i):
        shp = (dim[i],) + tuple(d for j, d in enumerate(dim) if j != i)
        return jnp.moveaxis(m.reshape(shp), 0, i)

    def body(it, carry):
        ls, e, ys, err_hist = carry
        mu = jnp.minimum(mu0 * rho**it, max_mu)
        new_ls = []
        sumtemp = zeros
        for i in range(k):
            li = fold_i(
                svt_ref_compat(unfold_i(x - e - ys[i] / mu, i), alpha[i] / mu), i
            )
            new_ls.append(li)
            sumtemp = sumtemp + li + ys[i] / mu
        e = prox_l1(x - sumtemp / k, 1.0 / (mu * k))
        sum_err = zeros
        new_ys = []
        for i in range(k):
            dy = new_ls[i] + e - x
            sum_err = sum_err + dy
            new_ys.append(ys[i] + mu * dy)
        err_hist = err_hist.at[it].set(jnp.linalg.norm(sum_err.ravel()) / norm_x)
        return (tuple(new_ls), e, tuple(new_ys), err_hist)

    carry0 = (
        tuple(zeros for _ in range(k)), zeros, tuple(zeros for _ in range(k)),
        jnp.full((max_iter,), jnp.nan, x.dtype),
    )
    ls, e, _, err_hist = jax.lax.fori_loop(0, max_iter, body, carry0)
    return ls[0], e, err_hist


def trpca_snn(
    x: jnp.ndarray,
    alpha=None,
    mu: float = 1e-4,
    rho: float = 1.1,
    max_mu: float = 1e10,
    max_iter: int = 100,
):
    """Sum-of-nuclear-norms (HoRPCA) tensor RPCA (`trpca_snn.m`): per-mode
    SVT (with the reference's SVT truncation quirk) + shared l1 sparse part.
    Returns (L of mode 1 — the reference's `L = L{1}` —, E, errHist)."""
    if alpha is None:
        alpha = tuple(1.0 for _ in x.shape)
    return _trpca_snn_run(
        x, tuple(float(a) for a in alpha), float(mu), float(rho),
        float(max_mu), int(max_iter),
    )
