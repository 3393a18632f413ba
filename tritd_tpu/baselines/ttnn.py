"""TT-TRPCA ("TTNN") — tensor-train nuclear-norm robust PCA by ADMM.

Reference: `other_methods/Low-rank-tensor-train-for-tensor-robust-principal-
component-analysis-master/lib/TT_TRPCA.m:1-77`, with `weightTC.m` balanced
weights and the `SVT.m` truncation quirk (kept — see
:func:`tritd_tpu.ops.svt.svt_ref_compat`).

Per iteration: SVT on each of the N-1 sequential TT unfoldings of Z,
l1-shrink the sparse clone Y, closed-form joint (Z, S) solve, dual ascent,
1.1x penalty growth. Driver preset: lambda=50, f=5, gamma=1e-3, deta=2e-3
(`traffic_triple_comparison.m:116-120`).

Note: the unfoldings here use row-major reshapes; SVT is invariant under
the consistent row/column permutation relating them to MATLAB's column-major
reshapes, so results are identical.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from ..ops.shrinkage import soft_threshold
from ..ops.svt import (
    run_warm_blocks,
    svt_ref_compat,
    svt_ref_compat_warm,
    warm_spec,
    warm_unroll,
)


def weight_tc(nway: tuple[int, ...]) -> list[float]:
    """Balanced TT weights alpha_n = min(dimL, dimR) / sum (`weightTC.m`)."""
    n = len(nway)
    il = nway[0]
    lam = []
    for k in range(n - 1):
        ir = math.prod(nway[k + 1:])
        lam.append(min(il, ir))
        il *= nway[k + 1]
    total = sum(lam)
    return [v / total for v in lam]


@functools.partial(
    jax.jit,
    static_argnames=("lam", "f", "gamma0", "deta0", "max_iter", "has_origin", "svt_method"),
)
def _tt_trpca_run(
    x_noise, origin, lam, f, gamma0, deta0, max_iter, has_origin, svt_method="svd"
):
    nway = x_noise.shape
    n = len(nway)
    ncuts = n - 1
    alpha = weight_tc(nway)
    beta = [f * a for a in alpha]
    sum_beta = sum(beta)
    dim_l = [math.prod(nway[: m + 1]) for m in range(ncuts)]

    dtype = x_noise.dtype
    zeros = jnp.zeros(nway, dtype)
    norm_origin = jnp.linalg.norm(origin.ravel()) if has_origin else 1.0
    total = math.prod(nway)
    warm = svt_method.startswith("warm")
    if warm:
        # "warm:<K>": warm-started basis reuse on the big-thin-side TT cuts
        # (chicago's 5929x2016 cut pays a ~160 ms eigh per iteration on the
        # exact path) — same route/validation as RC-FCTN's
        # (ops/svt.py::svt_ref_compat_warm, tools/validate_warm_svt.py).
        warm_period, warm_idx, warm_thin = warm_spec(
            svt_method, [(d, total // d) for d in dim_l]
        )

    def body(k, carry, refresh=True):
        z, s, e, j, cs, bases, err_hist, rel_hist = carry
        # U_n: SVT on each sequential TT unfolding (`TT_TRPCA.m:45-48`)
        us = []
        bases_new = list(bases)
        for m in range(ncuts):
            mat = (z - cs[m] / beta[m]).reshape(dim_l[m], -1)
            if warm and m in warm_idx:
                w = warm_idx.index(m)
                mat, bases_new[w] = svt_ref_compat_warm(
                    mat, alpha[m] / beta[m], bases[w], refresh
                )
            else:
                mat = svt_ref_compat(
                    mat, alpha[m] / beta[m],
                    method="gram" if warm else svt_method,
                )
            us.append(mat.reshape(nway))
        gamma = gamma0 * 1.1**k
        deta = deta0 * 1.1**k
        # Y: l1 shrink of the sparse clone (`:51`)
        y = soft_threshold(s - j / deta, lam / deta)
        # closed-form joint (Z, S) solve (`:53-62`)
        temp = sum(beta[m] * (us[m] + cs[m] / beta[m]) for m in range(ncuts))
        ee = temp + gamma * (x_noise + e / gamma)
        ff = gamma * (x_noise + e / gamma) + deta * (y + j / deta)
        tt = gamma**2 - (sum_beta + gamma) * (gamma + deta)
        z_new = (gamma * ff - (gamma + deta) * ee) / tt
        s_new = (gamma * ee - (sum_beta + gamma) * ff) / tt
        # dual ascent (`:64-70`)
        cs_new = tuple(cs[m] + beta[m] * (us[m] - z_new) for m in range(ncuts))
        e = e + gamma * (x_noise - z_new - s_new)
        j = j + deta * (y - s_new)
        rel = jnp.linalg.norm((z_new - z).ravel()) / (
            jnp.linalg.norm(z.ravel()) + 1e-30
        )
        rel_hist = rel_hist.at[k].set(rel)
        if has_origin:
            err_hist = err_hist.at[k].set(
                jnp.linalg.norm((origin - z_new).ravel()) / norm_origin
            )
        return (z_new, s_new, e, j, cs_new, tuple(bases_new), err_hist, rel_hist)

    bases0 = (
        tuple(jnp.eye(t, dtype=dtype) for t in warm_thin) if warm else ()
    )
    carry0 = (
        zeros, zeros, zeros, zeros, tuple(zeros for _ in range(ncuts)), bases0,
        jnp.full((max_iter,), jnp.nan, dtype), jnp.full((max_iter,), jnp.nan, dtype),
    )
    if warm:
        out = run_warm_blocks(
            body, carry0, 0, max_iter, warm_period,
            unroll=warm_unroll([(d, total // d) for d in dim_l]),
        )
    else:
        out = jax.lax.fori_loop(0, max_iter, body, carry0)
    z, s, _, _, _, _, err_hist, rel_hist = out
    return z, s, err_hist, rel_hist


def tt_trpca(
    x_noise: jnp.ndarray,
    lam: float = 50.0,
    f: float = 5.0,
    gamma: float = 0.001,
    deta: float = 0.002,
    origin: jnp.ndarray | None = None,
    max_iter: int = 100,
    svt_method: str = "svd",
):
    """Returns (Z low-rank, S sparse, errHist vs origin, n_iters). The
    reference runs the full 100 iterations (its tol check is bypassed,
    `TT_TRPCA.m:40`). ``svt_method="gram"`` selects the Gram-eigh SVT
    (see ops/svt.py docstring for the precision trade)."""
    has_origin = origin is not None
    dummy = origin if has_origin else x_noise
    z, s, err_hist, _ = _tt_trpca_run(
        x_noise, dummy, lam, f, gamma, deta, max_iter, has_origin, svt_method
    )
    return z, s, err_hist, max_iter
