"""CP decomposition algorithm variants — the rest of the Tensor Toolbox v3.1
algorithm surface (SURVEY §2.3, ``Contents.m:17-50``): ``cp_apr`` (Poisson
multiplicative updates), ``cp_nmu`` (nonnegative Lee-Seung updates),
``cp_arls`` (randomized least squares), ``cp_opt`` / ``cp_wopt`` (direct /
weighted optimization) and ``gcp_opt`` (generalized losses).

Design decisions, shared across all of them:

* Khatri-Rao products are never materialized — the dense MTTKRP is one fused
  einsum (:func:`tritd_tpu.ops.decomp.mttkrp`); ``cp_arls`` gathers sampled
  factor rows instead (O(s·R) memory).
* Iteration bodies are ``lax.while_loop`` / ``lax.scan`` under ``jit`` with
  static shapes; convergence tests are traced scalars, not host round-trips.
* The optimization-based fits (`cp_opt`/`cp_wopt`/`gcp_opt`) use optax
  L-BFGS (the toolbox wraps Poblano/L-BFGS-B) with autodiff gradients —
  no hand-derived gradient code to keep in sync.

The originals live at ``other_methods/tensor_toolbox-v3.1/{cp_apr,cp_nmu,
cp_arls,cp_opt,cp_wopt,gcp_opt}.m``; semantics notes cite specific lines.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import optax

from .decomp import mttkrp
from .kruskal import cp_normalize, ktensor_full


def _hadamard_gram(factors, mode: int, rank: int, dtype):
    g = jnp.ones((rank, rank), dtype)
    for ax, u in enumerate(factors):
        if ax != mode:
            g = g * (u.T @ u)
    return g


def _fit(x, factors, norm_x):
    """1 - ||X - [[U]]||/||X|| without materializing the full tensor."""
    rank = factors[0].shape[1]
    g = jnp.ones((rank, rank), x.dtype)
    for u in factors:
        g = g * (u.T @ u)
    inner = jnp.sum(mttkrp(x, factors, x.ndim - 1) * factors[-1])
    resid_sq = jnp.maximum(norm_x**2 + jnp.sum(g) - 2.0 * inner, 0.0)
    return 1.0 - jnp.sqrt(resid_sq) / norm_x


def _uniform_init(key, shape, rank, dtype):
    keys = jax.random.split(key, len(shape))
    return [jax.random.uniform(k, (s, rank), dtype) for k, s in zip(keys, shape)]


# ------------------------------------------------------------------- cp_nmu


@functools.partial(jax.jit, static_argnames=("rank", "max_iters", "tol"))
def _cp_nmu_run(x, factors0, rank, max_iters, tol):
    n = x.ndim
    norm_x = jnp.linalg.norm(x.ravel())
    eps = jnp.asarray(1e-12, x.dtype)

    def body(carry):
        factors, _fit_prev, _delta, it = carry
        factors = list(factors)
        for mode in range(n):
            num = mttkrp(x, factors, mode)
            den = factors[mode] @ _hadamard_gram(factors, mode, rank, x.dtype)
            # Lee-Seung multiplicative update (`cp_nmu.m` inner loop:
            # "B = B .* (mttkrp ./ (B * hadamard + eps))"), nonnegativity
            # preserved because the iterate and both terms are nonnegative.
            factors[mode] = factors[mode] * (num / (den + eps))
        f = _fit(x, factors, norm_x)
        return tuple(factors), f, jnp.abs(f - _fit_prev), it + 1

    def cond(carry):
        return (carry[3] < max_iters) & (carry[2] >= tol)

    init = (
        tuple(factors0),
        jnp.asarray(-jnp.inf, x.dtype),
        jnp.asarray(jnp.inf, x.dtype),
        jnp.asarray(0, jnp.int32),
    )
    factors, fit, _d, iters = jax.lax.while_loop(cond, body, init)
    return list(factors), fit, iters


def cp_nmu(x, rank, max_iters=200, tol=1e-5, key=None, init_factors=None):
    """Nonnegative CP by multiplicative updates — ``cp_nmu.m`` semantics
    (Lee-Seung step with an epsilon-guarded denominator, fit-change stop).
    Input must be elementwise nonnegative. Returns the same dict shape as
    :func:`tritd_tpu.ops.decomp.cp_als`."""
    if key is None:
        key = jax.random.PRNGKey(0)
    if init_factors is None:
        init_factors = _uniform_init(key, x.shape, rank, x.dtype)
    factors, fit, iters = _cp_nmu_run(x, init_factors, rank, max_iters, tol)
    factors, weights = cp_normalize(factors)
    return {"weights": weights, "factors": factors, "fit": fit, "n_iters": iters}


# ------------------------------------------------------------------- cp_apr


def _l1_normalize(u, eps):
    s = jnp.sum(u, axis=0)
    safe = jnp.where(s > eps, s, 1.0)
    return u / safe, jnp.where(s > eps, s, 0.0)


@functools.partial(
    jax.jit, static_argnames=("rank", "max_outer", "max_inner", "tol")
)
def _cp_apr_run(x, factors0, rank, max_outer, max_inner, tol):
    n = x.ndim
    eps = jnp.asarray(1e-10, x.dtype)

    # Start from the toolbox's invariant: all factor columns l1-normalized,
    # magnitudes absorbed into the weight vector (`cp_apr.m` "M =
    # normalize(Minit,[],1)"). The l1 structure is what makes the KL
    # multiplicative update a fixed-point iteration: the implicit Khatri-Rao
    # of the OTHER modes then has unit column sums.
    factors0 = list(factors0)
    lam0 = jnp.ones((rank,), x.dtype)
    for ax in range(n):
        factors0[ax], s = _l1_normalize(factors0[ax], eps)
        lam0 = lam0 * s

    def outer(carry):
        factors, lam, _kkt_prev, it = carry
        factors = list(factors)
        kkt = jnp.asarray(0.0, x.dtype)
        for mode in range(n):
            # redistribute(M, n): absorb the weights into this mode's factor
            # (`cp_apr.m` "M = redistribute(M,n)").
            b = factors[mode] * lam[None, :]

            def inner(_i, b):
                fs = [b if ax == mode else factors[ax] for ax in range(n)]
                m = ktensor_full(fs)
                # Phi = (X_(n) ./ max(B Pi^T, eps)) Pi as one MTTKRP of the
                # ratio tensor (`cp_apr.m` "calculatePhi").
                phi = mttkrp(x / jnp.maximum(m, eps), fs, mode)
                return b * phi

            b = jax.lax.fori_loop(0, max_inner, inner, b)
            # KKT violation at the updated mode (`cp_apr.m`
            # "kktModeViolations(n) = max|min(B, 1 - Phi)|").
            fs = [b if ax == mode else factors[ax] for ax in range(n)]
            m = ktensor_full(fs)
            phi = mttkrp(x / jnp.maximum(m, eps), fs, mode)
            kkt = jnp.maximum(kkt, jnp.max(jnp.abs(jnp.minimum(b, 1.0 - phi))))
            # normalize(M,[],1,n): pull the column sums back into lambda.
            factors[mode], lam = _l1_normalize(b, eps)
        return tuple(factors), lam, kkt, it + 1

    def cond(carry):
        return (carry[3] < max_outer) & (carry[2] >= tol)

    init = (
        tuple(factors0),
        lam0,
        jnp.asarray(jnp.inf, x.dtype),
        jnp.asarray(0, jnp.int32),
    )
    factors, lam, kkt, iters = jax.lax.while_loop(cond, outer, init)
    factors = list(factors)
    factors[0] = factors[0] * lam[None, :]
    # Poisson log-likelihood (`tt_loglikelihood.m`): sum(X .* log(M) - M).
    m = jnp.maximum(ktensor_full(factors), eps)
    ll = jnp.sum(x * jnp.log(m) - m)
    return factors, kkt, ll, iters


def cp_apr(x, rank, max_outer=100, max_inner=10, tol=1e-4, key=None, init_factors=None):
    """Nonnegative CP for count data by Alternating Poisson Regression with
    multiplicative updates — ``cp_apr.m`` (default 'mu' method) semantics:
    per-mode inner MU sweeps ``B .*= MTTKRP(X ./ max(M, eps))``, KKT-violation
    stopping, Poisson log-likelihood reporting. Returns dict with `weights`,
    `factors`, `kkt_violation`, `log_likelihood`, `n_iters`."""
    if key is None:
        key = jax.random.PRNGKey(0)
    if init_factors is None:
        init_factors = _uniform_init(key, x.shape, rank, x.dtype)
    factors, kkt, ll, iters = _cp_apr_run(
        x, init_factors, rank, max_outer, max_inner, tol
    )
    factors, weights = cp_normalize(factors)
    return {
        "weights": weights,
        "factors": factors,
        "kkt_violation": kkt,
        "log_likelihood": ll,
        "n_iters": iters,
    }


# ------------------------------------------------------------------ cp_arls


@functools.partial(
    jax.jit, static_argnames=("rank", "n_samples", "max_iters", "tol")
)
def _cp_arls_run(x, factors0, key, rank, n_samples, max_iters, tol):
    n = x.ndim
    norm_x = jnp.linalg.norm(x.ravel())
    eye = jnp.eye(rank, dtype=x.dtype)
    # Precompute per-mode unfoldings once (transposes are free reshapes for
    # XLA; gathers below index rows of these).
    unfs = []
    for mode in range(n):
        perm = (mode,) + tuple(ax for ax in range(n) if ax != mode)
        unfs.append(jnp.transpose(x, perm).reshape(x.shape[mode], -1))

    def body(carry):
        factors, fit_prev, _delta, it, k = carry
        factors = list(factors)
        k, sub = jax.random.split(k)
        for mode in range(n):
            others = [ax for ax in range(n) if ax != mode]
            kks = jax.random.split(jax.random.fold_in(sub, mode), len(others))
            # Sample s multi-indices over the other modes (uniform with
            # replacement — `cp_arls.m` "dense_sample_krp"); the sampled
            # Khatri-Rao rows are the Hadamard product of gathered factor
            # rows, O(s·R) memory.
            idx = [
                jax.random.randint(kk, (n_samples,), 0, x.shape[ax])
                for kk, ax in zip(kks, others)
            ]
            zs = jnp.ones((n_samples, rank), x.dtype)
            for i, ax in enumerate(others):
                zs = zs * factors[ax][idx[i]]
            # Columns of unfold(x, mode) at the sampled multi-indices
            # (row-major flattening over the remaining modes).
            flat = jnp.zeros((n_samples,), jnp.int32)
            for i, ax in enumerate(others):
                flat = flat * x.shape[ax] + idx[i]
            xs = unfs[mode][:, flat]  # (n_mode, s)
            g = zs.T @ zs
            rhs = xs @ zs
            jitter = 32 * jnp.finfo(x.dtype).eps * (jnp.trace(g) / rank + 1.0)
            cho = jax.scipy.linalg.cho_factor(g + jitter * eye, lower=True)
            factors[mode] = jax.scipy.linalg.cho_solve(cho, rhs.T).T
        f = _fit(x, factors, norm_x)
        return tuple(factors), f, jnp.abs(f - fit_prev), it + 1, k

    def cond(carry):
        return (carry[3] < max_iters) & (carry[2] >= tol)

    init = (
        tuple(factors0),
        jnp.asarray(-jnp.inf, x.dtype),
        jnp.asarray(jnp.inf, x.dtype),
        jnp.asarray(0, jnp.int32),
        key,
    )
    factors, fit, _d, iters, _k = jax.lax.while_loop(cond, body, init)
    return list(factors), fit, iters


def cp_arls(x, rank, n_samples=None, max_iters=50, tol=1e-4, key=None, init_factors=None):
    """CP by Alternating Randomized Least Squares — ``cp_arls.m`` semantics:
    each mode solve uses `n_samples` uniformly sampled rows of the implicit
    Khatri-Rao system (default 10·R·log(R+1), the toolbox's heuristic scale)
    instead of the full normal equations. The FJLT mixing step of the paper
    is omitted (the toolbox also defaults to ``'mix', false`` for dense
    inputs); sampling is with replacement."""
    if key is None:
        key = jax.random.PRNGKey(0)
    k_init, k_run = jax.random.split(key)
    if n_samples is None:
        import math

        n_samples = max(int(10 * rank * math.log(rank + 1.0)), 4 * rank)
    if init_factors is None:
        init_factors = _uniform_init(k_init, x.shape, rank, x.dtype)
    factors, fit, iters = _cp_arls_run(
        x, init_factors, k_run, rank, int(n_samples), max_iters, tol
    )
    factors, weights = cp_normalize(factors)
    return {"weights": weights, "factors": factors, "fit": fit, "n_iters": iters}


# -------------------------------------------------------- cp_opt / cp_wopt


def _lbfgs_fit(loss_fn, params0, max_iters: int, tol: float):
    opt = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(loss_fn)

    @jax.jit
    def run(params0):
        state0 = opt.init(params0)

        def body(carry):
            params, state, _prev, it = carry
            value, grad = value_and_grad(params, state=state)
            updates, state = opt.update(
                grad, state, params, value=value, grad=grad, value_fn=loss_fn
            )
            params = optax.apply_updates(params, updates)
            return params, state, value, it + 1

        def cond(carry):
            params, state, prev, it = carry
            value = optax.tree_utils.tree_get(state, "value")
            done = jnp.abs(value - prev) < tol * jnp.maximum(jnp.abs(prev), 1.0)
            return (it < max_iters) & ~(done & (it > 1))

        init = (
            params0,
            state0,
            jnp.asarray(jnp.inf, jnp.float32),
            jnp.asarray(0, jnp.int32),
        )
        params, state, _v, iters = jax.lax.while_loop(cond, body, init)
        return params, loss_fn(params), iters

    return run(params0)


def cp_opt(x, rank, max_iters=200, tol=1e-8, key=None, init_factors=None):
    """CP by direct optimization — ``cp_opt.m`` semantics: minimize
    ``||X - [[U_1..U_N]]||²`` over all factors jointly with L-BFGS
    (the toolbox delegates to Poblano's limited-memory BFGS; here optax
    L-BFGS with autodiff gradients — same normal-equation-free objective,
    ``cp_fg.m``'s function/gradient pair obtained by AD instead)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    if init_factors is None:
        keys = jax.random.split(key, x.ndim)
        init_factors = [
            jax.random.normal(k, (s, rank), x.dtype) * 0.1
            for k, s in zip(keys, x.shape)
        ]
    norm_x_sq = float(jnp.sum(jnp.asarray(x) ** 2))

    def loss(factors):
        resid = x - ktensor_full(list(factors))
        return jnp.sum(resid**2) / norm_x_sq

    params, final_loss, iters = _lbfgs_fit(loss, tuple(init_factors), max_iters, tol)
    factors, weights = cp_normalize(list(params))
    fit = 1.0 - jnp.sqrt(jnp.maximum(final_loss, 0.0))
    return {"weights": weights, "factors": factors, "fit": fit, "n_iters": iters}


def cp_wopt(x, w, rank, max_iters=200, tol=1e-8, key=None, init_factors=None):
    """Weighted CP optimization — ``cp_wopt.m`` semantics: minimize
    ``||W .* (X - [[U]])||²`` (W a {0,1} or general weight tensor; the
    toolbox's dense 'normal' method). The standard tensor-completion CP
    fit; zero-weight entries never influence the factors."""
    if key is None:
        key = jax.random.PRNGKey(0)
    if init_factors is None:
        keys = jax.random.split(key, x.ndim)
        init_factors = [
            jax.random.normal(k, (s, rank), x.dtype) * 0.1
            for k, s in zip(keys, x.shape)
        ]
    wx = w * x
    denom = float(jnp.sum(wx**2)) or 1.0

    def loss(factors):
        resid = wx - w * ktensor_full(list(factors))
        return jnp.sum(resid**2) / denom

    params, final_loss, iters = _lbfgs_fit(loss, tuple(init_factors), max_iters, tol)
    factors, weights = cp_normalize(list(params))
    fit = 1.0 - jnp.sqrt(jnp.maximum(final_loss, 0.0))
    return {"weights": weights, "factors": factors, "fit": fit, "n_iters": iters}


# ------------------------------------------------------------------ gcp_opt

#: Generalized CP losses — ``gcp_opt.m`` 'type' table (f(x, m), link
#: constraint): each entry maps to (elementwise loss, lower bound on the
#: model entries). Names follow the toolbox.
GCP_LOSSES = {
    # Gaussian: (m - x)^2
    "normal": (lambda x, m: (m - x) ** 2, None),
    # Poisson with identity link: m - x log m
    "count": (lambda x, m: m - x * jnp.log(jnp.maximum(m, 1e-10)), 0.0),
    # Poisson with log link: exp(m) - x m
    "poisson-log": (lambda x, m: jnp.exp(m) - x * m, None),
    # Bernoulli odds: log(m + 1) - x log m
    "binary": (
        lambda x, m: jnp.log(m + 1.0) - x * jnp.log(jnp.maximum(m, 1e-10)),
        0.0,
    ),
    # Bernoulli logit: log(1 + exp(m)) - x m
    "bernoulli-logit": (lambda x, m: jnp.logaddexp(0.0, m) - x * m, None),
    # Rayleigh: 2 log m + (pi/4)(x/m)^2
    "rayleigh": (
        lambda x, m: 2.0 * jnp.log(jnp.maximum(m, 1e-10))
        + (jnp.pi / 4.0) * (x / jnp.maximum(m, 1e-10)) ** 2,
        0.0,
    ),
    # Huber (delta=0.25, the toolbox default parameterization)
    "huber": (
        lambda x, m: jnp.where(
            jnp.abs(x - m) < 0.25, (x - m) ** 2, 0.5 * jnp.abs(x - m) - 0.0625
        ),
        None,
    ),
}


def gcp_opt(
    x,
    rank,
    loss: str = "normal",
    mask=None,
    max_iters: int = 500,
    learning_rate: float = 0.01,
    tol: float = 1e-9,
    key=None,
    init_factors=None,
):
    """Generalized CP with a user-specified elementwise loss — ``gcp_opt.m``
    semantics (loss table above = its 'type' option; `mask` = its missing-
    data weight tensor). Dense path fits with Adam (the toolbox's dense
    default is L-BFGS-B and its stochastic default Adam; Adam here covers
    both at jit-friendly fixed iteration shapes), lower-bounded losses are
    enforced by projection after each step, exactly like the toolbox's
    bound constraint."""
    if loss not in GCP_LOSSES:
        raise ValueError(f"unknown loss {loss!r}; options: {sorted(GCP_LOSSES)}")
    loss_fn, lower = GCP_LOSSES[loss]
    if key is None:
        key = jax.random.PRNGKey(0)
    if init_factors is None:
        keys = jax.random.split(key, x.ndim)
        scale = 0.1 if lower is None else 0.5
        init_factors = [
            scale * jax.random.uniform(k, (s, rank), x.dtype) + (0.01 if lower is not None else 0.0)
            for k, s in zip(keys, x.shape)
        ]
        if lower is None:
            init_factors = [
                jax.random.normal(k, (s, rank), x.dtype) * 0.1
                for k, s in zip(keys, x.shape)
            ]
    w = jnp.ones_like(x) if mask is None else mask.astype(x.dtype)
    n_obs = jnp.maximum(jnp.sum(w), 1.0)

    def objective(factors):
        m = ktensor_full(list(factors))
        return jnp.sum(w * loss_fn(x, m)) / n_obs

    opt = optax.adam(learning_rate)

    @jax.jit
    def run(params0):
        state0 = opt.init(params0)

        def body(carry):
            params, state, prev, _delta, it = carry
            value, grad = jax.value_and_grad(objective)(params)
            updates, state = opt.update(grad, state, params)
            params = optax.apply_updates(params, updates)
            if lower is not None:
                params = tuple(jnp.maximum(p, lower + 1e-6) for p in params)
            return params, state, value, jnp.abs(value - prev), it + 1

        def cond(carry):
            return (carry[4] < max_iters) & (carry[3] >= tol)

        init = (
            params0,
            state0,
            jnp.asarray(jnp.inf, x.dtype),
            jnp.asarray(jnp.inf, x.dtype),
            jnp.asarray(0, jnp.int32),
        )
        params, _s, value, _d, iters = jax.lax.while_loop(cond, body, init)
        return params, value, iters

    params, final_obj, iters = run(tuple(init_factors))
    factors, weights = cp_normalize(list(params))
    return {
        "weights": weights,
        "factors": factors,
        "objective": final_obj,
        "n_iters": iters,
    }
