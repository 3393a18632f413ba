"""JAX equivalents of the reference's two MEX proximal kernels.

The only native code in the reference lives in the TT-TRPCA vendored repo's
proximal-operator library (SURVEY §2.4):

  * `cappedsimplexprojection.cpp:1-185` — Euclidean projection onto the
    capped simplex {x : 0 <= x <= 1, sum x = s} (used by project_fantope.m).
  * `flsa.c` / `flsa.h` — Fused Lasso Signal Approximator
    min_x 0.5||x - v||^2 + lam1 ||x||_1 + lam2 ||D x||_1 via SFA on the dual.

Here both are jit'd JAX functions with static shapes: the simplex projection
is a monotone-threshold bisection (VPU-parallel), FLSA is FISTA on the
box-constrained TV dual followed by l1 shrinkage. Exact sequential C++
counterparts (mirroring the MEX semantics bit-for-bit on CPU) live in
:mod:`tritd_tpu.runtime`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .shrinkage import soft_threshold


@functools.partial(jax.jit, static_argnames=("iters",))
def capped_simplex_projection(
    v: jnp.ndarray, s: jnp.ndarray | float, iters: int = 64
) -> jnp.ndarray:
    """Project v onto {x : 0 <= x <= 1, sum(x) = s}.

    The KKT solution is x = clip(v - tau, 0, 1) with tau chosen so the sum
    constraint holds; phi(tau) = sum clip(v - tau, 0, 1) is monotone
    decreasing, so tau is found by bisection (64 iters ~ machine precision),
    replacing the MEX kernel's sorted breakpoint search with a fixed-trip
    jit-friendly loop."""
    v = jnp.asarray(v)
    s = jnp.asarray(s, v.dtype)
    lo = jnp.min(v) - 1.0
    hi = jnp.max(v)

    def body(_, bounds):
        lo, hi = bounds
        mid = 0.5 * (lo + hi)
        total = jnp.sum(jnp.clip(v - mid, 0.0, 1.0))
        too_big = total > s
        return (jnp.where(too_big, mid, lo), jnp.where(too_big, hi, mid))

    lo, hi = jax.lax.fori_loop(0, iters, body, (lo, hi))
    tau = 0.5 * (lo + hi)
    return jnp.clip(v - tau, 0.0, 1.0)


@functools.partial(jax.jit, static_argnames=("iters",))
def flsa(
    v: jnp.ndarray,
    lam1: jnp.ndarray | float,
    lam2: jnp.ndarray | float,
    iters: int = 200,
) -> jnp.ndarray:
    """Fused Lasso Signal Approximator on a 1-D signal.

    min_x 0.5||x - v||^2 + lam1||x||_1 + lam2 * sum_i |x[i+1] - x[i]|

    Decomposes (classically) as soft_threshold(tv_prox(v, lam2), lam1).
    The TV prox solves the dual max_{||z||_inf <= lam2} -0.5||v - D^T z||^2
    by FISTA with step 1/4 (||D D^T|| <= 4) — a fixed-trip, fully vectorized
    loop in place of the MEX kernel's sequential SFA recursion."""
    v = jnp.asarray(v)
    n = v.shape[0]
    lam1 = jnp.asarray(lam1, v.dtype)
    lam2 = jnp.asarray(lam2, v.dtype)

    def dt(z):  # D^T z, D the forward-difference operator (n-1, n)
        return jnp.concatenate([-z[:1], z[:-1] - z[1:], z[-1:]])

    def d(x):  # D x
        return x[1:] - x[:-1]

    z0 = jnp.zeros((n - 1,), v.dtype)

    def body(_, carry):
        z, y, t = carry
        grad = d(dt(y) - v)
        z_new = jnp.clip(y - 0.25 * grad, -lam2, lam2)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        y_new = z_new + ((t - 1.0) / t_new) * (z_new - z)
        return (z_new, y_new, t_new)

    z, _, _ = jax.lax.fori_loop(0, iters, body, (z0, z0, jnp.asarray(1.0, v.dtype)))
    x_tv = v - dt(z)
    return soft_threshold(x_tv, lam1)
