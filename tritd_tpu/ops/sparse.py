"""Sparse (COO) tensor operations — the Tensor Toolbox ``@sptensor`` /
``@sptenmat`` class surface (SURVEY §2.3: class dirs ``@sptensor`` 3,732 LoC,
``@sptenmat`` 737 LoC of ``other_methods/tensor_toolbox-v3.1``), rebuilt
for XLA.

Design: a sparse tensor is the functional triple ``(vals, coords, shape)``
with ``vals: (nnz,)`` and ``coords: (nnz, N)`` int32 — *static* nnz, so every
operation below is jittable with fixed shapes (XLA requirement).  There is no
class; functions take/return the triple.  Where MATLAB's class dispatches
(``full``, ``norm``, ``ttv``, ``mttkrp``, ``double(sptenmat(...))``), a
function of the same name lives here.

Zero-entries convention: duplicate coordinates accumulate (MATLAB sptensor
constructor sums duplicates); explicit zeros are allowed and harmless (they
contribute nothing).  Out-of-range coordinates are a caller error; in jit we
cannot raise, so constructors that generate coordinates guarantee validity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sp_full(vals: jnp.ndarray, coords: jnp.ndarray, shape) -> jnp.ndarray:
    """Dense tensor from COO — ``full(sptensor)``. Duplicates accumulate."""
    shape = tuple(int(s) for s in shape)
    flat_idx = sp_sub2ind(coords, shape)
    total = 1
    for s in shape:
        total *= s  # python-level: shape is static, keeps this jit-safe
    out = jnp.zeros((total,), vals.dtype)
    out = out.at[flat_idx].add(vals)
    return out.reshape(shape)


def sp_sub2ind(coords: jnp.ndarray, shape) -> jnp.ndarray:
    """Row-major linear indices from (nnz, N) subscripts — ``tt_sub2ind``
    semantics under this framework's row-major convention (the MATLAB
    original is column-major; the convention is documented once in
    ops/fold.py and applied uniformly)."""
    shape = tuple(int(s) for s in shape)
    strides = []
    acc = 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= s
    strides = jnp.asarray(strides[::-1], coords.dtype)
    return (coords * strides[None, :]).sum(axis=1)


def sp_ind2sub(idx: jnp.ndarray, shape) -> jnp.ndarray:
    """(nnz, N) subscripts from row-major linear indices — ``tt_ind2sub``."""
    shape = tuple(int(s) for s in shape)
    subs = []
    rem = idx
    for s in reversed(shape):
        subs.append(rem % s)
        rem = rem // s
    return jnp.stack(subs[::-1], axis=1)


def sptenrand(key: jax.Array, shape, nnz: int, dtype=jnp.float32):
    """Random sparse tensor — ``sptenrand(sz, nnz)``: `nnz` uniform values at
    uniform coordinates (collisions accumulate, as the MATLAB constructor
    sums duplicate subscripts). Returns ``(vals, coords, shape)``."""
    shape = tuple(int(s) for s in shape)
    k1, k2 = jax.random.split(key)
    total = 1
    for s in shape:
        total *= s
    flat = jax.random.randint(k1, (nnz,), 0, total, jnp.int32)
    coords = sp_ind2sub(flat, shape)
    vals = jax.random.uniform(k2, (nnz,), dtype)
    return vals, coords, shape


def sptendiag(v: jnp.ndarray, shape=None):
    """Sparse tensor with `v` on the superdiagonal — ``sptendiag(v, sz)``."""
    n = int(v.shape[0])
    if shape is None:
        shape = (n, n, n)
    shape = tuple(int(s) for s in shape)
    idx = jnp.arange(n, dtype=jnp.int32)
    coords = jnp.stack([idx] * len(shape), axis=1)
    return v, coords, shape


def sp_norm(vals: jnp.ndarray, coords: jnp.ndarray, shape) -> jnp.ndarray:
    """Frobenius norm — ``norm(sptensor)``. Correct even with duplicate
    coordinates (they must be summed before squaring)."""
    flat_idx = sp_sub2ind(coords, shape)
    # segment-sum duplicates into a dense accumulation only over touched
    # slots: sort by index, add within equal runs.
    total = 1
    for s in shape:
        total *= int(s)
    if total <= 4 * vals.shape[0]:
        return jnp.linalg.norm(sp_full(vals, coords, shape).ravel())
    order = jnp.argsort(flat_idx)
    si, sv = flat_idx[order], vals[order]
    # ownership: each run of equal indices collapses onto its first slot
    seg = jnp.cumsum(
        jnp.concatenate([jnp.zeros((1,), jnp.int32), (si[1:] != si[:-1]).astype(jnp.int32)])
    )
    summed = jnp.zeros_like(sv).at[seg].add(sv)
    return jnp.linalg.norm(summed)


def sp_innerprod(vals, coords, shape, dense: jnp.ndarray) -> jnp.ndarray:
    """<sparse, dense> — ``innerprod(sptensor, tensor)``: gather + dot,
    O(nnz) instead of densifying."""
    flat_idx = sp_sub2ind(coords, shape)
    return jnp.dot(vals, dense.ravel()[flat_idx])


def sp_ttv(vals, coords, shape, vecs, modes) -> jnp.ndarray:
    """Sparse tensor times vector(s) in the given modes — ``ttv(sptensor,
    v, n)``: scale each nonzero by the gathered vector entries, then
    scatter-add over the contracted modes. Returns a DENSE tensor on the
    remaining modes (matching ``full(ttv(...))``)."""
    modes = tuple(int(m) for m in modes)
    scaled = vals
    for v, m in zip(vecs, modes):
        scaled = scaled * v[coords[:, m]]
    keep = tuple(ax for ax in range(len(shape)) if ax not in modes)
    if not keep:
        return jnp.sum(scaled)
    out_shape = tuple(int(shape[ax]) for ax in keep)
    out_coords = coords[:, jnp.array(keep)]
    return sp_full(scaled, out_coords, out_shape)


def sp_mttkrp(vals, coords, shape, factors, mode: int) -> jnp.ndarray:
    """Sparse MTTKRP — ``mttkrp(sptensor, U, n)``: for each nonzero, the
    Hadamard product of the other modes' factor rows, scatter-added into the
    mode's rows. O(nnz * R) FLOPs and memory traffic; never materializes the
    Khatri-Rao product or the dense tensor. This is the kernel sparse CP-ALS
    (``cp_als`` on sptensor inputs) is built on."""
    n = len(shape)
    r = factors[0].shape[1]
    rows = vals[:, None] * jnp.ones((1, r), vals.dtype)
    for ax in range(n):
        if ax == mode:
            continue
        rows = rows * factors[ax][coords[:, ax]]
    out = jnp.zeros((int(shape[mode]), r), vals.dtype)
    return out.at[coords[:, mode]].add(rows)


def sptenmat(vals, coords, shape, row_modes, col_modes=None):
    """Sparse matricization — ``sptenmat``: returns COO matrix
    ``(vals, (row_idx, col_idx), (n_rows, n_cols))`` with the same
    row-major flattening convention as :func:`tritd_tpu.ops.kruskal.tenmat`."""
    n = len(shape)
    row_modes = tuple(int(m) for m in row_modes)
    if col_modes is None:
        col_modes = tuple(m for m in range(n) if m not in row_modes)
    else:
        col_modes = tuple(int(m) for m in col_modes)
    row_shape = tuple(int(shape[m]) for m in row_modes)
    col_shape = tuple(int(shape[m]) for m in col_modes)
    ridx = sp_sub2ind(coords[:, jnp.array(row_modes)], row_shape)
    cidx = (
        sp_sub2ind(coords[:, jnp.array(col_modes)], col_shape)
        if col_modes
        else jnp.zeros_like(ridx)
    )
    n_rows = 1
    for s in row_shape:
        n_rows *= s
    n_cols = 1
    for s in col_shape:
        n_cols *= s
    return vals, (ridx, cidx), (n_rows, n_cols)


def sp_elemwise(vals, coords, shape, fn) -> tuple:
    """Apply an elementwise function that maps 0 -> 0 to the nonzeros —
    the sptensor arithmetic surface (``times``, ``abs``, ``power`` etc.)
    collapsed to its one sound primitive."""
    return fn(vals), coords, shape


def cp_als_sparse(
    vals,
    coords,
    shape,
    rank: int,
    max_iters: int = 50,
    tol: float = 1e-4,
    key=None,
    init_factors=None,
):
    """CP-ALS on a sparse tensor — ``cp_als(sptensor, R)``: identical update
    equations to the dense path (``cp_als.m``; see
    :func:`tritd_tpu.ops.decomp.cp_als`) with the MTTKRP swapped for the
    O(nnz·R) sparse kernel and the fit computed from nnz-local quantities
    (||X||² = Σ vals², <X, M> via gathered model rows) — the dense tensor
    never materializes, so memory is O(nnz·R + Σnᵢ·R)."""
    import functools

    from .kruskal import cp_normalize

    if key is None:
        key = jax.random.PRNGKey(0)
    if init_factors is None:
        keys = jax.random.split(key, len(shape))
        init_factors = [
            jax.random.uniform(k, (s, rank), vals.dtype)
            for k, s in zip(keys, shape)
        ]

    n = len(shape)

    @functools.partial(jax.jit, static_argnames=("max_iters", "tol"))
    def run(vals, coords, factors0, max_iters: int, tol: float):
        # duplicate-aware ||X||: duplicate coordinates accumulate (module
        # convention, and sptenrand produces them), so ||vals||_2 would be
        # wrong — sum within equal-index runs first, exactly like sp_norm.
        norm_x = sp_norm(vals, coords, shape)
        eye = jnp.eye(rank, dtype=vals.dtype)

        def model_at_nonzeros(factors):
            rows = jnp.ones((vals.shape[0], rank), vals.dtype)
            for ax in range(n):
                rows = rows * factors[ax][coords[:, ax]]
            return rows.sum(axis=1)

        def body(carry):
            factors, fit_prev, _delta, it = carry
            factors = list(factors)
            for mode in range(n):
                rhs = sp_mttkrp(vals, coords, shape, factors, mode)
                g = jnp.ones((rank, rank), vals.dtype)
                for ax in range(n):
                    if ax != mode:
                        g = g * (factors[ax].T @ factors[ax])
                jitter = 32 * jnp.finfo(vals.dtype).eps * (jnp.trace(g) / rank + 1.0)
                cho = jax.scipy.linalg.cho_factor(g + jitter * eye, lower=True)
                factors[mode] = jax.scipy.linalg.cho_solve(cho, rhs.T).T
            g_all = jnp.ones((rank, rank), vals.dtype)
            for u in factors:
                g_all = g_all * (u.T @ u)
            inner = jnp.dot(vals, model_at_nonzeros(factors))
            resid_sq = jnp.maximum(norm_x**2 + jnp.sum(g_all) - 2.0 * inner, 0.0)
            fit = 1.0 - jnp.sqrt(resid_sq) / norm_x
            return tuple(factors), fit, jnp.abs(fit - fit_prev), it + 1

        def cond(carry):
            return (carry[3] < max_iters) & (carry[2] >= tol)

        init = (
            tuple(factors0),
            jnp.asarray(-jnp.inf, vals.dtype),
            jnp.asarray(jnp.inf, vals.dtype),
            jnp.asarray(0, jnp.int32),
        )
        factors, fit, _d, iters = jax.lax.while_loop(cond, body, init)
        return list(factors), fit, iters

    factors, fit, iters = run(vals, coords, init_factors, max_iters, tol)
    factors, weights = cp_normalize(factors)
    return {"weights": weights, "factors": factors, "fit": fit, "n_iters": iters}
