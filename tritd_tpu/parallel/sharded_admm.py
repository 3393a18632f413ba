"""Multi-chip TriTD-ADMM: mode-1 slab / mode-3 frame sharding with explicit
collectives.

Scaling design (SURVEY §2.5 / north star): the data-sized tensors
(D, O, E, Y_L, Y_O and the mode-1 core A) are sharded along mode-1 slabs on
the mesh's "slab" axis; B, C and every (r^2, r^2) Gram are replicated. Per
ADMM iteration the ONLY cross-chip traffic is:

  * psum of GramA               — r^4 words
  * psum of the mode-2 RHS      — n2 r^2 words
  * psum of the mode-3 RHS      — n3 r^2 words
  * psum of 2 residual scalars (+1 oracle-RRE scalar when origin is given)

All elementwise sweeps (O, E, duals, masked imputation) and the
O(n^3 r^2) GEMMs are local to the shard. The whole `while_loop` runs INSIDE
one shard_map so iterations never synchronize with the host.

shard_tensor_mode=3 is the sequence-parallel layout for long video tensors:
D and the C core are sharded along mode-3 frames, GramC and the mode-1/2
RHS partials are psum-reduced instead.

Masked completion (cfg.masked + a mask argument) imputes unobserved entries
with the current L + O estimate each iteration, exactly like the
single-device solver (`solvers/admm.py`) — the imputation is elementwise +
one local `triple_product`, so it adds ZERO collectives.

An alternative GSPMD path (`tritd_admm_auto`) jits the single-device solver
with NamedSharding-annotated inputs and lets XLA place the same collectives
automatically — used as a cross-check and for quick experiments.

Zero-padding of n1 (or n3) to a multiple of the shard count is algebraically
inert: padded entries of D are zero and the padded factor rows/frames are
zero-initialized, so their RHS rows — and hence their factor rows and Gram
contributions — stay exactly zero through every iteration. Masks are padded
with True (observed zero), which preserves the same invariant under masked
imputation; origins are padded with zeros, so the psum'd RRE numerator and
norm are unchanged.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import designs, normal_eq
from ..ops.fold import core_a_from_mat, core_b_from_mat, core_c_from_mat
from ..ops.shrinkage import soft_threshold
from ..solvers.admm import init_factors, t_dtype_of
from ..solvers.base import TriTDConfig, TriTDResult
from .mesh import pad_to_multiple

AXIS = "slab"


def _psum(x, axis_name):
    return jax.lax.psum(x, axis_name)


def _update_factors_sharded(t, a, b, c, cfg: TriTDConfig, axis_name, shard_mode):
    """One Gauss-Seidel sweep of the three ridge mode solves with the
    collective placement of the given sharding layout.

    shard_mode=1 (mode-1 slabs): the A solve is fully local (K1 from
    replicated B, C; RHS rows are the local slab); GramA is the iteration's
    one r^4-word psum; the mode-2/3 RHS partials psum-reduce over slabs.

    shard_mode=3 (mode-3 frames): GramC psums (frames sharded); the
    mode-1/2 RHS partials psum-reduce over frames; the C solve is fully
    local (K3 from replicated A, B; RHS rows are the local frames).
    """
    r = cfg.rank
    variant = cfg.variant
    method = cfg.solve_method

    if shard_mode == 1:
        gb = normal_eq.gram_b(b)
        gc = normal_eq.gram_c(c)
        k1 = normal_eq.combine_grams(1, None, gb, gc, variant)
        rhs1 = normal_eq.rhs_mode(1, t, a, b, c, variant)
        a = core_a_from_mat(normal_eq.ridge_solve(k1, rhs1, cfg.lambda2, method), r)

        ga = _psum(normal_eq.gram_a(a), axis_name)

        k2 = normal_eq.combine_grams(2, ga, None, gc, variant)
        rhs2 = _psum(normal_eq.rhs_mode(2, t, a, b, c, variant), axis_name)
        b = core_b_from_mat(normal_eq.ridge_solve(k2, rhs2, cfg.lambda2, method), r)

        gb = normal_eq.gram_b(b)
        k3 = normal_eq.combine_grams(3, ga, gb, None, variant)
        rhs3 = _psum(normal_eq.rhs_mode(3, t, a, b, c, variant), axis_name)
        c = core_c_from_mat(normal_eq.ridge_solve(k3, rhs3, cfg.alpha_c, method), r)
        return a, b, c

    # shard_mode == 3
    gc = _psum(normal_eq.gram_c(c), axis_name)

    gb = normal_eq.gram_b(b)
    k1 = normal_eq.combine_grams(1, None, gb, gc, variant)
    rhs1 = _psum(normal_eq.rhs_mode(1, t, a, b, c, variant), axis_name)
    a = core_a_from_mat(normal_eq.ridge_solve(k1, rhs1, cfg.lambda2, method), r)

    ga = normal_eq.gram_a(a)
    k2 = normal_eq.combine_grams(2, ga, None, gc, variant)
    rhs2 = _psum(normal_eq.rhs_mode(2, t, a, b, c, variant), axis_name)
    b = core_b_from_mat(normal_eq.ridge_solve(k2, rhs2, cfg.lambda2, method), r)

    gb = normal_eq.gram_b(b)
    k3 = normal_eq.combine_grams(3, ga, gb, None, variant)
    rhs3 = normal_eq.rhs_mode(3, t, a, b, c, variant)
    c = core_c_from_mat(normal_eq.ridge_solve(k3, rhs3, cfg.alpha_c, method), r)
    return a, b, c


def _sharded_solver_body(
    d_loc,
    a0,
    b0,
    c0,
    mask_loc,
    origin_loc,
    cfg: TriTDConfig,
    axis_name: str,
    shard_mode: int,
    has_mask: bool,
    has_origin: bool,
):
    """Runs on each shard under shard_map. `d_loc` (and the sharded factor —
    A rows for shard_mode=1, C frames for shard_mode=3, together with
    mask/origin when given) is the local block; the other factors are
    replicated. Semantics match the single-device solver exactly up to
    float reduction order (tested in tests/test_sharding.py)."""
    cd = cfg.jnp_dtype()
    sd = cfg.jnp_storage_dtype()
    narrow = sd != cd  # narrow HBM storage (cfg.storage_dtype): carry the
    # data-sized state half-width per shard, upcast to cd in registers
    d32 = d_loc.astype(cd)
    norm_d = jnp.sqrt(_psum(jnp.sum(d32 * d32), axis_name))
    norm_origin = (
        jnp.sqrt(_psum(jnp.sum(origin_loc * origin_loc), axis_name))
        if has_origin
        else None
    )
    zeros = jnp.zeros(d_loc.shape, sd)
    nan_hist = jnp.full((cfg.max_iter,), jnp.nan, cd)
    mu0 = jnp.asarray(cfg.mu, cd)
    mu_cap = jnp.asarray(cfg.mu * cfg.mu_cap_factor, cd)
    masked = cfg.masked and has_mask

    def cond(carry):
        *_, k, done = carry
        return (k < cfg.max_iter) & ~done

    def body(carry):
        a, b, c, o, e, y_l, y_o, mu_l, mu_o, err_hist, rre_hist, k, done = carry
        if narrow:
            # loads fuse with the upcast; all arithmetic below runs in cd
            o, e, y_l, y_o = (x.astype(cd) for x in (o, e, y_l, y_o))
        if masked:
            # Impute unobserved entries with the current model estimate —
            # local triple_product + elementwise, zero extra collectives
            # (matches solvers/admm.py masked branch).
            l_prev = designs.triple_product(a, b, c, variant=cfg.variant)
            d = jnp.where(mask_loc, d_loc.astype(cd), l_prev + o)
        else:
            d = d_loc.astype(cd) if narrow else d_loc
        t = d - o + y_l / mu_l
        # Round the factor-solve target to the same storage/einsum dtype the
        # single-device solver carries it in (solvers/admm.py t_dtype_of) so
        # narrow-mode trajectories match up to reduction order (r2 advisor).
        td = t_dtype_of(cfg)
        if td is not None:
            t = t.astype(td)

        a, b, c = _update_factors_sharded(t, a, b, c, cfg, axis_name, shard_mode)

        # local reconstruction + elementwise ADMM block (no communication)
        l = designs.triple_product(a, b, c, variant=cfg.variant)
        r1 = d - l + y_l / mu_l
        r2 = e - y_o / mu_o
        o = (mu_l * r1 + mu_o * r2) / (mu_l + mu_o)
        e = soft_threshold(o + y_o / mu_o, cfg.lambda_l1 / mu_o)
        res_l = d - l - o
        res_o = o - e
        y_l = y_l + mu_l * res_l
        y_o = y_o + mu_o * res_o
        mu_l = jnp.minimum(mu_l * cfg.rho, mu_cap)
        mu_o = jnp.minimum(mu_o * cfg.rho, mu_cap)

        err = (
            jnp.sqrt(_psum(jnp.sum(res_l * res_l), axis_name))
            + jnp.sqrt(_psum(jnp.sum(res_o * res_o), axis_name))
        ) / norm_d
        err_hist = err_hist.at[k].set(err)
        if has_origin:
            diff = l - origin_loc
            rre = jnp.sqrt(_psum(jnp.sum(diff * diff), axis_name)) / norm_origin
            rre_hist = rre_hist.at[k].set(rre)
        err_prev = err_hist[jnp.maximum(k - 1, 0)]
        done = (k >= 1) & (jnp.abs(err - err_prev) < cfg.tol * err_prev)
        if narrow:
            o, e, y_l, y_o = (x.astype(sd) for x in (o, e, y_l, y_o))
        return (a, b, c, o, e, y_l, y_o, mu_l, mu_o, err_hist, rre_hist, k + 1, done)

    carry0 = (
        a0, b0, c0, zeros, zeros, zeros, zeros, mu0, mu0,
        nan_hist, nan_hist, jnp.asarray(0, jnp.int32), jnp.asarray(False),
    )
    a, b, c, o, e, _, _, _, _, err_hist, rre_hist, k, _ = jax.lax.while_loop(
        cond, body, carry0
    )
    return a, b, c, o, e, err_hist, rre_hist, k


@functools.partial(
    jax.jit,
    static_argnames=(
        "cfg", "mesh", "axis_name", "shard_tensor_mode", "valid_size",
        "has_mask", "has_origin",
    ),
)
def _sharded_run(
    d_pad, mask_pad, origin_pad, key, cfg: TriTDConfig, mesh: Mesh,
    axis_name: str, shard_tensor_mode: int = 1, valid_size: int | None = None,
    has_mask: bool = False, has_origin: bool = False,
):
    dtype = cfg.jnp_dtype()
    # Draw the factor init at the ORIGINAL (unpadded) shape so the random
    # streams match the single-device solver exactly, then zero-pad the
    # sharded core. Zero padding is inert: padded D entries are zero, so the
    # padded core rows/frames stay exactly zero through every iteration, and
    # C's padded frames must be zero anyway (GramC is psum-reduced before
    # the first C update).
    n1p, n2p, n3p = d_pad.shape
    if valid_size is None:
        orig_shape = (n1p, n2p, n3p)
    elif shard_tensor_mode == 1:
        orig_shape = (valid_size, n2p, n3p)
    else:
        orig_shape = (n1p, n2p, valid_size)
    a0, b0, c0 = init_factors(key, orig_shape, cfg.rank, dtype)
    if shard_tensor_mode == 1 and a0.shape[0] != n1p:
        a0 = jnp.pad(a0, ((0, n1p - a0.shape[0]), (0, 0), (0, 0)))
    if shard_tensor_mode == 3 and c0.shape[2] != n3p:
        c0 = jnp.pad(c0, ((0, 0), (0, 0), (0, n3p - c0.shape[2])))

    if shard_tensor_mode == 1:
        tensor_spec = P(axis_name, None, None)
        a_spec, c_spec = P(axis_name), P()
    elif shard_tensor_mode == 3:
        tensor_spec = P(None, None, axis_name)
        a_spec, c_spec = P(), P(None, None, axis_name)
    else:
        raise ValueError(
            f"shard_tensor_mode must be 1 or 3, got {shard_tensor_mode}"
        )
    mask_spec = tensor_spec if has_mask else P()
    origin_spec = tensor_spec if has_origin else P()
    fn = jax.shard_map(
        functools.partial(
            _sharded_solver_body,
            cfg=cfg,
            axis_name=axis_name,
            shard_mode=shard_tensor_mode,
            has_mask=has_mask,
            has_origin=has_origin,
        ),
        mesh=mesh,
        in_specs=(tensor_spec, a_spec, P(), c_spec, mask_spec, origin_spec),
        out_specs=(
            a_spec,        # a
            P(),           # b
            c_spec,        # c
            tensor_spec,   # o
            tensor_spec,   # e
            P(),           # err_hist
            P(),           # rre_hist
            P(),           # k
        ),
        check_vma=False,
    )
    return fn(d_pad, a0, b0, c0, mask_pad, origin_pad)


def tritd_admm_sharded(
    d: jnp.ndarray,
    cfg: TriTDConfig,
    mesh: Mesh,
    key: jax.Array | None = None,
    axis_name: str = AXIS,
    shard_tensor_mode: int = 1,
    mask: jnp.ndarray | None = None,
    origin: jnp.ndarray | None = None,
) -> TriTDResult:
    """Sharded robust TriTD-ADMM. shard_tensor_mode=1 shards mode-1 slabs
    (rows i and the A core); shard_tensor_mode=3 shards mode-3 frames (the
    sequence-parallel layout for long video tensors, C core sharded).

    mask: optional bool tensor of *observed* entries — with cfg.masked, the
    sharded solver imputes unobserved entries with L + O each iteration,
    matching :func:`tritd_tpu.solvers.tritd_admm`.
    origin: optional ground truth; per-iteration oracle RRE is recorded in
    rre_hist (NaN-filled when absent — it is NOT the residual history).

    Semantics identical to :func:`tritd_tpu.solvers.tritd_admm` up to float
    reduction order.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    if cfg.masked and mask is None:
        raise ValueError("cfg.masked=True requires a mask argument")
    if mask is not None and not cfg.masked:
        raise ValueError(
            "mask given but cfg.masked=False — pass TriTDConfig(masked=True)"
        )
    n_shards = mesh.shape[axis_name]
    # host->device transfer and resident copy in the storage dtype (= cfg
    # dtype unless cfg.storage_dtype narrows it)
    d = d.astype(cfg.jnp_dtype()).astype(cfg.jnp_storage_dtype())
    axis = 0 if shard_tensor_mode == 1 else 2
    d_pad, n_orig = pad_to_multiple(d, axis, n_shards)
    spec = (
        P(axis_name, None, None) if shard_tensor_mode == 1
        else P(None, None, axis_name)
    )
    sharding = NamedSharding(mesh, spec)
    d_pad = jax.device_put(d_pad, sharding)

    has_mask = mask is not None
    has_origin = origin is not None
    dummy = jnp.zeros((1, 1, 1), cfg.jnp_dtype())
    if has_mask:
        # Pad with True (observed zero): preserves the padding-inertness
        # invariant under masked imputation.
        mask_pad = _pad_with(mask.astype(bool), axis, d_pad.shape[axis], True)
        mask_pad = jax.device_put(mask_pad, sharding)
    else:
        mask_pad = dummy
    if has_origin:
        origin_pad, _ = pad_to_multiple(
            origin.astype(cfg.jnp_dtype()), axis, n_shards
        )
        origin_pad = jax.device_put(origin_pad, sharding)
    else:
        origin_pad = dummy

    a, b, c, o, e, err_hist, rre_hist, k = _sharded_run(
        d_pad, mask_pad, origin_pad, key, cfg, mesh, axis_name,
        shard_tensor_mode, n_orig, has_mask, has_origin,
    )
    dtype = cfg.jnp_dtype()
    o, e = o.astype(dtype), e.astype(dtype)  # widen narrow-stored results
    if shard_tensor_mode == 1:
        return TriTDResult(
            a=a[:n_orig], b=b, c=c, o=o[:n_orig], e=e[:n_orig],
            err_hist=err_hist, rre_hist=rre_hist, n_iters=k,
        )
    return TriTDResult(
        a=a, b=b, c=c[:, :, :n_orig], o=o[..., :n_orig], e=e[..., :n_orig],
        err_hist=err_hist, rre_hist=rre_hist, n_iters=k,
    )


def _pad_with(x, axis: int, target: int, value):
    """Pad one axis up to `target` with a constant value."""
    size = x.shape[axis]
    if size == target:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - size)
    return jnp.pad(x, pad, constant_values=value)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "mesh", "data_axis", "slab_axis", "has_mask", "has_origin"),
)
def _batch_sharded_run(
    d_batch, mask_batch, origin_batch, key, cfg: TriTDConfig, mesh: Mesh,
    data_axis: str, slab_axis: str, has_mask: bool = False, has_origin: bool = False,
):
    dtype = cfg.jnp_dtype()
    nb, n1p = d_batch.shape[0], d_batch.shape[1]
    keys = jax.random.split(key, nb)
    a0, b0, c0 = jax.vmap(
        lambda k: init_factors(k, (n1p, *d_batch.shape[2:]), cfg.rank, dtype)
    )(keys)

    solve = functools.partial(
        _sharded_solver_body,
        cfg=cfg,
        axis_name=slab_axis,
        shard_mode=1,
        has_mask=has_mask,
        has_origin=has_origin,
    )

    def body(d, a0, b0, c0, mask, origin):
        # The local entries run one after another, each as the unbatched
        # solver program. Under vmap the O(n^3 r^2) RHS contractions become
        # batched GEMMs, which cuBLAS accumulates over their n2*n3-long
        # contraction about 20x less accurately; with the C solve's 1e-9
        # ridge that drove a video problem to NaN on an H100.
        def one(xs):
            d_i, a_i, b_i, c_i, m_i, o_i = xs
            return solve(d_i, a_i, b_i, c_i,
                         mask if m_i is None else m_i,
                         origin if o_i is None else o_i)

        # dummies (replicated, unused) stay out of the mapped operands
        return jax.lax.map(one, (d, a0, b0, c0,
                                 mask if has_mask else None,
                                 origin if has_origin else None))
    tensor_spec = P(data_axis, slab_axis)
    mask_spec = tensor_spec if has_mask else P()
    origin_spec = tensor_spec if has_origin else P()
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            tensor_spec,
            P(data_axis, slab_axis),
            P(data_axis),
            P(data_axis),
            mask_spec,
            origin_spec,
        ),
        out_specs=(
            P(data_axis, slab_axis),  # a
            P(data_axis),             # b
            P(data_axis),             # c
            tensor_spec,              # o
            tensor_spec,              # e
            P(data_axis),             # err_hist
            P(data_axis),             # rre_hist
            P(data_axis),             # k
        ),
        check_vma=False,
    )
    return fn(d_batch, a0, b0, c0, mask_batch, origin_batch)


def tritd_admm_batch_sharded(
    d_batch: jnp.ndarray,
    cfg: TriTDConfig,
    mesh: Mesh,
    key: jax.Array | None = None,
    data_axis: str = "data",
    slab_axis: str = AXIS,
    mask_batch: jnp.ndarray | None = None,
    origin_batch: jnp.ndarray | None = None,
) -> TriTDResult:
    """Data-parallel batch of independent TriTD problems (e.g. the four CDnet
    sequences, BASELINE.json config 5) with each problem's mode-1 slabs
    sharded across the "slab" axis — DP x TP on a 2-D mesh. The entries held
    by one card are solved one after another, each with its own early stop,
    so each follows its single-problem trajectory. Per-entry masks
    (cfg.masked) and origins (oracle rre_hist) are supported like in
    :func:`tritd_admm_sharded`."""
    if key is None:
        key = jax.random.PRNGKey(0)
    if cfg.masked and mask_batch is None:
        raise ValueError("cfg.masked=True requires a mask_batch argument")
    if mask_batch is not None and not cfg.masked:
        raise ValueError(
            "mask_batch given but cfg.masked=False — pass TriTDConfig(masked=True)"
        )
    d_batch = d_batch.astype(cfg.jnp_dtype()).astype(cfg.jnp_storage_dtype())
    n_data = mesh.shape[data_axis]
    n_slab = mesh.shape[slab_axis]
    if d_batch.shape[0] % n_data:
        raise ValueError(
            f"batch {d_batch.shape[0]} not divisible by data axis {n_data}"
        )
    d_pad, n1 = pad_to_multiple(d_batch, 1, n_slab)
    batch_sharding = NamedSharding(mesh, P(data_axis, slab_axis, None, None))
    d_pad = jax.device_put(d_pad, batch_sharding)

    has_mask = mask_batch is not None
    has_origin = origin_batch is not None
    dummy = jnp.zeros((1, 1, 1, 1), cfg.jnp_dtype())
    if has_mask:
        mask_pad = _pad_with(mask_batch.astype(bool), 1, d_pad.shape[1], True)
        mask_pad = jax.device_put(mask_pad, batch_sharding)
    else:
        mask_pad = dummy
    if has_origin:
        origin_pad, _ = pad_to_multiple(
            origin_batch.astype(cfg.jnp_dtype()), 1, n_slab
        )
        origin_pad = jax.device_put(origin_pad, batch_sharding)
    else:
        origin_pad = dummy

    a, b, c, o, e, err_hist, rre_hist, k = _batch_sharded_run(
        d_pad, mask_pad, origin_pad, key, cfg, mesh, data_axis, slab_axis,
        has_mask, has_origin,
    )
    dtype = cfg.jnp_dtype()
    return TriTDResult(
        a=a[:, :n1], b=b, c=c,
        o=o[:, :n1].astype(dtype), e=e[:, :n1].astype(dtype),
        err_hist=err_hist, rre_hist=rre_hist, n_iters=k,
    )


def tritd_admm_auto(
    d: jnp.ndarray,
    cfg: TriTDConfig,
    mesh: Mesh,
    key: jax.Array | None = None,
    axis_name: str = AXIS,
    mask: jnp.ndarray | None = None,
    origin: jnp.ndarray | None = None,
):
    """GSPMD alternative: annotate the input sharding and let XLA's SPMD
    partitioner place the collectives in the single-device solver.

    Accepts the same protocol surface as :func:`tritd_admm_sharded` and the
    batch path (VERDICT r4 #5): `mask` (observed-entry indicator, used with
    cfg.masked) and `origin` (oracle rre_hist) are sharded alongside `d`.
    Mask padding is True (observed zero) and origin padding is zero — the
    same invariants the shard_map path documents, so padded slabs stay
    exactly inert under masked imputation and leave the RRE sums unchanged."""
    from ..solvers.admm import tritd_admm

    n_shards = mesh.shape[axis_name]
    sharding = NamedSharding(mesh, P(axis_name, None, None))
    d = d.astype(cfg.jnp_dtype())
    d_pad, n1 = pad_to_multiple(d, 0, n_shards)
    d_pad = jax.device_put(d_pad, sharding)
    mask_pad = origin_pad = None
    if mask is not None:
        mask_pad = _pad_with(mask.astype(bool), 0, d_pad.shape[0], True)
        mask_pad = jax.device_put(mask_pad, sharding)
    if origin is not None:
        origin_pad, _ = pad_to_multiple(origin.astype(cfg.jnp_dtype()), 0, n_shards)
        origin_pad = jax.device_put(origin_pad, sharding)
    res = tritd_admm(d_pad, cfg, key=key, mask=mask_pad, origin=origin_pad)
    return TriTDResult(
        a=res.a[:n1], b=res.b, c=res.c, o=res.o[:n1], e=res.e[:n1],
        err_hist=res.err_hist, rre_hist=res.rre_hist, n_iters=res.n_iters,
    )
