"""Unit tests for the L0 tensor-ops layer.

The correctness oracles are the reference's own informal equivalence checks
(SURVEY §4): naive-einsum specs from the commented quadruple loops
(`fast_robust_triple_tensor/buildF.m:5-16`), the Kronecker baselines
(`origin_triple_tensor/kronF.m`), and the Gram-factorization identity
F F^T = GramB (.) GramC.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tritd_tpu.ops import (
    build_f,
    build_g,
    build_h,
    capped_simplex_projection,
    flsa,
    fold,
    gram_mode,
    kron_f,
    prox_l1,
    rhs_mode,
    ridge_solve,
    soft_threshold,
    svt,
    svt_ref_compat,
    triple_product,
    triple_product_naive,
    unfold,
    weighted_soft_threshold,
)

N1, N2, N3, R = 4, 5, 6, 3


@pytest.fixture(scope="module")
def cores(rng_key):
    ka, kb, kc, kx = jax.random.split(rng_key, 4)
    a = jax.random.normal(ka, (N1, R, R))
    b = jax.random.normal(kb, (R, N2, R))
    c = jax.random.normal(kc, (R, R, N3))
    x = jax.random.normal(kx, (N1, N2, N3))
    return a, b, c, x


def test_unfold_fold_roundtrip(rng_key):
    x = jax.random.normal(rng_key, (N1, N2, N3))
    for mode in (1, 2, 3):
        assert jnp.allclose(fold(unfold(x, mode), mode, x.shape), x)


def test_unfold_shapes(rng_key):
    x = jax.random.normal(rng_key, (N1, N2, N3))
    assert unfold(x, 1).shape == (N1, N2 * N3)
    assert unfold(x, 2).shape == (N2, N1 * N3)
    assert unfold(x, 3).shape == (N3, N1 * N2)


def test_unfold_entry_convention(rng_key):
    """unfold(X,1)[i, t*n2 + j] == X[i,j,t] etc. (fold.py docstring spec)."""
    x = jax.random.normal(rng_key, (N1, N2, N3))
    i, j, t = 2, 3, 4
    assert unfold(x, 1)[i, t * N2 + j] == x[i, j, t]
    assert unfold(x, 2)[j, t * N1 + i] == x[i, j, t]
    assert unfold(x, 3)[t, j * N1 + i] == x[i, j, t]


@pytest.mark.parametrize("variant", ["hadamard", "full"])
def test_design_matrices_vs_naive(cores, variant):
    """Entrywise check of F/G/H against the commented-loop specs."""
    a, b, c, _ = cores
    f = np.asarray(build_f(b, c, variant))
    g = np.asarray(build_g(a, c, variant))
    h = np.asarray(build_h(a, b, variant))
    an, bn, cn = np.asarray(a), np.asarray(b), np.asarray(c)
    for q in range(R):
        for s in range(R):
            for j in range(N2):
                for t in range(N3):
                    if variant == "hadamard":
                        want = bn[q, j, s] * cn[q, s, t]
                    else:
                        want = np.sum(bn[:, j, s] * cn[:, q, t])
                    np.testing.assert_allclose(
                        f[q * R + s, t * N2 + j], want, rtol=1e-5
                    )
    for p in range(R):
        for s in range(R):
            for i in range(N1):
                for t in range(N3):
                    if variant == "hadamard":
                        want = an[i, p, s] * cn[p, s, t]
                    else:
                        want = np.sum(an[i, :, s] * cn[p, :, t])
                    np.testing.assert_allclose(
                        g[p * R + s, t * N1 + i], want, rtol=1e-5
                    )
    for p in range(R):
        for q in range(R):
            for i in range(N1):
                for j in range(N2):
                    if variant == "hadamard":
                        want = an[i, p, q] * bn[p, j, q]
                    else:
                        want = np.sum(an[i, q, :] * bn[p, j, :])
                    np.testing.assert_allclose(
                        h[p * R + q, j * N1 + i], want, rtol=1e-5
                    )


@pytest.mark.parametrize("variant", ["hadamard", "full"])
def test_triple_product_matches_naive(cores, variant):
    a, b, c, _ = cores
    got = triple_product(a, b, c, variant)
    want = triple_product_naive(a, b, c, variant)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("variant", ["hadamard", "full"])
def test_triple_product_is_unfold_gemm(cores, variant):
    """unfold(L, 1) == A_(1) @ F — the reference's reconstruction identity
    (`triple_product.m:6-7`)."""
    a, b, c, _ = cores
    l = triple_product(a, b, c, variant)
    a1 = a.reshape(N1, R * R)
    f = build_f(b, c, variant)
    np.testing.assert_allclose(
        np.asarray(unfold(l, 1)), np.asarray(a1 @ f), rtol=1e-4, atol=1e-5
    )


@pytest.mark.parametrize("variant", ["hadamard", "full"])
@pytest.mark.parametrize("mode", [1, 2, 3])
def test_gram_factorization_identity(cores, variant, mode):
    """K(mode) == D D^T for D in {F, G, H} — the Hadamard-of-Grams identity
    that lets the solver skip materializing designs (SURVEY §2.1)."""
    a, b, c, _ = cores
    d = {1: build_f(b, c, variant), 2: build_g(a, c, variant), 3: build_h(a, b, variant)}[mode]
    k = gram_mode(mode, a, b, c, variant)
    np.testing.assert_allclose(np.asarray(k), np.asarray(d @ d.T), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", ["hadamard", "full"])
@pytest.mark.parametrize("mode", [1, 2, 3])
def test_rhs_identity(cores, variant, mode):
    """rhs(mode) == unfold(X, mode) @ D^T without materializing D."""
    a, b, c, x = cores
    d = {1: build_f(b, c, variant), 2: build_g(a, c, variant), 3: build_h(a, b, variant)}[mode]
    rhs = rhs_mode(mode, x, a, b, c, variant)
    np.testing.assert_allclose(
        np.asarray(rhs), np.asarray(unfold(x, mode) @ d.T), rtol=1e-4, atol=1e-4
    )


def test_kron_f_equals_full_build(cores):
    a, b, c, _ = cores
    np.testing.assert_allclose(
        np.asarray(kron_f(b, c)), np.asarray(build_f(b, c, "full")), rtol=1e-5
    )


def test_ridge_solve_methods_agree(cores):
    a, b, c, x = cores
    k = gram_mode(1, a, b, c, "hadamard")
    rhs = rhs_mode(1, x, a, b, c, "hadamard")
    sols = [ridge_solve(k, rhs, 1e-3, m) for m in ("cholesky", "pinv", "lstsq")]
    for s in sols[1:]:
        np.testing.assert_allclose(np.asarray(sols[0]), np.asarray(s), rtol=1e-3, atol=1e-4)


def test_ridge_solve_solves_system(cores):
    a, b, c, x = cores
    k = gram_mode(2, a, b, c, "hadamard")
    rhs = rhs_mode(2, x, a, b, c, "hadamard")
    alpha = 1e-3
    sol = ridge_solve(k, rhs, alpha)
    np.testing.assert_allclose(
        np.asarray(sol @ (k + alpha * jnp.eye(R * R))), np.asarray(rhs),
        rtol=1e-3, atol=1e-3,
    )


def test_soft_threshold():
    x = jnp.array([-3.0, -0.5, 0.0, 0.2, 2.0])
    got = soft_threshold(x, 1.0)
    np.testing.assert_allclose(np.asarray(got), [-2.0, 0.0, 0.0, 0.0, 1.0])
    # prox_l1 (max/min form of `prox_l1.m:12`) is the same operator
    np.testing.assert_allclose(np.asarray(prox_l1(x, 1.0)), np.asarray(got))


def test_weighted_soft_threshold():
    x = jnp.array([2.0, -2.0, 2.0])
    w = jnp.array([0.5, 1.0, 3.0])
    got = weighted_soft_threshold(x, 1.0, w)
    np.testing.assert_allclose(np.asarray(got), [1.5, -1.0, 0.0])


def test_svt_shrinks_singular_values(rng_key):
    m = jax.random.normal(rng_key, (8, 6))
    tau = 0.5
    got = svt(m, tau)
    s_orig = jnp.linalg.svd(m, compute_uv=False)
    s_got = jnp.linalg.svd(got, compute_uv=False)
    np.testing.assert_allclose(
        np.asarray(s_got), np.asarray(jnp.maximum(s_orig - tau, 0.0)), atol=1e-5
    )


def test_svt_ref_compat_truncation(rng_key):
    """The `r = sum(S > 1)` quirk: shrunk values <= 1 are dropped entirely."""
    u, _, vt = jnp.linalg.svd(jax.random.normal(rng_key, (6, 6)))
    s = jnp.array([5.0, 3.0, 1.4, 0.9, 0.3, 0.1])
    m = (u * s[None, :]) @ vt
    got = svt_ref_compat(m, 0.5)
    s_got = jnp.linalg.svd(got, compute_uv=False)
    np.testing.assert_allclose(np.asarray(s_got[:2]), [4.5, 2.5], atol=1e-4)
    # 1.4 - 0.5 = 0.9 <= 1 -> dropped, unlike standard svt
    np.testing.assert_allclose(np.asarray(s_got[2:]), np.zeros(4), atol=1e-4)


def test_svt_gram_matches_svd(rng_key):
    """The Gram-eigh SVT path == the SVD path on both aspect
    ratios, including the ref-compat truncation variant."""
    for i, shape in enumerate([(9, 40), (40, 9), (12, 12)]):
        m = jax.random.normal(jax.random.fold_in(rng_key, i), shape)
        for fn, tau in ((svt, 0.5), (svt_ref_compat, 0.3)):
            np.testing.assert_allclose(
                np.asarray(fn(m, tau, method="gram")),
                np.asarray(fn(m, tau, method="svd")),
                rtol=2e-4, atol=2e-4,
            )


def test_svt_gram_matches_svd_benchmark_shape(rng_key):
    """At-scale parity (r2 verdict #2): the taxi mode-1 unfolding shape
    100x50000 in f32 — where squaring the condition number is most dangerous.
    Low-rank + noise spectrum like the benchmark data; parity within
    5e-6 * sigma_max across the baseline suite's tau range."""
    k1, k2, k3 = jax.random.split(rng_key, 3)
    u = jax.random.normal(k1, (100, 8))
    v = jax.random.normal(k2, (8, 50000))
    m = (u @ v + 0.1 * jax.random.normal(k3, (100, 50000))).astype(jnp.float32)
    smax = float(jnp.linalg.svd(m, compute_uv=False)[0])
    for tau in (0.5, 5.0, 50.0):
        diff = np.abs(
            np.asarray(svt(m, tau, method="gram"))
            - np.asarray(svt(m, tau, method="svd"))
        ).max()
        assert diff < 5e-6 * smax, (tau, diff, smax)


def test_svt_gram_ill_conditioned_small_tau(rng_key):
    """Ill-conditioned spectrum (sigma spanning 1e6:1) with tau SMALL enough
    that tiny singular triplets are retained — the regime the r2 advisor
    flagged. With the refined-sigma gram path the reconstruction error stays
    below sqrt(eps)*sigma_max (the documented subspace-cluster bound); the
    raw sqrt(eigenvalue) path would be O(1) wrong on the retained tiny
    values."""
    k1, k2 = jax.random.split(rng_key)
    p, q = 60, 200
    uu, _ = jnp.linalg.qr(jax.random.normal(k1, (p, p)))
    vv, _ = jnp.linalg.qr(jax.random.normal(k2, (q, p)))
    s = jnp.logspace(0, -6, p).astype(jnp.float32)
    m = ((uu * s[None, :]) @ vv.T).astype(jnp.float32)
    bound = float(np.sqrt(np.finfo(np.float32).eps))  # * sigma_max (= 1)
    for tau in (1e-4, 1e-2):
        diff = np.abs(
            np.asarray(svt(m, tau, method="gram"))
            - np.asarray(svt(m, tau, method="svd"))
        ).max()
        assert diff < bound, (tau, diff)


def test_svt_lowrank_matches_svd(rng_key):
    """The randomized top-k SVT path == the SVD path whenever the operator's
    retained rank fits the budget — the RC-FCTN video regime (square-ish
    matrices, ref-compat `>1` gate). Decaying spectrum, retained rank ~12,
    budget 64 with plenty of slack."""
    k1, k2 = jax.random.split(rng_key)
    p, q = 300, 420
    uu, _ = jnp.linalg.qr(jax.random.normal(k1, (p, p)))
    vv, _ = jnp.linalg.qr(jax.random.normal(k2, (q, p)))
    s = (50.0 * jnp.exp(-0.3 * jnp.arange(p))).astype(jnp.float32)
    for m in ((uu * s[None, :]) @ vv.T, ((uu * s[None, :]) @ vv.T).T):
        ref = np.asarray(svt_ref_compat(m, 0.7, method="svd"))
        got = np.asarray(svt_ref_compat(m, 0.7, method="lowrank:64"))
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-4 * float(s[0]))


def test_svt_lowrank_threshold_noise_floor(rng_key):
    """Components near the ref-compat truncation threshold: with a dense
    sub-threshold tail (the hard case for a randomized range finder) every
    CLEARLY retained component is reproduced; total error stays at the scale
    of the threshold itself (each misresolved component has |f(sigma)| ~ 1),
    NOT at the scale of sigma_max."""
    k1, k2, k3 = jax.random.split(rng_key, 3)
    p, q = 256, 256
    uu, _ = jnp.linalg.qr(jax.random.normal(k1, (p, p)))
    vv, _ = jnp.linalg.qr(jax.random.normal(k2, (q, q)))
    # 10 big components, then a dense tail hugging the threshold tau+1=1.7
    s = jnp.concatenate([
        jnp.linspace(200.0, 50.0, 10),
        jnp.linspace(2.2, 0.1, p - 10),
    ]).astype(jnp.float32)
    m = (uu * s[None, :]) @ vv[:q].T
    ref = np.asarray(svt_ref_compat(m, 0.7, method="svd"))
    got = np.asarray(svt_ref_compat(m, 0.7, method="lowrank:64"))
    # spectral-norm error bounded by a small multiple of the threshold
    err = np.linalg.norm(got - ref, 2)
    assert err < 5.0, err


def test_svt_auto_routing():
    """auto_method: gram below LOWRANK_MIN_DIM, lowrank at/above; the
    "auto" string resolves per static shape inside _apply_spectral."""
    from tritd_tpu.ops.svt import LOWRANK_BUDGET, LOWRANK_MIN_DIM, auto_method

    assert auto_method(100, 50000) == "gram"
    assert auto_method(LOWRANK_MIN_DIM - 1, 10**6) == "gram"
    assert auto_method(4800, 4800) == f"lowrank:{LOWRANK_BUDGET}"
    assert auto_method(3600, 6400) == f"lowrank:{LOWRANK_BUDGET}"
    assert auto_method(4800, 4800, budget=512) == "lowrank:512"
    # "auto"/"auto:<b>" accepted by the public entry points (small shape ->
    # gram route either way)
    m = jnp.eye(8) * 5.0
    for meth in ("auto", "auto:512"):
        np.testing.assert_allclose(
            np.asarray(svt(m, 1.0, method=meth)), np.asarray(svt(m, 1.0)),
            atol=1e-5,
        )


def test_svt_plain_rejects_lowrank():
    """r3 advisor (low): the randomized route is only valid for the
    tail-truncating ref-compat shrinkage; plain svt() must reject it —
    including when 'auto' resolves to lowrank at a big square-ish shape —
    instead of silently dropping surviving tail components."""
    import pytest

    from tritd_tpu.ops.svt import LOWRANK_MIN_DIM

    m = jnp.eye(8) * 5.0
    with pytest.raises(ValueError, match="truncating"):
        svt(m, 1.0, method="lowrank:4")
    # svt_ref_compat (truncating) accepts the same route
    np.asarray(svt_ref_compat(m, 1.0, method="lowrank:8"))

    big = jax.ShapeDtypeStruct((LOWRANK_MIN_DIM, LOWRANK_MIN_DIM), jnp.float32)
    with pytest.raises(ValueError, match="truncating"):
        jax.eval_shape(lambda t: svt(t, 1.0, method="auto"), big)
    # 'auto' resolving to gram stays usable for plain svt
    np.asarray(svt(m, 1.0, method="auto"))


def test_video_svt_method_resolution():
    """r3 advisor (medium): the fctn video driver defaults to 'auto' (which
    resolves to the validated budget) and never rewrites an explicit route."""
    import inspect

    from tritd_tpu.baselines.rc_fctn import (
        VIDEO_SVT_BUDGET,
        rc_fctn_driver_video,
        resolve_video_svt_method,
    )

    sig = inspect.signature(rc_fctn_driver_video)
    assert sig.parameters["svt_method"].default == "auto"
    assert resolve_video_svt_method("auto") == f"auto:{VIDEO_SVT_BUDGET}"
    for explicit in ("gram", "svd", "auto:256", "lowrank:64"):
        assert resolve_video_svt_method(explicit) == explicit


def test_svt_warm_refresh_matches_gram(rng_key):
    """svt_ref_compat_warm with refresh_now=True == the exact gram path;
    with a STALE basis from a nearby matrix it stays close (the drift
    regime the warm route exploits); both orientations round-trip."""
    from tritd_tpu.ops.svt import svt_ref_compat_warm

    for shape in ((24, 15), (15, 24)):
        m = jax.random.normal(rng_key, shape) * 3.0
        thin = min(shape)
        eye = jnp.eye(thin)
        fresh, basis = svt_ref_compat_warm(m, 0.5, eye, True)
        exact = svt_ref_compat(m, 0.5, method="gram")
        np.testing.assert_allclose(
            np.asarray(fresh), np.asarray(exact), rtol=1e-4, atol=1e-4
        )
        assert basis.shape == (thin, thin)
        # tiny perturbation, stale basis: output near the perturbed exact
        m2 = m + 1e-4 * jax.random.normal(jax.random.fold_in(rng_key, 1), shape)
        stale, basis2 = svt_ref_compat_warm(m2, 0.5, basis, False)
        exact2 = svt_ref_compat(m2, 0.5, method="gram")
        np.testing.assert_allclose(
            np.asarray(stale), np.asarray(exact2), rtol=1e-2, atol=1e-2
        )
        # stale path must not touch the basis
        np.testing.assert_array_equal(np.asarray(basis2), np.asarray(basis))


def test_warm_spec_strict_parsing():
    """r4 review: 'warm8' (missing colon) must error, not silently run the
    default period-4 schedule while recording the bogus string."""
    import pytest

    from tritd_tpu.ops.svt import warm_spec

    assert warm_spec("warm", [(200, 300)])[0] == 4
    assert warm_spec("warm:8", [(200, 300)]) == (8, (0,), (200,))
    for bad in ("warm8", "warm:", "warm:x", "warm:0", "warmish"):
        with pytest.raises(ValueError, match="warm"):
            warm_spec(bad, [(200, 300)])


def test_run_warm_blocks_traced_k0_with_remainder():
    """Regression (r5): a TRACED k0 (the chunked-dispatch path) with a
    remainder block > 1 must still trace under the stale-loop unroll —
    warm:16 under chunk=25 hit 'unroll requires statically known bounds'
    because the remainder fori looped over absolute iterations (k0 + j)
    instead of the static offset. Also pins chunked == unchunked schedules:
    the refresh pattern and visit order must be identical."""
    from tritd_tpu.ops.svt import run_warm_blocks

    def schedule(n_steps, period, k0_traced, unroll):
        def run(k0):
            def body(k, carry, refresh):
                visits, refreshes = carry
                visits = visits.at[k].add(1)
                refreshes = refreshes.at[k].add(jnp.int32(1 if refresh else 0))
                return visits, refreshes

            carry = (jnp.zeros(40, jnp.int32), jnp.zeros(40, jnp.int32))
            return run_warm_blocks(body, carry, k0, n_steps, period, unroll)

        if k0_traced:
            run = jax.jit(run)
        return run

    # chunk=25 / warm:16 (the failing config), traced k0, unroll=4
    total, chunk, period = 35, 25, 16
    visits = jnp.zeros(40, jnp.int32)
    refreshes = jnp.zeros(40, jnp.int32)
    k0 = 0
    while k0 < total:
        n = min(chunk, total - k0)
        v, r = schedule(n, period, True, 4)(jnp.asarray(k0, jnp.int32))
        visits, refreshes = visits + v, refreshes + r
        k0 += n
    np.testing.assert_array_equal(np.asarray(visits[:total]), 1)
    assert int(visits[total:].sum()) == 0
    # unchunked reference schedule (static k0) must visit identically
    v1, r1 = schedule(total, period, False, 1)(0)
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(visits))
    # refresh guarantee (run_warm_blocks docstring): a refresh at iteration
    # 0 and AT LEAST every `period` iterations — chunk boundaries reset the
    # phase (start with a refresh), so gaps only shrink, never grow.
    for r in (refreshes, r1):
        pts = np.nonzero(np.asarray(r))[0]
        assert pts[0] == 0
        assert np.all(np.diff(pts) <= period)
        assert pts[-1] > total - 1 - period  # tail covered too


def test_ttnn_ring_warm_routes(rng_key):
    """warm:<K> on TTNN and RING: inert (== gram) when no cut qualifies,
    and close to the exact path when cuts DO carry a warm basis (thin side
    >= WARM_MIN_DIM) — final X must agree tightly, the trajectory loosely
    (stale-basis drift), matching the chicago-scale validation standard."""
    from tritd_tpu.baselines.rtrc import rtrc
    from tritd_tpu.baselines.ttnn import tt_trpca

    def low_cp(key, shape, r):
        ks = jax.random.split(key, 3)
        us = [jax.random.normal(k, (s, r)) for k, s in zip(ks, shape)]
        return jnp.einsum("ir,jr,kr->ijk", *us) / r

    # tiny shape: every thin side < WARM_MIN_DIM -> warm == gram exactly
    x0 = low_cp(rng_key, (8, 9, 10), 2) * 5.0
    z_w, _, h_w, _ = tt_trpca(x0, origin=x0, max_iter=15, svt_method="warm:3")
    z_g, _, h_g, _ = tt_trpca(x0, origin=x0, max_iter=15, svt_method="gram")
    np.testing.assert_allclose(np.asarray(h_w), np.asarray(h_g), rtol=1e-5, atol=1e-6)

    mask0 = jnp.ones(x0.shape, bool)
    x_w, _, hr_w, _ = rtrc(x0, mask0, origin=x0, max_iter=15, svt_method="warm:3")
    x_g, _, hr_g, _ = rtrc(x0, mask0, origin=x0, max_iter=15, svt_method="gram")
    np.testing.assert_allclose(np.asarray(hr_w), np.asarray(hr_g), rtol=1e-5, atol=1e-6)

    # qualifying shape: thin sides 150/160 >= WARM_MIN_DIM=128 -> bases
    # actually carried; warm:2 must track the exact path
    from tritd_tpu.ops.svt import WARM_MIN_DIM

    assert WARM_MIN_DIM <= 150
    x1 = low_cp(jax.random.fold_in(rng_key, 5), (150, 4, 160), 3) * 5.0
    z_w, _, h_w, _ = tt_trpca(x1, origin=x1, max_iter=20, svt_method="warm:2")
    z_g, _, h_g, _ = tt_trpca(x1, origin=x1, max_iter=20, svt_method="gram")
    assert np.max(np.abs(np.asarray(h_w) - np.asarray(h_g))) < 5e-2
    rel_x = float(jnp.linalg.norm((z_w - z_g).ravel()) / jnp.linalg.norm(z_g.ravel()))
    assert rel_x < 1e-2

    mask1 = jnp.ones(x1.shape, bool)
    x_w, _, hr_w, _ = rtrc(x1, mask1, origin=x1, max_iter=20, svt_method="warm:2")
    x_g, _, hr_g, _ = rtrc(x1, mask1, origin=x1, max_iter=20, svt_method="gram")
    assert np.max(np.abs(np.asarray(hr_w) - np.asarray(hr_g))) < 5e-2
    rel_x = float(jnp.linalg.norm((x_w - x_g).ravel()) / jnp.linalg.norm(x_g.ravel()))
    assert rel_x < 1e-2


def test_warm_period_one_is_exact(rng_key):
    """warm:1 refreshes every iteration — it must equal the exact gram
    path to float tolerance even when bases ARE carried (thin side >=
    WARM_MIN_DIM), across chunk boundaries."""
    from tritd_tpu.baselines.rc_fctn import rc_fctn
    from tritd_tpu.ops.svt import WARM_MIN_DIM

    assert WARM_MIN_DIM <= 160
    ks = jax.random.split(rng_key, 4)
    us = [jax.random.normal(k, (s, 2)) for k, s in zip(ks, (150, 4, 8, 20))]
    x = jnp.einsum("ir,jr,kr,lr->ijkl", *us) * 2.0  # bipartition 600x160
    ind = jnp.ones_like(x)
    h_w = rc_fctn(x, 1.0, ind, origin=x, f=0.1, max_iter=10,
                  svt_method="warm:1", chunk=4)[2]
    h_g = rc_fctn(x, 1.0, ind, origin=x, f=0.1, max_iter=10,
                  svt_method="gram")[2]
    np.testing.assert_allclose(np.asarray(h_w), np.asarray(h_g),
                               rtol=1e-4, atol=1e-5)


def test_rc_fctn_warm_route_small_shape_equals_gram(rng_key):
    """"warm:<K>" on CPU-test shapes (every thin side < WARM_MIN_DIM)
    must be numerically identical to the exact gram path — the warm carry
    machinery is inert until a bipartition qualifies."""
    from tritd_tpu.baselines.rc_fctn import rc_fctn

    x = jax.random.normal(rng_key, (6, 5, 4, 3)) * 2.0
    ind = jnp.ones_like(x)
    out_w = rc_fctn(x, lam=1.0, ind_obs=ind, origin=x, f=0.1, max_iter=12,
                    svt_method="warm:3")
    out_g = rc_fctn(x, lam=1.0, ind_obs=ind, origin=x, f=0.1, max_iter=12,
                    svt_method="gram")
    np.testing.assert_allclose(
        np.asarray(out_w[2]), np.asarray(out_g[2]), rtol=1e-5, atol=1e-6
    )


def test_svt_default_is_svd():
    """r2 advisor (medium): plain svt defaults to the backward-stable SVD
    path; gram is an explicit opt-in for the hot path."""
    import inspect

    assert inspect.signature(svt).parameters["method"].default == "svd"
    assert inspect.signature(svt_ref_compat).parameters["method"].default == "svd"


def test_capped_simplex_projection(rng_key):
    v = jax.random.normal(rng_key, (50,)) * 2.0
    s = 7.0
    x = capped_simplex_projection(v, s)
    xn = np.asarray(x)
    assert (xn >= -1e-6).all() and (xn <= 1 + 1e-6).all()
    np.testing.assert_allclose(xn.sum(), s, atol=1e-4)
    # KKT: x = clip(v - tau, 0, 1) for a single scalar tau
    interior = (xn > 1e-5) & (xn < 1 - 1e-5)
    taus = np.asarray(v)[interior] - xn[interior]
    if interior.sum() > 1:
        assert np.ptp(taus) < 1e-4


def test_flsa_matches_cvx_style_reference(rng_key):
    """FLSA against a brute-force coordinate solution on a tiny problem."""
    v = jnp.array([4.0, 3.8, -1.0, -1.2, 0.1])
    lam1, lam2 = 0.1, 0.5
    x = flsa(v, lam1, lam2, iters=2000)

    # brute force: projected gradient on the primal objective
    xs = np.asarray(v).copy()
    for _ in range(20000):
        g = xs - np.asarray(v)
        # subgradients via smoothing
        eps = 1e-8
        g += lam1 * xs / np.sqrt(xs**2 + eps)
        d = np.diff(xs)
        sg = d / np.sqrt(d**2 + eps)
        g[:-1] -= lam2 * sg
        g[1:] += lam2 * sg
        xs -= 1e-3 * g
    np.testing.assert_allclose(np.asarray(x), xs, atol=2e-2)


def test_flsa_constant_region():
    """Strong fusion penalty makes the signal constant; lam1 then shrinks."""
    v = jnp.array([1.0, 2.0, 3.0, 2.0, 1.0])
    x = flsa(v, 0.0, 100.0, iters=500)
    np.testing.assert_allclose(np.asarray(x), np.full(5, np.mean(np.asarray(v))), atol=1e-3)


def test_kron_g_h_equal_full_builds(cores):
    from tritd_tpu.ops import kron_g, kron_h

    a, b, c, _ = cores
    np.testing.assert_allclose(
        np.asarray(kron_g(a, c)), np.asarray(build_g(a, c, "full")), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(kron_h(a, b)), np.asarray(build_h(a, b, "full")), rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize("method", ["gram", "svd", "lowrank:4"])
def test_svt_gemms_carry_highest_precision(rng_key, method):
    """The SVT routes' GEMMs run at full float32 (the Gram-eigh error
    analysis assumes f32 eps), whatever the backend's default."""
    highest = jax.lax.Precision.HIGHEST
    m = jax.random.normal(rng_key, (6, 40))
    jaxpr = jax.make_jaxpr(lambda m: svt_ref_compat(m, 0.5, method=method))(m)
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    for sub in jaxpr.jaxpr.eqns:
        inner = getattr(sub.params.get("jaxpr"), "jaxpr", None)
        if inner is not None:
            dots += [e for e in inner.eqns if e.primitive.name == "dot_general"]
    assert dots
    for eqn in dots:
        assert eqn.params["precision"] == (highest, highest)
