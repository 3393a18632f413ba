"""Shared solver configuration and result containers."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class TriTDConfig:
    """Hyperparameters of the TriTD solvers.

    Defaults reproduce the completion driver's TriTD preset
    (`traffic_triple_comparison.m:42-51`); the video preset
    (`video_triple_comparison.m:41-49`) is in
    :data:`tritd_tpu.utils.config.VIDEO_TRITD`.
    Frozen + hashable so it can be a jit static argument.
    """

    rank: int = 5
    max_iter: int = 100
    tol: float = 1e-5
    mu: float = 1e-3                # opts.mu — initial muL and muO
    rho: float = 1.25               # opts.rho — mu growth per iteration
    lambda_l1: float = 1.8          # opts.lambda — weight on ||E||_1
    lambda2: float = 1e-3           # opts.lambda2 — ridge for A and B solves
    alpha_c: float = 1e-9           # fixed ridge for the C solve
                                    # (`triple_decomp_ADMM.m:93`)
    mu_cap_factor: float = 1e6      # muL_max = mu * 1e6 (`:17-18`)
    variant: str = "hadamard"       # "hadamard" | "full" contraction
    solve_method: str = "cholesky"  # "cholesky" | "pinv" | "lstsq"
    dtype: str = "float32"
    masked: bool = False            # True: impute unobserved entries with
                                    # L + O each iteration (extension; the
                                    # reference's triple_ADMM_masked is
                                    # absent — `traffic_triple_comparison.m:53`)
    disp: bool = False              # print residuals every 10 iterations via
                                    # jax.debug.print — the reference's
                                    # opts.disp/fprintf (`:60-62`)
    einsum_dtype: str | None = None  # optional "bfloat16" input precision for
                                     # the O(n^3 r^2) RHS contractions (f32
                                     # accumulation); None = full float32
    storage_dtype: str | None = None  # optional "bfloat16" HBM storage for
                                      # the data-sized tensors (D, O, E, Y_L,
                                      # Y_O, L). The elementwise block loads
                                      # them, UPCASTS to the solver dtype in
                                      # registers, computes, and downcasts the
                                      # stores — norms, duals' arithmetic and
                                      # the mode solves stay f32, so only the
                                      # HBM representation narrows. Halves the
                                      # bandwidth of the roofline-bound
                                      # elementwise pass; adds ~0.4% relative
                                      # rounding per carried value, which the
                                      # ADMM feedback absorbs (tests pin RRE
                                      # parity). None = store in cfg.dtype.
    unroll: int = 1                 # iterations per while_loop step. >1
                                    # amortizes the loop/dispatch latency
                                    # floor that dominates SMALL problems
                                    # (sensor/network) and lets XLA pipeline
                                    # across iterations. The stopping rule is
                                    # checked every `unroll` iterations, so an
                                    # early-stopped run may do up to unroll-1
                                    # extra (convergent) iterations; the
                                    # trajectory is otherwise unchanged.

    def jnp_einsum_dtype(self):
        return None if self.einsum_dtype is None else jnp.dtype(self.einsum_dtype)

    def jnp_storage_dtype(self):
        """HBM dtype of the data-sized tensors (falls back to cfg.dtype)."""
        return jnp.dtype(self.dtype if self.storage_dtype is None else self.storage_dtype)

    def jnp_dtype(self):
        return jnp.dtype(self.dtype)


class TriTDState(NamedTuple):
    """ADMM state pytree — the checkpointable unit (SURVEY §5 checkpoint row)."""

    a: jnp.ndarray        # (n1, r, r)
    b: jnp.ndarray        # (r, n2, r)
    c: jnp.ndarray        # (r, r, n3)
    o: jnp.ndarray        # (n1, n2, n3) sparse component
    e: jnp.ndarray        # (n1, n2, n3) l1 clone of O
    y_l: jnp.ndarray      # dual for D - L - O
    y_o: jnp.ndarray      # dual for O - E
    t: jnp.ndarray        # carried factor-solve target D - O + Y_L/muL for
                          # the NEXT iteration; produced inside the fused
                          # elementwise block (whose registers already hold
                          # D, O, Y_L) to save three full-tensor HBM reads
                          # per iteration. Derivable from (d, o, y_l, mu_l);
                          # carried in checkpoints so resume is exact.
                          # Stored in einsum_dtype when set (bf16 knob).
    mu_l: jnp.ndarray     # scalar penalty (annealed)
    mu_o: jnp.ndarray     # scalar penalty (annealed)
    k: jnp.ndarray        # iteration counter (int32)
    err_hist: jnp.ndarray  # (max_iter,) combined residual history
    rre_hist: jnp.ndarray  # (max_iter,) oracle RRE vs origin (NaN if none)
    done: jnp.ndarray     # bool convergence flag


class TriTDResult(NamedTuple):
    """What a solver returns. err_hist/rre_hist are fixed (max_iter,) arrays;
    entries at index >= n_iters are NaN."""

    a: jnp.ndarray
    b: jnp.ndarray
    c: jnp.ndarray
    o: jnp.ndarray
    e: jnp.ndarray
    err_hist: jnp.ndarray
    rre_hist: jnp.ndarray
    n_iters: jnp.ndarray


def trim_history(hist, n_iters) -> jnp.ndarray:
    """Host-side helper: slice a fixed-size history down to the iterations
    actually run (the reference's `errHist = errHist(1:k)` idiom)."""
    import numpy as np

    return np.asarray(hist)[: int(n_iters)]
