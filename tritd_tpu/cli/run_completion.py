"""Tensor-completion benchmark driver — `traffic_triple_comparison.m` parity.

Protocol (reference `:4-35,42-63`): rng seed 0, for each dataset draw a
uniform missing mask of `missing_ratio * numel` entries, zero-fill, run the
enabled methods, report RRE over all entries + wall-clock, save
`<dataset>_<method>_errHist` artifacts.

Usage:
  python -m tritd_tpu.cli.run_completion --datasets sensor taxi \\
      --methods triple --missing-ratio 0.10 --out-dir results
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..data import load_dataset, uniform_missing_mask
from ..metrics.recon import evaluate
from ..ops.designs import triple_product
from ..solvers import tritd_admm, trim_history
from ..utils import artifacts
from ..utils.config import (
    COMPLETION_DATASETS,
    COMPLETION_MISSING_RATIO,
    COMPLETION_TRITD,
)

METHOD_NAMES = ("triple", "triple_masked", "ttnn", "ring", "fctn", "sofia")


def run_method(method, y, x, mask, spec, key, max_iter, svt_method="svd"):
    """Dispatch one method; returns (x_hat, o, err_hist).

    Preset selection follows the dataset kind: traffic datasets use the
    traffic-driver baseline presets (`traffic_triple_comparison.m:116-168`),
    video datasets the video-driver ones — RTRC mu=1e-3
    (`video_triple_comparison.m:150`), the FCTN video reshape/lambda
    (`:240-262`), SOFIA period m=1 (`:83`; carried in spec.sofia_period).
    `svt_method="gram"` opts the SVT baselines into the Gram-eigh path
    (ops/svt.py)."""
    video = spec.kind == "video"
    if method == "triple":
        cfg = dataclasses.replace(COMPLETION_TRITD, max_iter=max_iter)
        res = tritd_admm(y, cfg, key=key, origin=x)
        x_hat = triple_product(res.a, res.b, res.c)
        return x_hat, res.o, np.asarray(trim_history(res.err_hist, res.n_iters))
    if method == "triple_masked":
        cfg = dataclasses.replace(COMPLETION_TRITD, max_iter=max_iter, masked=True)
        res = tritd_admm(y, cfg, key=key, mask=mask, origin=x)
        x_hat = triple_product(res.a, res.b, res.c)
        return x_hat, res.o, np.asarray(trim_history(res.err_hist, res.n_iters))
    if method == "ttnn":
        from ..baselines.ttnn import tt_trpca

        z, s, err_hist, n = tt_trpca(
            y, origin=x, max_iter=max_iter, svt_method=svt_method
        )
        return z, s, np.asarray(err_hist)[: int(n)]
    if method == "ring":
        from ..baselines.rtrc import rtrc
        from ..utils.config import RING_PRESET

        mu = RING_PRESET.mu_video if video else RING_PRESET.mu_completion
        xh, o, err_hist, n = rtrc(
            y, mask, mu=mu, origin=x, max_iter=max_iter, svt_method=svt_method
        )
        return xh, o, np.asarray(err_hist)[: int(n)]
    if method == "fctn":
        from ..baselines.rc_fctn import (
            rc_fctn_driver_traffic,
            rc_fctn_driver_video,
        )

        driver = rc_fctn_driver_video if video else rc_fctn_driver_traffic
        xh, s, err_hist = driver(
            y, mask, spec.fctn_subdim, origin=x, max_iter=max_iter,
            svt_method=svt_method,
        )
        return xh, s, np.asarray(err_hist)
    if method == "sofia":
        from ..baselines.sofia import sofia_init
        from ..utils.config import SOFIA_PRESET

        u, x_hat, o, err_hist = sofia_init(
            y, mask, SOFIA_PRESET.rank, spec.sofia_period,
            origin=x, max_epoch=max_iter,
        )
        return x_hat, o, np.asarray(err_hist)
    raise ValueError(f"unknown method {method!r}; known: {METHOD_NAMES}")


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--datasets", nargs="+", default=list(COMPLETION_DATASETS))
    p.add_argument("--methods", nargs="+", default=["triple"], choices=METHOD_NAMES)
    p.add_argument("--missing-ratio", type=float, default=COMPLETION_MISSING_RATIO)
    p.add_argument("--max-iter", type=int, default=100)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--out-dir", default="results")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--svt-method", default="svd",
        help="SVT route for the SVT-ADMM baselines: 'svd' (exact-reference"
        " numerics, default), 'gram' (Gram-eigh), 'auto'/'lowrank:<b>'"
        " (shape-routed randomized top-k; see ops/svt.py), 'warm:<K>'"
        " (warm-started basis, exact Gram-eigh refresh every K-th"
        " iteration — the fast route for big unfoldings whose retained"
        " spectrum is NOT low-rank; validate a cell with"
        " tools/validate_warm_svt.py). The randomized route is only valid for"
        " the tail-truncating baselines (ttnn/fctn) — plain-SVT methods"
        " (ring) reject it and accept 'auto' only when it resolves to"
        " gram. 'auto' is the recommended (and fctn-driver default) route"
        " for fctn on video shapes.",
    )
    p.add_argument(
        "--platform", default=None, choices=("cpu", "gpu"),
        help="run on this JAX backend instead of the default one",
    )
    p.add_argument(
        "--verify-parity", action="store_true",
        help="after the run, assert every row's RRE is within --parity-gap"
        " of the reference's published number (README.md:57-63) and exit"
        " nonzero otherwise; requires the real .mat datasets (synthetic"
        " stand-ins fail loudly — see docs/DATA.md)",
    )
    p.add_argument("--parity-gap", type=float, default=None,
                   help="absolute RRE tolerance for --verify-parity")
    args = p.parse_args(argv)
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from ..utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()

    rows = []
    for name in args.datasets:
        x_np, spec, provenance = load_dataset(name, args.data_dir)
        x = jnp.asarray(x_np, jnp.float32)
        key = jax.random.PRNGKey(args.seed)
        mask = uniform_missing_mask(key, x.shape, args.missing_ratio)
        y = jnp.where(mask, x, 0.0)
        print(f"===== Dataset: {name} ({provenance}) shape={x.shape} "
              f"missing={args.missing_ratio} =====")
        for method in args.methods:
            t0 = time.perf_counter()
            x_hat, o, err_hist = run_method(
                method, y, x, mask, spec, key, args.max_iter,
                svt_method=args.svt_method,
            )
            jax.block_until_ready(x_hat)
            elapsed = time.perf_counter() - t0
            first_call_s, timing = elapsed, "first_call"
            if args.verify_parity and spec.kind == "video":
                # video cells are judged on wall-clock; the published
                # MATLAB times contain no jit compile, so re-time a warm
                # solve (see run_video)
                t0 = time.perf_counter()
                x_hat, o, err_hist = run_method(
                    method, y, x, mask, spec, key, args.max_iter,
                    svt_method=args.svt_method,
                )
                jax.block_until_ready(x_hat)
                elapsed = time.perf_counter() - t0
                timing = "warm"
            _, rre_all = evaluate(x_hat, x, None)
            row = {
                "dataset": name,
                "method": method,
                "rre": float(rre_all),
                "seconds": round(elapsed, 3),
                # timing protocol provenance (r4 advisor): warm re-timed
                # rows must be distinguishable from first-call rows.
                "timing": timing,
                **({"seconds_first_call": round(first_call_s, 3)}
                   if timing == "warm" else {}),
                **({"svt_method": args.svt_method}
                   if method in ("ttnn", "ring", "fctn") else {}),
                "iters": int(len(err_hist)),
                "provenance": provenance,
            }
            rows.append(row)
            artifacts.save_artifact(args.out_dir, name, method, "errHist", err_hist)
            print(json.dumps(row))

    if args.verify_parity:
        from ..utils.published import DEFAULT_RRE_GAP, check_parity

        gap = DEFAULT_RRE_GAP if args.parity_gap is None else args.parity_gap
        failures = check_parity(
            rows, gap=gap, max_iter=args.max_iter,
            missing_ratio=args.missing_ratio,
        )
        if failures:
            for msg in failures:
                print(f"PARITY FAIL {msg}")
            raise SystemExit(1)
        print(f"PARITY OK: {len(rows)} rows within gap {gap} of README.md:57-63")
    return rows


if __name__ == "__main__":
    main()
