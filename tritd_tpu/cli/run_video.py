"""Video background-modeling driver — `video_triple_comparison.m` parity.

Protocol (reference `:4-67`): CDnet sequences as (H, W, T) grayscale
tensors, missing rate 0, run the robust solver with the video preset, report
RMSE/NRMSE on missing entries, sparse-vs-observed, total reconstruction,
PSNR/SSIM; save `<name>_raw` and `<name>_<method>_{errHist,Xhat,O}`
artifacts; optional F1/PWC/mAP foreground scores when ground-truth labels
exist.

Note: the committed reference calls `triple_decomp_ADMM_outlier`, which
dispatches nowhere (SURVEY §2.1 defect) — the intended solver is the same
ADMM with video presets, which is what runs here (--method triple). The
nonconvex weighted variant is available as --method outlier.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..data import load_dataset, load_groundtruth, uniform_missing_mask
from ..metrics.foreground import foreground_scores, mean_average_precision
from ..metrics.image import quality
from ..metrics.recon import evaluate
from ..ops.designs import triple_product
from ..solvers import OutlierConfig, tritd_admm, tritd_admm_outlier, trim_history
from ..utils import artifacts
from ..utils.config import VIDEO_DATASETS, VIDEO_TRITD

METHOD_NAMES = ("triple", "outlier", "ttnn", "ring", "fctn", "sofia")


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--datasets", nargs="+", default=list(VIDEO_DATASETS))
    p.add_argument("--method", default="triple", choices=METHOD_NAMES)
    p.add_argument("--missing-ratio", type=float, default=0.0)
    p.add_argument("--max-iter", type=int, default=100)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--out-dir", default="results")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fg-threshold", type=float, default=50.0)
    p.add_argument(
        "--svt-method", default="svd",
        help="SVT route for the SVT-ADMM baselines (see run_completion)",
    )
    p.add_argument(
        "--platform", default=None, choices=("cpu", "gpu"),
        help="run on this JAX backend instead of the default one",
    )
    p.add_argument(
        "--verify-parity", action="store_true",
        help="after the run, assert every row beats the reference's"
        " published wall-clock (README.md:71-77 — the only per-cell video"
        " number the reference publishes) and exit nonzero otherwise;"
        " requires the real .mat sequences (synthetic stand-ins fail"
        " loudly — see docs/DATA.md)",
    )
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
        artifacts.save_raw(args.out_dir, name, y)
        print(f"===== Dataset: {name} ({provenance}) shape={x.shape} =====")

        def solve():
            if args.method == "triple":
                cfg = dataclasses.replace(VIDEO_TRITD, max_iter=args.max_iter)
                res = tritd_admm(y, cfg, key=key, origin=x)
                return (triple_product(res.a, res.b, res.c), res.o,
                        np.asarray(trim_history(res.err_hist, res.n_iters)))
            if args.method == "outlier":
                cfg = OutlierConfig(rank=5, max_iter=args.max_iter)
                res = tritd_admm_outlier(y, cfg, key=key)
                return (triple_product(res.a, res.b, res.c), res.o,
                        np.asarray(trim_history(res.err_hist, res.n_iters)))
            from .run_completion import run_method

            return run_method(
                args.method, y, x, mask, spec, key, args.max_iter,
                svt_method=args.svt_method,
            )

        t0 = time.perf_counter()
        x_hat, o, err_hist = solve()
        jax.block_until_ready(x_hat)
        elapsed = time.perf_counter() - t0
        first_call_s, timing = elapsed, "first_call"
        if args.verify_parity:
            # The published MATLAB times contain no jit compile; a cold first
            # call includes it, so the parity check would spuriously fail on
            # the run it exists for. Re-time a warm solve — the same
            # protocol bench.py measures.
            t0 = time.perf_counter()
            x_hat, o, err_hist = solve()
            jax.block_until_ready(x_hat)
            elapsed = time.perf_counter() - t0
            timing = "warm"

        missing = ~mask
        rmse_m, nrmse_m = evaluate(x_hat, x, missing) if args.missing_ratio else (0.0, 0.0)
        rmse_o, nrmse_o = evaluate(o, x, mask)
        rmse_t, nrmse_t = evaluate(x_hat + o, x, None)
        psnr_v, ssim_v = quality(x, x_hat)

        row = {
            "dataset": name,
            "method": args.method,
            "seconds": round(elapsed, 3),
            # timing protocol provenance (r4 advisor): rows timed with and
            # without --verify-parity differ (warm jit-cached vs first
            # call); record both so saved artifacts stay comparable.
            "timing": timing,
            **({"seconds_first_call": round(first_call_s, 3)}
               if timing == "warm" else {}),
            **({"svt_method": args.svt_method}
               if args.method in ("ttnn", "ring", "fctn") else {}),
            "iters": int(len(err_hist)),
            "rmse_missing": float(rmse_m),
            "nrmse_missing": float(nrmse_m),
            "rmse_sparse": float(rmse_o),
            "nrmse_sparse": float(nrmse_o),
            "rmse_total": float(rmse_t),
            "nrmse_total": float(nrmse_t),
            "psnr": float(psnr_v),
            "ssim": float(ssim_v),
            "provenance": provenance,
        }

        gt = load_groundtruth(name, args.data_dir)
        if gt is None and provenance == "synthetic":
            # Synthetic stand-in: score against its OWN moving-object truth
            # (bench.py does the same; labels use the CDnet 0/255 convention
            # so the scorer's non-ROI-170 handling stays exercised).
            from ..data import synthetic_video_truth

            _, _, fg_mask = synthetic_video_truth(spec)
            gt = np.where(np.asarray(fg_mask), 255.0, 0.0)
        if gt is not None:
            scores = foreground_scores(np.asarray(o), gt, args.fg_threshold)
            row.update(
                precision=scores.precision, recall=scores.recall,
                f1=scores.f1, pwc=scores.pwc,
                map=mean_average_precision(np.asarray(o), gt),
            )

        artifacts.save_artifact(args.out_dir, name, args.method, "errHist", err_hist)
        artifacts.save_artifact(args.out_dir, name, args.method, "Xhat", x_hat)
        artifacts.save_artifact(args.out_dir, name, args.method, "O", o)
        rows.append(row)
        print(json.dumps(row))

    if args.verify_parity:
        from ..utils.published import check_parity

        failures = check_parity(
            rows, max_iter=args.max_iter, missing_ratio=args.missing_ratio
        )
        if failures:
            for msg in failures:
                print(f"PARITY FAIL {msg}")
            raise SystemExit(1)
        print(f"PARITY OK: {len(rows)} rows beat README.md:71-77 wall-clock")
    return rows


if __name__ == "__main__":
    main()
