"""On-device validation of the warm-started SVT ("warm:<K>") against the
exact Gram-eigh path, per baseline method and benchmark dataset.

The expensive case is any unfolding with a big thin side — chicago's
4-way bipartition 5929x2016 (RC-FCTN), its TT cut 5929x2016 (TTNN) and its
circular unfolding 5929x2016 (RING) all pay a 2016-wide eigh per
iteration on the exact path, and the retained spectrum is NOT low-rank
(>=76%), so the randomized top-k route is invalid. The warm route reuses
the previous refresh's singular basis (stale-basis GEMM projection) and
refreshes the exact Gram-eigh every K-th iteration
(`ops/svt.py::svt_ref_compat_warm` / `svt_warm`).

Protocol: exactly the bench row's — `cli.run_completion.run_method` with
the driver presets, 10% uniform missing, origin-oracle err_hist; the exact
"gram" route is the reference, warm:K the candidate.

Usage: python tools/validate_warm_svt.py [--method fctn|ttnn|ring]
       [--dataset chicago] [--iters 100] [--ks 2,4,8]
       [--ref-cache ref.npz] [--out result.json]

Run it on the GPU. --ref-cache stores the gram reference history/X, so a
later process (e.g. one K per process) skips the exact solve. The per-cell
routes in bench.py were validated on another machine and are due to be
re-validated on the H100 with this tool.
"""
import argparse
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from tritd_tpu.cli.run_completion import run_method
from tritd_tpu.data import load_dataset, uniform_missing_mask


def main() -> None:
    from tritd_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--method", default="fctn", choices=("fctn", "ttnn", "ring"))
    p.add_argument("--dataset", default="chicago")
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--ks", default="2,4,8")
    p.add_argument("--out", default=None)
    p.add_argument("--ref-cache", default=None,
                   help=".npz path caching the exact-gram reference run")
    p.add_argument("--data-seeds", default=None,
                   help="comma-separated seeds: draw a FRESH mixed-family"
                   " traffic stand-in at the dataset's shape per seed"
                   " (same jit programs — shapes are static — so one"
                   " process handles every seed; basis-drift is data-"
                   "dependent, this hardens the one-seed validation)")
    a = p.parse_args()

    t0 = time.perf_counter()
    x_np, spec, prov = load_dataset(a.dataset)
    key = jax.random.PRNGKey(0)

    def problem_for(x_np):
        x = jnp.asarray(x_np, jnp.float32)
        if spec.kind == "video":
            # bench.py's video protocol: nothing missing
            return x, jnp.ones(x.shape, bool), x
        mask = uniform_missing_mask(key, x.shape, 0.10)
        return x, mask, jnp.where(mask, x, 0.0)

    x, mask, y = problem_for(x_np)
    np.asarray(y[0, 0, 0])
    print(f"setup {time.perf_counter() - t0:.1f}s "
          f"({a.method}@{a.dataset}, provenance={prov})", flush=True)
    missing_ratio = 0.0 if spec.kind == "video" else 0.10

    def solve(route):
        """One timed solve of the CURRENT (x, mask, y) problem — shared by
        the seed sweep and the route comparison so the honest-fence/timing
        pattern cannot drift between the two (r4 review)."""
        t0 = time.perf_counter()
        xh, _o, hist = run_method(
            a.method, y, x, mask, spec, key, a.iters, svt_method=route
        )
        hist = np.asarray(hist)
        float(jnp.linalg.norm(xh.ravel()))  # host fetch = honest fence
        dt = time.perf_counter() - t0
        print(f"  {route}: {dt:.1f}s err[first,last]={hist[0]:.4g},{hist[-1]:.4g}",
              flush=True)
        return jnp.asarray(xh), hist, dt

    if a.data_seeds is not None:
        from tritd_tpu.data.loaders import DATASETS, synthetic_traffic

        assert spec.kind == "traffic", "--data-seeds sweeps traffic stand-ins"
        sweep = []
        for seed in (int(s) for s in a.data_seeds.split(",")):
            x, mask, y = problem_for(
                synthetic_traffic(DATASETS[a.dataset], jax.random.PRNGKey(seed), seed)
            )
            np.asarray(y[0, 0, 0])
            print(f"data seed {seed}:", flush=True)
            xg, hg, _ = solve("gram")
            for kk in (int(v) for v in a.ks.split(",")):
                try:
                    xw, hw, _ = solve(f"warm:{kk}")
                except Exception as exc:  # noqa: BLE001 — second warm:<K>
                    # compile in one process can SIGKILL the remote compile
                    # helper (module docstring): record, keep earlier results
                    sweep.append({"seed": seed, "method": f"warm:{kk}",
                                  "error": repr(exc)[:300]})
                    print(f"  -> warm:{kk} FAILED: {exc!r}", flush=True)
                    continue
                adiff = np.abs(hw - hg)
                sweep.append({
                    "seed": seed, "method": f"warm:{kk}",
                    "max_abs_hist_diff": float(adiff.max()),
                    "argmax_hist_diff_iter": int(np.argmax(adiff)),
                    "hist_gram_at_argmax": float(hg[int(np.argmax(adiff))]),
                    "rel_final_x_diff": float(
                        jnp.linalg.norm((xw - xg).ravel())
                        / jnp.linalg.norm(xg.ravel())
                    ),
                })
                print(f"  -> |dh|={sweep[-1]['max_abs_hist_diff']:.2e} "
                      f"relX={sweep[-1]['rel_final_x_diff']:.2e}", flush=True)
        ok_rows = [r for r in sweep if "error" not in r]
        result = {
            "protocol": {"solver": a.method, "dataset_shape_of": a.dataset,
                         "iters": a.iters, "missing_ratio": missing_ratio,
                         "fresh_mixed_family_standin_per_seed": True},
            "sweep": sweep,
            "worst_max_abs_hist_diff": max(
                (r["max_abs_hist_diff"] for r in ok_rows), default=None),
            "worst_rel_final_x_diff": max(
                (r["rel_final_x_diff"] for r in ok_rows), default=None),
        }
        print(json.dumps(result, indent=1))
        if a.out:
            with open(a.out, "w") as fh:
                json.dump(result, fh, indent=1)
            print(f"wrote {a.out}")
        return

    if a.ref_cache and os.path.exists(a.ref_cache):
        z = np.load(a.ref_cache)
        xg, hg, tg2 = jnp.asarray(z["xg"]), z["hg"], float(z["tg2"])
        assert z["iters"] == a.iters, "ref cache was run at different --iters"
        print(f"  gram (cached): {tg2:.1f}s err[last]={hg[-1]:.4g}", flush=True)
    else:
        xg, hg, tg = solve("gram")
        _, _, tg2 = solve("gram")  # jit-cached, same cache state as warm reps
        if a.ref_cache:
            np.savez(a.ref_cache, xg=np.asarray(xg), hg=hg, tg2=tg2,
                     iters=a.iters)

    rows = []
    for kk in (int(v) for v in a.ks.split(",")):
        meth = f"warm:{kk}"
        try:
            xw, hw, tw = solve(meth)          # cold compile
            _, _, tw2 = solve(meth)           # warm cache
        except Exception as exc:  # noqa: BLE001 — helper OOM: record, go on
            rows.append({"method": meth, "error": repr(exc)[:300]})
            print(f"  -> {meth} FAILED: {exc!r}", flush=True)
            continue
        adiff = np.abs(hw - hg)
        k_worst = int(np.argmax(adiff))
        rows.append({
            "method": meth,
            "seconds_cold": round(tw, 1),
            "seconds_warm_cache": round(tw2, 1),
            "max_abs_hist_diff": float(adiff.max()),
            "argmax_hist_diff_iter": k_worst,
            "hist_gram_at_argmax": float(hg[k_worst]),
            "max_rel_hist_diff": float(np.max(adiff / np.maximum(hg, 1e-12))),
            "rel_final_x_diff": float(
                jnp.linalg.norm((xw - xg).ravel()) / jnp.linalg.norm(xg.ravel())
            ),
            "speedup_vs_gram": round(tg2 / tw2, 2),
        })
        print(f"  -> max|dhist|={rows[-1]['max_abs_hist_diff']:.2e} "
              f"relX={rows[-1]['rel_final_x_diff']:.4f} "
              f"speedup={rows[-1]['speedup_vs_gram']}", flush=True)

    result = {
        "protocol": {
            "solver": a.method, "dataset": a.dataset, "shape": list(x.shape),
            "iters": a.iters, "provenance": prov,
            "missing_ratio": missing_ratio,
            "gram_seconds_warm_cache": round(tg2, 1),
            "err_last_gram": float(hg[-1]),
        },
        "rows": rows,
    }
    print(json.dumps(result, indent=1))
    if a.out:
        with open(a.out, "w") as fh:
            json.dump(result, fh, indent=1)
        print(f"wrote {a.out}")


if __name__ == "__main__":
    main()
