"""On-device validation of the randomized top-k SVT inside RC-FCTN's video
protocol.

Runs the highway-shape video solve twice — exact Gram-eigh SVT vs the
production route (randomized top-k on the square-ish bipartitions) — and
reports the err_hist agreement and final-X distance. The route was
validated on another machine (max |hist_l - hist_g| = 2.0e-05, relative
final-X difference 0.0045) and is due to be re-validated on the H100.

Usage:
  python tools/validate_lowrank_svt.py [n_iters=50] [method=auto:512]
      one run on the seeded highway stand-in (method e.g. "lowrank:512" to
      validate a non-default budget);
  python tools/validate_lowrank_svt.py --seeds 0,1,2 [--iters 50]
      [--method auto:512] [--out seeds.json]
      seed sweep: per seed, draw a FRESH highway-shaped
      synthetic video (different data, hence different iterate spectra near
      the discontinuous `>1` truncation gate) and compare the routes;
      writes a JSON artifact with per-seed deltas.

Run it on the GPU.
"""
import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from tritd_tpu.baselines.rc_fctn import _split_mode3, rc_fctn
from tritd_tpu.data import load_dataset
from tritd_tpu.data.synthetic import synthetic_video


def compare_routes(y4, ind, n_iters: int, method: str) -> dict:
    """Solve with `method` and with exact gram; return agreement stats."""
    if method == "gram":
        # the dict below is keyed by label, so gram-vs-gram would compare
        # an array against itself and report a fake perfect validation
        raise ValueError("method='gram' IS the reference route — pick the"
                         " candidate route to validate (e.g. 'auto:512')")
    res = {}
    for label, meth, chunk in ((method, method, 25), ("gram", "gram", 5)):
        t0 = time.perf_counter()
        xh, _, hist = rc_fctn(
            y4, 1.8, ind, origin=y4, f=0.7, max_iter=n_iters,
            svt_method=meth, chunk=chunk,
        )
        hist = np.asarray(hist)
        res[label] = (hist, jnp.asarray(xh), time.perf_counter() - t0)
        print(
            f"  {label}: {res[label][2]:.1f}s "
            f"err[first,last]={hist[0]:.4g},{hist[-1]:.4g}", flush=True,
        )
    hl, hg = res[method][0], res["gram"][0]
    xl, xg = res[method][1], res["gram"][1]
    return {
        "max_abs_hist_diff": float(np.max(np.abs(hl - hg))),
        "rel_final_x_diff": float(
            jnp.linalg.norm((xl - xg).ravel()) / jnp.linalg.norm(xg.ravel())
        ),
        "err_last_gram": float(hg[-1]),
        "seconds": {method: round(res[method][2], 1),
                    "gram": round(res["gram"][2], 1)},
    }


def highway_problem():
    x_np, spec, _ = load_dataset("highway")
    x = jnp.asarray(x_np, jnp.float32)
    return x, spec.fctn_subdim


def seed_sweep(seeds, n_iters: int, method: str, out: str | None) -> None:
    shape = (240, 320, 300)
    sub = 20
    rows = []
    for seed in seeds:
        print(f"seed {seed}:", flush=True)
        observed, _bg, _fg = synthetic_video(jax.random.PRNGKey(seed), shape)
        x = jnp.asarray(observed, jnp.float32)
        y4 = _split_mode3(x, sub, shape[2] // sub)
        ind = _split_mode3(jnp.ones(shape, x.dtype), sub, shape[2] // sub)
        np.asarray(y4[0, 0, 0, 0])  # fence data onto device
        stats = compare_routes(y4, ind, n_iters, method)
        rows.append({"seed": seed, **stats})
        print(f"  -> max|dhist|={stats['max_abs_hist_diff']:.2e} "
              f"rel final-X={stats['rel_final_x_diff']:.4f}", flush=True)
    result = {
        "protocol": {
            "shape": list(shape), "subdim": sub, "n_iters": n_iters,
            "method": method, "note": (
                "per-seed fresh highway-shaped synthetic video; gram route"
                " is the exact reference-semantics path (ref quirk"
                " lib/SVT.m:8 r=sum(S>1)); hardens the one-seed r3"
                " validation of the discontinuous truncation gate"
            ),
        },
        "seeds": rows,
        "worst_max_abs_hist_diff": max(r["max_abs_hist_diff"] for r in rows),
        "worst_rel_final_x_diff": max(r["rel_final_x_diff"] for r in rows),
    }
    print(json.dumps(result, indent=1))
    if out:
        with open(out, "w") as fh:
            json.dump(result, fh, indent=1)
        print(f"wrote {out}")


def main() -> None:
    if "--seeds" in sys.argv:
        p = argparse.ArgumentParser()
        p.add_argument("--seeds", required=True)
        p.add_argument("--iters", type=int, default=50)
        p.add_argument("--method", default="auto:512")
        p.add_argument("--out", default=None)
        a = p.parse_args()
        seed_sweep(
            [int(s) for s in a.seeds.split(",")], a.iters, a.method, a.out
        )
        return

    n_iters = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    method = sys.argv[2] if len(sys.argv) > 2 else "auto:512"
    t0 = time.perf_counter()
    x, sub = highway_problem()
    y4 = _split_mode3(x, sub, x.shape[2] // sub)
    ind = _split_mode3(jnp.ones(x.shape, x.dtype), sub, x.shape[2] // sub)
    np.asarray(y4[0, 0, 0, 0])
    print(f"setup {time.perf_counter() - t0:.1f}s", flush=True)
    stats = compare_routes(y4, ind, n_iters, method)
    print(f"max |hist_{method} - hist_gram| =", stats["max_abs_hist_diff"])
    print("rel final-X diff =", stats["rel_final_x_diff"])


if __name__ == "__main__":
    main()
