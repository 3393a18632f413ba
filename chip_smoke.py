"""Smoke test of the TriTD-ADMM main path on one GPU, at the published shapes.

    python chip_smoke.py                # one card: device, taxi, highway, CLI
    python chip_smoke.py --four-cards   # the three multi-card entry points

Phases, in order (each one raises on failure; nothing is caught):

* device   — refuse anything but a GPU; print its kind, count, the JAX
             version, and the card's name and power limit (nvidia-smi);
* taxi     — `bench.run_config("taxi")` (100x100x500, 10% missing, 100
             ADMM iterations); compile and solve times; err_hist against the
             float64 MATLAB-semantics emulator on the same data and init;
* highway  — `bench.run_config("highway")` on the 240x320x300 synthetic
             stand-in; times, PSNR/SSIM/F1/mAP, the solver program's memory
             analysis, peak device memory; the first iterations of err_hist
             against the same JAX solve on the CPU;
* cli      — `tritd-completion --datasets sensor --methods triple`,
             in-process.

The last line of standard output is the result,
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`;
it is printed only when every phase passed. Each phase is a function of its
device and sizes, so the CPU tests rehearse them at tiny sizes; only
:func:`main` insists on a GPU.
"""

from __future__ import annotations

import os

# The CPU backend stays available beside the GPU for the CPU reference solve.
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from tritd_tpu.oracle import tritd_admm_em  # noqa: E402
from tritd_tpu.solvers import admm, tritd_admm  # noqa: E402
from tritd_tpu.utils.compile_cache import enable_persistent_cache  # noqa: E402
from tritd_tpu.utils.device import gpu_device_info  # noqa: E402

#: Taxi err_hist (normalised by ||D||) against the float64 emulator. One
#: float32 solve's gap is one draw from a wide spread: which way each sum
#: rounds decides it. On one host, the input and eight copies moved by one
#: ulp gave 6.6e-6 to 2.8e-5 on the CPU and 1.2e-6 to 2.05e-5 on an H100
#: at HIGHEST; another host's CPU read 9.1e-7 on the input alone. So the
#: reference is the largest gap of TAXI_CPU_SAMPLES CPU solves (the input
#: and copies moved by one ulp in a random half of their entries), and the
#: card may be TAXI_CPU_GAP_FACTOR times that. Even if all four draws came
#: out at 9.1e-7, the bar would sit 2.2x over the card's worst draw; TF32
#: contractions read 8.4e-3, 6x past the bar at the widest CPU spread seen.
TAXI_CPU_SAMPLES = 4
TAXI_CPU_GAP_FACTOR = 50.0
#: Highway err_hist, first VIDEO_COMPARE_ITERS iterations, card vs the same
#: float32 HIGHEST solve on the CPU: largest relative gap allowed. Only the
#: order of the sums differs; an H100 measured 5.1e-5, TF32 contractions
#: 6.0e-3. The multi-card solves are held to the same bar against the
#: single-card solve.
VIDEO_CPU_RTOL = 5e-4
VIDEO_COMPARE_ITERS = 10
#: Past the first iterations float32 rounding decides the trajectory: the
#: residual stalls near 1e-4 (float64 goes on to 1e-8) and the gap between
#: two float32 runs wanders. Over the whole run a multi-card solve may
#: differ from the single-card solve by this many times the gap that a
#: one-ulp change of the input makes to the single-card solve (measured in
#: the same run, per video; on an H100 it read 7.7e-5 to 1.1e-3).
SENSITIVITY_FACTOR = 4.0


def _peak_bytes(device) -> int | None:
    stats = device.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _emulator_gap(res, em) -> tuple[float, int]:
    """max|err_hist - emulator err_hist| over the iterations both ran."""
    n = int(res.n_iters)
    hist = np.asarray(res.err_hist, np.float64)[:n]
    if not np.all(np.isfinite(hist)):
        raise AssertionError(f"non-finite err_hist: {hist}")
    m = min(n, em["n_iters"])
    return float(np.max(np.abs(hist[:m] - np.asarray(em["err_hist"])[:m]))), m


def phase_taxi(device, shape=None, info=None) -> dict:
    """Taxi completion through bench.run_config, checked against the
    float64 MATLAB-semantics emulator (same data, same init); the bar is a
    fixed factor over the largest gap of a few float32 CPU solves that
    differ from the card's input by at most one ulp."""
    from tritd_tpu.solvers.admm import init_factors

    with jax.default_device(device):
        row, solve = bench.run_config("taxi", jax, jnp, np, device=info,
                                      shape=shape)
        cfg = solve.cfg
        a0, b0, c0 = (
            np.asarray(u, np.float64)
            for u in init_factors(solve.key, solve.y.shape, cfg.rank,
                                  cfg.jnp_dtype())
        )
    print(f"taxi shape={row['shape']} compile_s={row['compile_s']}"
          f" solve_s={row['seconds']} n_iters={row['n_iters']}"
          f" rre={row['rre_all_entries']}")
    em = tritd_admm_em(
        np.asarray(solve.y, np.float64), a0, b0, c0, mu=cfg.mu, rho=cfg.rho,
        lam=cfg.lambda_l1, lam2=cfg.lambda2, alpha_c=cfg.alpha_c,
        max_iter=cfg.max_iter, tol=cfg.tol,
    )
    cpu = jax.devices("cpu")[0]
    y = np.asarray(solve.y, np.float32)
    rng = np.random.default_rng(0)
    cpu_gaps = []
    with jax.default_device(cpu):
        for i in range(TAXI_CPU_SAMPLES):
            v = y if i == 0 else np.where(
                rng.random(y.shape) < 0.5,
                np.nextafter(y, np.float32(np.inf)), y)
            res = tritd_admm(jax.device_put(v, cpu), cfg,
                             key=jax.device_put(solve.key, cpu))
            cpu_gaps.append(_emulator_gap(res, em)[0])
    gap, m = _emulator_gap(solve.result, em)
    bar = TAXI_CPU_GAP_FACTOR * max(cpu_gaps)
    print(f"taxi err_hist vs float64 emulator: max_abs_gap={gap:.3e}"
          f" over {m} iterations (n_iters card={int(solve.result.n_iters)}"
          f" emulator={em['n_iters']}); float32 CPU solves of the input"
          f" and of copies moved by one ulp: "
          + " ".join(f"{g:.3e}" for g in cpu_gaps)
          + f"; tolerance {TAXI_CPU_GAP_FACTOR:g}x the largest = {bar:.3e}")
    if gap > bar:
        raise AssertionError(
            f"taxi err_hist differs from the emulator by {gap:.3e} > {bar:.3e}"
        )
    return {"row": row, "emulator_gap": gap, "cpu_emulator_gaps": cpu_gaps}


def phase_video(device, shape=None, info=None) -> dict:
    """Highway background modelling through bench.run_config; memory
    analysis of the solver program; the first iterations of err_hist
    against the same float32 solve on the CPU."""
    with jax.default_device(device):
        row, solve = bench.run_config("highway", jax, jnp, np, device=info,
                                      shape=shape)
        cfg = solve.cfg
        dummy = jnp.zeros((1,), cfg.jnp_dtype())
        compiled = admm._admm_run.lower(
            solve.y, dummy, dummy, solve.key, cfg=cfg, has_mask=False,
            has_origin=False,
        ).compile()
    hist = np.asarray(solve.result.err_hist, np.float64)
    print(f"highway shape={row['shape']} compile_s={row['compile_s']}"
          f" solve_s={row['seconds']} n_iters={row['n_iters']}"
          f" psnr={row['psnr']} ssim={row['ssim']} f1={row.get('f1')}"
          f" map={row.get('map')}")
    print(f"highway solver memory_analysis: {compiled.memory_analysis()}")
    peak = _peak_bytes(device)
    print(f"highway peak_bytes_in_use={peak}")

    cpu = jax.devices("cpu")[0]
    k = min(VIDEO_COMPARE_ITERS, cfg.max_iter)
    with jax.default_device(cpu):
        ref = tritd_admm(
            jax.device_put(solve.y, cpu),
            dataclasses.replace(cfg, max_iter=k),
            key=jax.device_put(solve.key, cpu),
        )
        ref_hist = np.asarray(ref.err_hist, np.float64)
    rel = float(np.max(np.abs(hist[:k] - ref_hist) / np.abs(ref_hist)))
    print(f"highway err_hist[:{k}] vs CPU float32: max_rel_gap={rel:.3e}"
          f" tolerance={VIDEO_CPU_RTOL:.1e}")
    if not np.all(np.isfinite(hist[: int(solve.result.n_iters)])) or not (
        rel <= VIDEO_CPU_RTOL
    ):
        raise AssertionError(
            f"highway err_hist differs from the CPU solve by {rel:.3e}"
        )
    return {"row": row, "cpu_gap": rel, "peak_bytes_in_use": peak}


def phase_cli(device, max_iter: int = 100) -> list[dict]:
    """The `tritd-completion` console entry point, in-process."""
    from tritd_tpu.cli import run_completion

    with tempfile.TemporaryDirectory() as out, jax.default_device(device):
        rows = run_completion.main([
            "--datasets", "sensor", "--methods", "triple",
            "--max-iter", str(max_iter), "--out-dir", out,
        ])
        saved = sorted(os.listdir(out))
    print(f"cli rows={json.dumps(rows)} artifacts={saved}")
    if len(rows) != 1 or not np.isfinite(rows[0]["rre"]) or not saved:
        raise AssertionError(f"tritd-completion gave {rows}, saved {saved}")
    return rows


def phase_four_cards(devices, shape=None) -> dict:
    """The three multi-card entry points against `tritd_admm` on the first
    card: mode-1 slabs over all cards, a 2x2 ("data", "slab") batch of the
    four video stand-ins, and the GSPMD path with slab NamedSharding."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tritd_tpu.parallel import (
        make_mesh,
        slab_sharding,
        tritd_admm_auto,
        tritd_admm_batch_sharded,
        tritd_admm_sharded,
    )
    from tritd_tpu.utils.config import VIDEO_TRITD

    # tol=0: every solve runs all max_iter iterations, so whole histories
    # compare
    cfg = dataclasses.replace(VIDEO_TRITD, tol=0.0)
    key = jax.random.PRNGKey(0)
    names = ("highway", "sofa", "office", "PETS2006")
    # host arrays, placed straight into their shards: nothing of the state
    # lands on card 0 first
    videos = [bench.load_host(n, shape)[0].astype(np.float32) for n in names]
    one = videos[0]
    mesh_slab = make_mesh(n_slab=len(devices), devices=devices)
    mesh_2x2 = make_mesh(n_slab=2, n_data=2, devices=devices)
    one_in = jax.device_put(one, slab_sharding(mesh_slab))
    batch_in = jax.device_put(
        np.stack(videos), NamedSharding(mesh_2x2, P("data", "slab"))
    )
    print(f"inputs: d.sharding={one_in.sharding}"
          f" d_batch.sharding={batch_in.sharding}")

    runs = {}
    runs["sharded"] = tritd_admm_sharded(one_in, cfg, mesh_slab, key=key)
    runs["auto"] = tritd_admm_auto(one_in, cfg, mesh_slab, key=key)
    runs["batch_sharded"] = tritd_admm_batch_sharded(
        batch_in, cfg, mesh_2x2, key=key
    )
    for name, res in runs.items():
        jax.block_until_ready(res)
        print(f"{name}: o.sharding={res.o.sharding}"
              f" a.sharding={res.a.sharding}"
              f" err_hist.sharding={res.err_hist.sharding}")
    peaks = [_peak_bytes(d) for d in devices]
    print(f"peak_bytes_in_use per card after the sharded solves: {peaks}")
    if all(p is not None for p in peaks) and min(peaks) < one.nbytes // 2:
        raise AssertionError(f"state not spread over the cards: {peaks}")

    # single-card references, and each one's float32 sensitivity: the same
    # solve on the input moved by one ulp in a random half of its entries
    rng = np.random.default_rng(0)
    keys = [key, *jax.random.split(key, len(videos))]
    inputs = [one, *videos]
    refs, sens = [], []
    with jax.default_device(devices[0]):
        for v, kv in zip(inputs, keys):
            bumped = np.where(rng.random(v.shape) < 0.5,
                              np.nextafter(v, np.float32(np.inf)), v)
            r = np.asarray(tritd_admm(jnp.asarray(v), cfg, key=kv).err_hist,
                           np.float64)
            p = np.asarray(tritd_admm(jnp.asarray(bumped), cfg, key=kv)
                           .err_hist, np.float64)
            refs.append(r)
            sens.append(float(np.max(np.abs(p - r))))
    got = np.asarray(runs["batch_sharded"].err_hist, np.float64)
    pairs = [("sharded", runs["sharded"].err_hist, 0),
             ("auto", runs["auto"].err_hist, 0)]
    pairs += [(f"batch_sharded[{n}]", got[i], i + 1)
              for i, n in enumerate(names)]
    k = min(VIDEO_COMPARE_ITERS, cfg.max_iter)
    gaps = {}
    for name, g, j in pairs:
        g, r = np.asarray(g, np.float64), refs[j]
        if not np.all(np.isfinite(g)):
            raise AssertionError(f"{name}: non-finite err_hist {g}")
        rel = float(np.max(np.abs(g[:k] - r[:k]) / np.abs(r[:k])))
        full = float(np.max(np.abs(g - r)))
        bar = SENSITIVITY_FACTOR * sens[j]
        gaps[name] = {"max_rel_gap_first": rel, "max_abs_gap": full,
                      "one_ulp_gap": sens[j]}
        print(f"{name} err_hist vs single card: max_rel_gap[:{k}]={rel:.3e}"
              f" (tolerance {VIDEO_CPU_RTOL:.1e}); max_abs_gap over all"
              f" {g.shape[0]} iterations={full:.3e} (tolerance"
              f" {SENSITIVITY_FACTOR:g} x one-ulp gap {sens[j]:.3e}"
              f" = {bar:.3e})")
        if not (rel <= VIDEO_CPU_RTOL and full <= bar):
            raise AssertionError(f"{name} differs from the single card")
    return gaps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths, on four cards")
    args = ap.parse_args(argv)

    sys.stdout.reconfigure(line_buffering=True)
    info = gpu_device_info(jax)  # SystemExit unless the first device is a GPU
    enable_persistent_cache()
    devices = jax.devices()
    print(f"device_kind={info['device_kind']} count={info['device_count']}"
          f" jax={jax.__version__}")
    print("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    print(info["nvidia_smi"])

    if args.four_cards:
        if len(devices) != 4:
            raise SystemExit(f"--four-cards needs 4 cards, found {len(devices)}")
        phase_four_cards(devices)
    else:
        phase_taxi(devices[0], info=info)
        phase_video(devices[0], info=info)
        phase_cli(devices[0])

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))


if __name__ == "__main__":
    main(sys.argv[1:])
