"""Multi-host bootstrap: jax.distributed + global (host, chip) meshes.

The reference has no distribution of any kind (SURVEY §2.5); this module is
the framework's own north-star scale-out path (BASELINE.md: >=80%
iterations/s efficiency 1 -> 2 hosts). Design:

  * one JAX process per host, `jax.distributed.initialize` over the
    coordinator;
  * a global mesh over ALL devices arranged (host, device) — the TriTD
    "slab"/"data" axes map onto it so each psum either stays within a host
    (device axis) or crosses the network once (host axis). Per iteration
    the cross-host traffic is the same O(r^4 + n r^2) words as the
    single-host collective budget (see parallel/sharded_admm.py);
  * every process feeds the SAME host tensor to jax.device_put with the
    global NamedSharding — each process materializes only its addressable
    shards, and the jitted shard_map program runs SPMD across processes.

The coordinator address, process count and process id are always passed
explicitly. On CPU the collectives ride Gloo — which is how
tests/test_distributed.py proves the shard_map program crosses process
boundaries (2 processes x 4 virtual devices).

Run one process of a distributed solve by hand:

  python -m tritd_tpu.parallel.distributed --process-id 0 --num-processes 2 \\
      --coordinator 127.0.0.1:12355 --local-devices 4 --out /tmp/p0.npz
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..solvers.base import TriTDConfig


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_devices: int | None = None,
    platform: str | None = None,
) -> tuple[int, int]:
    """Bootstrap this process into the JAX distributed runtime.

    Pass the coordinator address (e.g. ``localhost:<port>``), the process
    count and this process's id. When `local_devices` is set, that many
    virtual host devices are created (must happen before the first backend
    query). Returns (process_id, num_processes)."""
    if local_devices is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={local_devices}"
            )

    import jax

    if platform is not None:
        jax.config.update("jax_platforms", platform)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_index(), jax.process_count()


def make_host_chip_mesh(axis_names: tuple[str, str] = ("data", "slab")):
    """Global 2-D mesh with hosts on the first axis and each host's local
    devices on the second — collectives along the second axis stay within
    a host, the first crosses the network. Axis names default to the TriTD ("data", "slab")
    layout so `tritd_admm_batch_sharded` runs DP-across-hosts x
    TP-within-host unchanged."""
    import jax
    from jax.sharding import Mesh

    n_host = jax.process_count()
    n_local = jax.local_device_count()
    devices = np.empty((n_host, n_local), dtype=object)
    for d in jax.devices():
        devices[d.process_index, d.local_hardware_id % n_local] = d
    if any(devices[i, j] is None for i in range(n_host) for j in range(n_local)):
        # fallback: order by (process, id)
        ordered = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
        devices = np.array(ordered, dtype=object).reshape(n_host, n_local)
    return Mesh(devices, axis_names)


def make_global_slab_mesh(axis_name: str = "slab"):
    """Global 1-D mesh over every device of every host, ordered host-major
    so mode-1 slabs land contiguously per host (one network hop per
    psum)."""
    import jax
    from jax.sharding import Mesh

    ordered = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(ordered, dtype=object), (axis_name,))


# ----------------------------------------------------------------------------
# Runnable worker: one process of a distributed TriTD solve. Used by
# tests/test_distributed.py (2 x 4 virtual CPU devices).
# ----------------------------------------------------------------------------


def _worker(args) -> None:
    initialize_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        local_devices=args.local_devices,
        platform=args.platform,
    )
    import jax
    import jax.numpy as jnp

    from ..data.synthetic import random_tritd, sparse_outliers
    from .sharded_admm import tritd_admm_sharded

    shape = tuple(int(v) for v in args.shape.split(","))
    key = jax.random.PRNGKey(0)
    x, _ = random_tritd(key, shape, rank=args.rank)
    o = sparse_outliers(jax.random.fold_in(key, 1), shape, 0.05, 4.0)
    d = x + o
    cfg = TriTDConfig(rank=args.rank, max_iter=args.max_iter, tol=0.0)
    mesh = make_global_slab_mesh()

    res = tritd_admm_sharded(d, cfg, mesh, key=key, origin=x)
    err = np.asarray(res.err_hist)  # host fetch = sync fence

    if args.bench_repeats:
        best = float("inf")
        for _ in range(args.bench_repeats):
            t0 = time.perf_counter()
            res = tritd_admm_sharded(d, cfg, mesh, key=key)
            np.asarray(res.err_hist)
            best = min(best, time.perf_counter() - t0)
        if jax.process_index() == 0:
            print(json.dumps({
                "n_processes": jax.process_count(),
                "n_devices": jax.device_count(),
                "iters_per_s": round(args.max_iter / best, 2),
                "seconds": round(best, 4),
            }), flush=True)

    if args.out and jax.process_index() == 0:
        np.savez(
            args.out,
            err_hist=err,
            rre_hist=np.asarray(res.rre_hist),
            n_iters=int(res.n_iters),
            n_processes=jax.process_count(),
            n_devices=jax.device_count(),
        )
    jax.distributed.shutdown()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--coordinator", default="127.0.0.1:12355")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--local-devices", type=int, default=None)
    p.add_argument("--platform", default=None)
    p.add_argument("--shape", default="22,13,17")
    p.add_argument("--rank", type=int, default=2)
    p.add_argument("--max-iter", type=int, default=25)
    p.add_argument("--out", default=None)
    p.add_argument("--bench-repeats", type=int, default=0)
    _worker(p.parse_args(argv))


if __name__ == "__main__":
    main()
