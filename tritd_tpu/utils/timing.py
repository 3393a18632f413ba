"""Phase timing and device-synchronized wall-clock helpers.

The reference's observability is tic/toc around solver calls
(`traffic_triple_comparison.m:52,61`). Here timers synchronize on device
completion (`block_until_ready`) so compiled-async JAX timing is honest, and
a PhaseTimer accumulates named phases (build/solve/elementwise/collective)
like SOFIA's `info` struct (`sofia.m:121-138`).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


def sync(tree):
    """Block until every array in the pytree is computed; returns the tree."""
    for leaf in jax.tree_util.tree_leaves(tree):
        if hasattr(leaf, "block_until_ready"):
            leaf.block_until_ready()
    return tree


@contextlib.contextmanager
def device_timer():
    """`with device_timer() as t: ... ; t()` -> seconds, device-synced at exit
    boundary is the caller's responsibility (call sync() on outputs first)."""
    start = time.perf_counter()
    elapsed = {}
    yield lambda: elapsed.get("s", time.perf_counter() - start)
    elapsed["s"] = time.perf_counter() - start


class PhaseTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, tree_to_sync=None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if tree_to_sync is not None:
                sync(tree_to_sync)
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def summary(self) -> dict[str, float]:
        return dict(self.totals)


@contextlib.contextmanager
def profiler_trace(log_dir: str = "/tmp/tritd_profile"):
    """jax.profiler trace context — open the result with TensorBoard/XProf.
    The replacement for tic/toc-level observability (SURVEY §5)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def time_fn(fn, *args, warmup: int = 1, iters: int = 3, **kwargs):
    """(best seconds, last result) of a jitted fn, excluding compile."""
    result = None
    for _ in range(max(warmup, 1)):
        result = sync(fn(*args, **kwargs))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        result = sync(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - t0)
    return best, result
