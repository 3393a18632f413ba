"""Persistent XLA compilation cache, on by default for the entry points.

Compiled executables are reused across processes, so a later process skips
the first-touch compiles of the large solver and baseline programs.
bench.py, chip_smoke.py and both CLIs call :func:`enable_persistent_cache`
before their first compile; set ``TRITD_NO_COMPILE_CACHE=1`` to opt out
(e.g. for cold-compile measurements — bench rows report compile time either
way).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, it is the cache directory and
nothing here chooses another. Otherwise the cache lives at a fixed path,
``.jax_cache`` beside the package (gitignored in a source checkout): the
path is part of what a later process must find again.
"""

from __future__ import annotations

import os

# Anchored to the package's parent (the repo root for a source checkout,
# where .jax_cache is gitignored) rather than the CWD, so invoking the CLIs
# from elsewhere does not scatter cache directories (r4 advisor).
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_cache(cache_dir: str | None = None) -> bool:
    """Idempotently point JAX's compilation cache at env
    `JAX_COMPILATION_CACHE_DIR` when it is set, else at `cache_dir`, else at
    `.jax_cache` under the package's parent directory. Returns True if the
    cache is enabled. Never raises — an unwritable directory just means
    cold compiles."""
    if os.environ.get("TRITD_NO_COMPILE_CACHE") == "1":
        return False
    cache_dir = (
        os.environ.get("JAX_COMPILATION_CACHE_DIR")
        or cache_dir
        or DEFAULT_CACHE_DIR
    )
    try:
        import jax

        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        # Persist every compile costing >= 0.5 s: that covers everything
        # worth caching (the 1-170 s solver/baseline programs) while
        # keeping the thousands of sub-0.5 s helper jits — cheap to redo —
        # out of the cache directory.
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
        return True
    except Exception:  # noqa: BLE001 — cache is an optimization, never fatal
        return False
