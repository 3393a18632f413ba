"""bench.py's contract: it refuses a non-GPU backend, a row that raises
ends the run non-zero, and the compile cache follows the environment."""

import os
import subprocess
import sys

import jax
import pytest

import bench
from tritd_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_refuses_cpu_backend():
    with pytest.raises(SystemExit) as exc:
        bench.main([])
    assert exc.value.code not in (0, None)


def test_bench_exits_nonzero_when_a_row_raises():
    # a real process on the CPU backend: the GPU check is replaced by a
    # fixed device record, and the first row raises
    code = (
        "import sys, jax; jax.config.update('jax_platforms', 'cpu');"
        "import bench;"
        "bench.gpu_device_info = lambda jax: {'device_kind': 'test'};"
        "def boom(*a, **k): raise RuntimeError('row failed');"
        "bench.run_config = boom;"
        "bench.main([])"
    )
    env = {**os.environ, "TRITD_NO_COMPILE_CACHE": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "row failed" in proc.stderr
    assert proc.stdout.strip() == ""


def test_bench_rows_name_their_device(monkeypatch):
    device = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
              "device_count": 1, "nvidia_smi": "NVIDIA H100 80GB HBM3, 700 W"}
    import jax.numpy as jnp
    import numpy as np

    row, solve = bench.run_config("taxi", jax, jnp, np, device=device,
                                  shape=(6, 5, 8))
    assert row["device"] == device
    assert row["roofline"]["device_kind"] == device["device_kind"]
    assert row["roofline"]["peak_precision"] == "f32"
    assert row["compile_s"] >= 0 and row["seconds"] > 0
    assert int(solve.result.n_iters) == row["n_iters"]


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    env_dir = tmp_path / "from_env"
    arg_dir = tmp_path / "from_arg"
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: seen.__setitem__(name, value))
    monkeypatch.delenv("TRITD_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(env_dir))
    assert compile_cache.enable_persistent_cache(str(arg_dir))
    assert seen["jax_compilation_cache_dir"] == str(env_dir)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert compile_cache.enable_persistent_cache(str(arg_dir))
    assert seen["jax_compilation_cache_dir"] == str(arg_dir)
    assert compile_cache.enable_persistent_cache()
    assert seen["jax_compilation_cache_dir"] == compile_cache.DEFAULT_CACHE_DIR
