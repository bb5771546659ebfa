"""Platform choice, compile cache, and the GPU smoke script's refusals."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from adiabatic_raytracer import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_engine_defaults_known_platforms(platform):
    d = runtime.engine_defaults(platform)
    assert d["engine"] == "pool"            # the f64 XLA pool everywhere
    assert d["compute_dtype"] == "state"    # native f64
    assert d["event_batch"] > 0 and d["pipeline_depth"] >= 1
    if platform == "gpu":
        # the 6,000-event production run is whole batches: one compile
        assert 6000 % d["event_batch"] == 0
        assert d["pipeline_depth"] == 2


@pytest.mark.parametrize("platform", ["neuron", "rocm", "METAL", ""])
def test_engine_defaults_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="unsupported JAX platform"):
        runtime.engine_defaults(platform)


@pytest.mark.gpu
def test_gpu_run_uses_native_f64_pool():
    """On the card the auto defaults are the f64 XLA pool, and a small
    jitted f64 computation matches numpy to f64 rounding."""
    import jax.numpy as jnp
    import numpy as np

    assert runtime.current_defaults() == runtime.engine_defaults("gpu")
    x = np.linspace(-30.0, 30.0, 4096)
    y = jax.jit(lambda v: jnp.sin(v) * jnp.exp(-0.1 * v * v))(x)
    assert y.dtype == jnp.float64
    np.testing.assert_allclose(np.asarray(y), np.sin(x) * np.exp(-0.1 * x * x),
                               rtol=1e-13, atol=1e-300)


def test_current_defaults_follow_first_device():
    assert runtime.current_defaults() == runtime.engine_defaults(
        jax.devices()[0].platform)


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_is_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert runtime.compile_cache_dir() == os.path.join(ROOT, ".jax_cache")


def test_setup_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert runtime.setup_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    last = p.stdout.strip().splitlines()[-1:] or [""]
    return p.returncode, last[0]


def test_chip_smoke_fails_without_gpu():
    rc, last = _run_smoke(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert rc != 0
    assert not last.startswith("{")


def test_chip_smoke_fails_outside_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    rc, last = _run_smoke(str(tmp_path), "chip_smoke.py")
    assert rc != 0
    assert not last.startswith("{")


@pytest.mark.parametrize("argv", [["--engine", "mega"],
                                  ["--tree_engine", "kernel"]])
def test_cli_rejects_removed_engines(argv):
    from adiabatic_raytracer.cli import build_parser

    with pytest.raises(SystemExit):
        build_parser().parse_args(argv)


def test_bench_ray_ensemble_is_seeded():
    sys.path.insert(0, ROOT)
    import bench
    import numpy as np

    a = bench.rays(64, seed=3)
    b = bench.rays(64, seed=3)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    x, v, erg = a
    r = np.linalg.norm(x, axis=1)
    assert r.min() >= 14.0 and r.max() <= 24.0
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0)
    assert json.dumps(float(erg[0]))
