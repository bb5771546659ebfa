"""Run-time choices made from the JAX platform, in one place.

`engine_defaults` maps a platform to the engine settings the CLI, the driver
and the bench scripts use when the caller leaves them on auto;
`setup_compile_cache` points JAX's persistent compilation cache at one
fixed directory.
"""

from __future__ import annotations

import os

import jax

# The checkout (or installed tree) that holds this package.
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def engine_defaults(platform: str) -> dict:
    """Engine settings for a JAX platform name ("cpu" or "gpu").

    compute_dtype: physics dtype ("state" = f64 when x64 is on).
    engine: propagation engine for the backtrace and the forward tree.
    event_batch: events per pipeline batch.
    pipeline_depth: dispatched-but-unassembled batches kept in flight at
    saveMode <= 1 (the tree dumps of saveMode >= 2 always use 1).

    Any other platform raises: there is no fallback."""
    if platform == "cpu":
        return dict(compute_dtype="state", engine="pool", event_batch=16,
                    pipeline_depth=1)
    if platform == "gpu":
        # 2000 events per batch: the reference's 6,000-event production
        # run is three equal batches, so the pipeline compiles once
        return dict(compute_dtype="state", engine="pool",
                    event_batch=2000, pipeline_depth=2)
    raise ValueError(f"unsupported JAX platform {platform!r}: "
                     "expected 'cpu' or 'gpu'")


def current_defaults() -> dict:
    """engine_defaults() for the platform of JAX's first device."""
    return engine_defaults(jax.devices()[0].platform)


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_ROOT, ".jax_cache"))


def setup_compile_cache() -> str:
    """Enable JAX's persistent compilation cache at compile_cache_dir()."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
