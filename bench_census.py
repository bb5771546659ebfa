#!/usr/bin/env python
"""Crossing-census parity scan over the event-scan density (interp_points).

The reference's ContinuousCallback scans 50 interpolation points per accepted
step for level-crossing sign flips (RayTracer.jl:357-358); this framework's
default is lower.  This tool measures what the scan density actually buys:
it runs the production backtrace (axion, B flipped, up to 16 crossings) over
the SAME sampled conversion-surface ensemble at interp_points K in
{4, 8, 16, 32, 50} and compares each census against K=50:

  * n_cross histogram
  * events whose crossing count differs from the K=50 run
  * crossings missed (present at K=50, unmatched in time at K)

A "missed" crossing is a K=50 crossing time with no K crossing within 1% —
closely spaced double roots inside one accepted step are exactly what the
dense scan exists to catch.  One JSON line per K.

Env: CENSUS_EVENTS (default 65536 on the GPU / 512 on the CPU), CENSUS_KS,
CENSUS_SEED.
"""

import json
import os
import sys
import time


def _sample_events(sc, n, seed, cfg):
    """Production conversion-surface ensemble (find_samples_new path)."""
    import numpy as np

    import jax
    import jax.numpy as jnp

    from adiabatic_raytracer.models.magnetosphere import (
        conversion_surface_radius)
    from adiabatic_raytracer.ops import sampler
    from adiabatic_raytracer.ops.dispersion import k_norm_cart

    maxR = float(conversion_surface_radius(sc.mass_a, sc.theta_m, sc.omega_pul,
                                           sc.b0, sc.r_ns))
    n_grid = sampler.default_n_grid(maxR)
    platform = jax.devices()[0].platform
    key = jax.random.PRNGKey(seed)
    xs, vs, es = [], [], []
    got = 0
    chunk = 8192 if platform != "cpu" else 256
    samp = jax.jit(lambda k: sampler.sample_batch(
        k, chunk, maxR, sc, sc.mass_ns, n_grid=n_grid,
        compute_dtype=cfg.compute_dtype))
    while got < n:
        key, sub = jax.random.split(key)
        res = samp(sub)
        ok = np.nonzero(np.asarray(res.success))[0]
        xs.append(np.asarray(res.xpos)[ok])
        vs.append(np.asarray(res.v_loc)[ok])
        es.append(np.asarray(res.erg_inf)[ok])
        got += len(ok)
    x = np.concatenate(xs)[:n]
    v = np.concatenate(vs)[:n]
    e = np.concatenate(es)[:n]
    k_init = k_norm_cart(jnp.asarray(x), jnp.asarray(v), 0.0, jnp.asarray(e),
                         sc, sc.mass_ns, is_photon=True, ax_fix=True)
    return jnp.asarray(x), k_init, jnp.asarray(e)


def main():
    import numpy as np

    import jax

    jax.config.update("jax_enable_x64", True)

    from adiabatic_raytracer.config import NumericsConfig, Scene, TreeConfig
    from adiabatic_raytracer.ops import tree

    platform = jax.devices()[0].platform
    n = int(os.environ.get(
        "CENSUS_EVENTS", "65536" if platform != "cpu" else "512"))
    seed = int(os.environ.get("CENSUS_SEED", "1769"))
    ks = [int(s) for s in os.environ.get(
        "CENSUS_KS", "4,8,16,32,50").split(",")]
    if 50 not in ks:
        ks.append(50)
    from adiabatic_raytracer import runtime

    runtime.setup_compile_cache()
    auto = runtime.engine_defaults(platform)
    compute_dtype = auto["compute_dtype"]
    engine = auto["engine"]

    sc = Scene(mass_a=1e-5, ax_g=1e-12, theta_m=0.2, omega_pul=1.0, b0=1e14,
               r_ns=10.0, mass_ns=1.0)
    base = NumericsConfig(rtol=1e-7, atol=1e-6, compute_dtype=compute_dtype,
                          engine=engine, max_crossings=16)
    tcfg = TreeConfig()

    xpos, k_init, erg = _sample_events(sc, n, seed, base)

    # Ground truth is the 50-point scan — the reference's exact density;
    # every other configuration is compared against it.
    import dataclasses
    configs = {}
    for k in sorted(set(ks)):
        configs[str(k)] = dataclasses.replace(base, interp_points=k)

    results = {}
    walls = {}
    for name, cfg in configs.items():
        bt_fn = jax.jit(lambda x, ki, e, cfg=cfg: tree.backtrace(
            x, ki, e, sc, cfg, tcfg, lnt_end=0.0))
        out = bt_fn(xpos, k_init, erg)
        nc = np.asarray(out.raw_n_cross)
        tc = np.asarray(out.raw_tc)
        t0 = time.perf_counter()
        out = bt_fn(xpos, k_init, erg)
        nc = np.asarray(out.raw_n_cross)
        tc = np.asarray(out.raw_tc)
        walls[name] = time.perf_counter() - t0
        results[name] = (nc, tc)

    nc50, tc50 = results["50"]
    for name in configs:
        nc, tc = results[name]
        same_n = nc == nc50
        missed = 0
        extra = int(np.sum(np.maximum(nc - nc50, 0)))
        # time-match the K=50 crossings against K's (1% relative window)
        diff_ev = np.nonzero(~same_n)[0]
        for e in diff_ev:
            a = np.sort(tc50[e, :nc50[e]])
            b = np.sort(tc[e, :nc[e]])
            for t in a:
                if b.size == 0 or np.min(np.abs(b - t)) > 0.01 * max(t, 1e-12):
                    missed += 1
        hist = np.bincount(np.minimum(nc, 8), minlength=9).tolist()
        cfg = configs[name]
        print(json.dumps({
            "metric": "crossing_census",
            "config": name,
            "interp_points": cfg.interp_points,
            "events": int(n),
            "total_crossings": int(nc.sum()),
            "n_cross_hist": hist,
            "events_diff_vs_50": int((~same_n).sum()),
            "missed_vs_50": int(missed),
            "extra_vs_50": extra,
            "wall_s": round(walls[name], 3),
            "engine": engine,
            "device": {"platform": platform,
                       "kind": jax.devices()[0].device_kind,
                       "count": len(jax.devices())},
        }))


if __name__ == "__main__":
    sys.exit(main())
