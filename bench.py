#!/usr/bin/env python
"""Photon-ray integration throughput at reference tolerances, per engine.

Integrates a fixed ensemble of photon rays (GR + anisotropic Melrose
dispersion in a misaligned rotating GJ magnetosphere, rtol=1e-7 / atol=1e-6,
the reference's ODE contract, RayTracer.jl:383-384, with the 50-point
crossing scan of RayTracer.jl:357-358) through each requested engine:

  pool          ops/propagate.propagate: the XLA pool integrator in the
                state dtype (f64), one lockstep batch
  pool_compact  the same integrator behind ops/streaming.CompactedPropagator
                (bounded chunks, stragglers repacked into smaller pools)

Compilation is timed apart as set-up; the timed reps end in
block_until_ready.  Each engine after the first is compared with the first
(endpoints, crossing counts).  Prints one JSON line per engine.  Needs a
GPU: with no accelerator it fails.

Usage:  python bench.py [--rays 65536] [--reps 3] [--engines pool]
"""

import argparse
import json
import sys
import time

import numpy as np


def rays(n, seed=0):
    """The headline ray ensemble: launch radius 14-24 km, isotropic
    directions, axion-rest-mass energy (deterministic from seed)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(14.0, 24.0, n)
    th = np.arccos(rng.uniform(-0.95, 0.95, n))
    ph = rng.uniform(-np.pi, np.pi, n)
    x = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                  r * np.cos(th)], axis=1)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    erg = np.full(n, 1e-5 * (1 + 0.5 * (220.0 / 2.99792e5) ** 2))
    return x, v, erg


def make_engine(name, sc, cfg, x, v, erg, t_end):
    """A jitted fn(eps) -> (x_end [B,3], steps [B], n_cross [B]) for one
    engine; eps perturbs the launch radius so every rep is fresh work."""
    import jax
    import jax.numpy as jnp

    B = x.shape[0]
    lnt0 = jnp.full(B, cfg.ln_t_start)
    lnt1 = jnp.full(B, float(np.log(t_end)))
    if name == "pool":
        from adiabatic_raytracer.ops.propagate import propagate

        def f(eps):
            res = propagate(x.at[:, 0].add(eps), v, sc, cfg, erg=erg,
                            delta_w=-jnp.ones(B), lnt0=lnt0, lnt1=lnt1,
                            is_photon=jnp.ones(B, bool),
                            max_crossings=jnp.ones(B, jnp.int32),
                            species="photon")
            return res.traj[:, -1, :], res.steps, res.n_cross
        return jax.jit(f)

    from adiabatic_raytracer.ops.streaming import CompactedPropagator

    cp = CompactedPropagator(sc, cfg, species="photon", chunk_iters=192,
                             min_pool=128)

    def f(eps):
        res = cp.run(x.at[:, 0].add(eps), v, erg, -jnp.ones(B), lnt0, lnt1,
                     jnp.ones(B, bool), jnp.ones(B, jnp.int32))
        return res.traj[:, -1, :], res.steps, res.n_cross
    return f


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=65536)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--engines", default="pool")
    ap.add_argument("--span_t", type=float, default=0.1,
                    help="trajectory end time [s]")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from adiabatic_raytracer import runtime
    from adiabatic_raytracer.config import NumericsConfig, Scene

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    runtime.setup_compile_cache()

    sc = Scene(mass_a=1e-5, ax_g=1e-12, theta_m=0.2, omega_pul=1.0, b0=1e14,
               r_ns=10.0, mass_ns=1.0)
    cfg = NumericsConfig(rtol=1e-7, atol=1e-6, compute_dtype="state")
    x, v, erg = (jnp.asarray(a) for a in rays(args.rays))
    B = args.rays

    ref = None
    for name in args.engines.split(","):
        f = make_engine(name, sc, cfg, x, v, erg, args.span_t)
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(0.0))
        t_first = time.perf_counter() - t0
        dts = []
        for i in range(args.reps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(f(1e-7 * (i + 1)))
            dts.append(time.perf_counter() - t0)
        dt = float(np.median(dts))
        x_end, steps, ncross = (np.asarray(a) for a in out)
        assert np.all(np.isfinite(x_end)), name
        rec = {
            "metric": "photon_rays_per_sec",
            "engine": name,
            "value": B / dt,
            "unit": "rays/s",
            "rays": B,
            "wall_s": dts,
            "first_call_s": t_first,
            "compile_s_est": max(t_first - dt, 0.0),
            "mean_steps_per_ray": float(steps.mean()),
            "max_steps": int(steps.max()),
            "crossings_frac": float(np.mean(ncross > 0)),
            "rtol": cfg.rtol, "atol": cfg.atol,
            "interp_points": cfg.interp_points,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
        }
        if ref is None:
            ref = (x_end, ncross, name)
        else:
            r_ref = np.linalg.norm(ref[0], axis=1)
            rel = np.abs(np.linalg.norm(x_end, axis=1) - r_ref) / r_ref
            rec["vs"] = ref[2]
            rec["endpoint_rel_median"] = float(np.median(rel))
            rec["endpoint_rel_max"] = float(np.max(rel))
            rec["endpoint_rel_p999"] = float(np.quantile(rel, 0.999))
            rec["ncross_equal_frac"] = float(np.mean(ncross == ref[1]))
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    sys.exit(main())
