#!/usr/bin/env python
"""BASELINE.md benchmark configs beyond the headline (bench.py = config 1).

  BENCH_CONFIG=2  GR run at ~1e4 rays (Schwarzschild + Melrose, events on)
  BENCH_CONFIG=3  1e6-ray MC spectrum with ON-DEVICE binning: pool
                  propagation in chunks + weighted scatter-add pulse-profile
                  histogram (parallel/reduce.py), nothing fetched but the
                  spectrum
  BENCH_CONFIG=4  misaligned-rotator PHASE SWEEP, single-device analogue:
                  NP rotator phases batched into ONE propagation via
                  per-lane (lnt0, lnt1) time windows, NP pulse profiles
                  binned on device (the mesh path — one phase per device —
                  is exercised by dryrun_multichip / tests/test_sharding.py)
  BENCH_CONFIG=5  axion-mass x B-field parameter scan (6 scenes, pool engine,
                  one compile via lax.map) with stiff near-resonance stepping

Each run prints ONE JSON line naming its device.  Needs a GPU.
"""

import json
import os
import sys
import time

import numpy as np


def _launch_states(B, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.uniform(14.0, 24.0, B)
    th = np.arccos(rng.uniform(-0.95, 0.95, B))
    ph = rng.uniform(-np.pi, np.pi, B)
    x = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                  r * np.cos(th)], axis=1)
    v = rng.normal(size=(B, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return x, v


def _photons(sc, cfg, x, v, erg, lnt0, lnt1):
    """Pool propagation of photon rays: (endpoint azimuth, escaped mask,
    steps, n_cross)."""
    import jax.numpy as jnp

    from adiabatic_raytracer.ops.propagate import propagate

    B = x.shape[0]
    res = propagate(x, v, sc, cfg, erg=erg, delta_w=-jnp.ones(B), lnt0=lnt0,
                    lnt1=lnt1, is_photon=jnp.ones(B, bool),
                    max_crossings=jnp.ones(B, jnp.int32), species="photon")
    end = res.traj[:, -1, :]
    phi_f = jnp.arctan2(end[:, 1], end[:, 0])
    escaped = ~res.ns_hit & ~res.maxed
    return phi_f, escaped, res.steps, res.n_cross


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from adiabatic_raytracer.config import NumericsConfig, Scene

    from adiabatic_raytracer import runtime

    config = int(os.environ.get("BENCH_CONFIG", "3"))
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench_configs.py needs a GPU; JAX found "
                         f"{dev.platform!r}")
    runtime.setup_compile_cache()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    compute_dtype = runtime.engine_defaults(dev.platform)["compute_dtype"]
    t_end = 0.1

    if config == 2:
        # config 2 is the headline benchmark at the GR production scale
        import bench

        return bench.main(["--rays", os.environ.get("BENCH_RAYS", "16384")])

    if config == 3:
        from adiabatic_raytracer.parallel.reduce import weighted_histogram

        B = int(os.environ.get("BENCH_RAYS", str(1 << 20)))  # 1,048,576 rays
        CH = min(B, int(os.environ.get("BENCH_CHUNK", str(1 << 16))))
        assert B % CH == 0
        nbins = 50
        sc = Scene(mass_a=1e-5, ax_g=1e-12, theta_m=0.2, omega_pul=1.0,
                   b0=1e14, r_ns=10.0, mass_ns=1.0)
        cfg = NumericsConfig(rtol=1e-7, atol=1e-6,
                             compute_dtype=compute_dtype)
        x, v = _launch_states(CH)
        x, v = jnp.asarray(x), jnp.asarray(v)
        erg = jnp.full(CH, 1e-5 * (1 + 0.5 * (220.0 / 2.99792e5) ** 2))
        lnt0 = jnp.full(CH, cfg.ln_t_start)
        lnt1 = jnp.full(CH, float(np.log(t_end)))

        @jax.jit
        def spectrum_chunk(eps, hist, steps_acc, ncross_acc):
            phi_f, escaped, steps, ncross = _photons(
                sc, cfg, x.at[:, 0].add(eps), v, erg, lnt0, lnt1)
            # MC spectrum: pulse profile of the endpoint azimuth of the
            # escaped rays, entirely on device (the combine_files + numpy
            # histogram role, flux.py:38-48)
            hist = hist + weighted_histogram(
                phi_f, jnp.where(escaped, 1.0, 0.0), nbins, -np.pi, np.pi)
            return (hist, steps_acc + steps.sum(),
                    ncross_acc + (ncross > 0).sum())

        def run_all(eps0):
            # chunked propagations; the histogram accumulates on device,
            # only the final [nbins] spectrum is fetched
            hist = jnp.zeros(nbins)
            steps_acc = jnp.zeros(())
            nc_acc = jnp.zeros(())
            for c in range(B // CH):
                hist, steps_acc, nc_acc = spectrum_chunk(
                    eps0 + 1e-9 * c, hist, steps_acc, nc_acc)
            return np.asarray(hist), float(steps_acc), float(nc_acc)

        run_all(0.0)  # compile + warm
        t0 = time.perf_counter()
        hist_np, tot_steps, n_cross = run_all(1e-7)
        dt = time.perf_counter() - t0
        assert hist_np.sum() > 0
        print(json.dumps({
            "metric": "mc_spectrum_rays_per_sec",
            "value": B / dt, "unit": "rays/s",
            "rays": B, "wall_s": dt, "nbins": nbins,
            "steps_per_sec": tot_steps / dt,
            "crossings_frac": n_cross / B,
            "spectrum_sum": float(hist_np.sum()),
            "engine": "pool+ondevice_hist", "compute_dtype": compute_dtype,
            "device": device, "config": 3,
        }))
        return 0

    if config == 4:
        # Single-device analogue of the misaligned-rotator PHASE SWEEP
        # (BASELINE.md config 4 — the reference fans one process per rotator
        # phase, runner_example.sh:4-9; the mesh path shards it over devices,
        # tests/test_sharding.py).  The rotator phase enters the physics only
        # through the dipole orientation at time t (omega_pul * t), and the
        # integrator takes PER-LANE (lnt0, lnt1) — so NP phases batch into
        # ONE propagation: lane (p, i) integrates the same window shifted to
        # t_p = p/NP * (2*pi/omega), and the NP pulse profiles are binned on
        # device.
        from adiabatic_raytracer.parallel.reduce import weighted_histogram

        NP = int(os.environ.get("BENCH_PHASES", "8"))
        B = int(os.environ.get("BENCH_RAYS", "8192"))  # rays per phase
        CH = NP * B
        nbins = 50
        sc = Scene(mass_a=1e-5, ax_g=1e-12, theta_m=0.4, omega_pul=1.0,
                   b0=1e14, r_ns=10.0, mass_ns=1.0)
        cfg = NumericsConfig(rtol=1e-7, atol=1e-6,
                             compute_dtype=compute_dtype)
        x, v = _launch_states(B)
        x = jnp.asarray(np.tile(x, (NP, 1)))
        v = jnp.asarray(np.tile(v, (NP, 1)))
        erg = jnp.full(CH, 1e-5 * (1 + 0.5 * (220.0 / 2.99792e5) ** 2))
        t_p = np.repeat(np.arange(NP) / NP * (2 * np.pi / sc.omega_pul), B)
        lnt0 = jnp.asarray(np.log(t_p + np.exp(cfg.ln_t_start)))
        lnt1 = jnp.asarray(np.log(t_p + t_end))

        @jax.jit
        def sweep(eps):
            phi_f, escaped, steps, ncross = _photons(
                sc, cfg, x.at[:, 0].add(eps), v, erg, lnt0, lnt1)
            w = jnp.where(escaped, 1.0, 0.0).reshape(NP, B)
            profiles = jax.vmap(
                lambda ph, ww: weighted_histogram(ph, ww, nbins,
                                                  -np.pi, np.pi))(
                phi_f.reshape(NP, B), w)
            return profiles, steps.sum(), (ncross > 0).sum()

        jax.block_until_ready(sweep(0.0))  # compile + warm
        t0 = time.perf_counter()
        profiles, tot_steps, n_cross = jax.block_until_ready(sweep(1e-7))
        dt = time.perf_counter() - t0
        profiles = np.asarray(profiles)
        assert profiles.shape == (NP, nbins) and profiles.sum() > 0
        print(json.dumps({
            "metric": "phase_sweep_rays_per_sec",
            "value": CH / dt, "unit": "rays/s",
            "phases": NP, "rays_per_phase": B, "rays": CH,
            "wall_s": dt, "nbins": nbins,
            "steps_per_sec": float(tot_steps) / dt,
            "crossings_frac": float(n_cross) / CH,
            "engine": "pool+ondevice_profiles",
            "compute_dtype": compute_dtype,
            "device": device, "config": 4,
        }))
        return 0

    if config == 5:
        from adiabatic_raytracer.ops.propagate import propagate

        B = int(os.environ.get("BENCH_RAYS", "2048"))
        masses = np.array([3e-6, 1e-5, 3e-5])
        b0s = np.array([3e13, 1e14])
        scan = [(m, b) for m in masses for b in b0s]
        cfg = NumericsConfig(rtol=1e-7, atol=1e-6,
                             compute_dtype=compute_dtype)
        x, v = _launch_states(B)
        x, v = jnp.asarray(x), jnp.asarray(v)

        def one_point(params):
            mass_a, b0 = params
            sc = Scene(mass_a=mass_a, ax_g=1e-12, theta_m=0.2, omega_pul=1.0,
                       b0=b0, r_ns=10.0, mass_ns=1.0)
            erg = mass_a * (1 + 0.5 * (220.0 / 2.99792e5) ** 2) * jnp.ones(B)
            res = propagate(
                x, v, sc, cfg, erg=erg, delta_w=-jnp.ones(B),
                lnt0=jnp.full(B, cfg.ln_t_start),
                lnt1=jnp.full(B, float(np.log(t_end))),
                is_photon=jnp.ones(B, bool),
                max_crossings=jnp.ones(B, jnp.int32), species="photon")
            return res.steps.sum(), res.n_cross.sum(), res.traj[:, -1, 0].sum()

        # one compile for the whole scan: scene parameters are traced leaves
        scan_fn = jax.jit(lambda ps: jax.lax.map(one_point, ps))
        ps = jnp.asarray(np.array(scan))
        out = scan_fn(ps)
        np.asarray(out[2])
        t0 = time.perf_counter()
        out = scan_fn(ps + 1e-12)
        tot_steps = float(np.asarray(out[0]).sum())
        np.asarray(out[2])
        dt = time.perf_counter() - t0
        n_rays = B * len(scan)
        rays_per_sec = n_rays / dt
        print(json.dumps({
            "metric": "param_scan_rays_per_sec",
            "value": rays_per_sec, "unit": "rays/s",
            "scan_points": len(scan), "rays_per_point": B,
            "wall_s": dt, "steps_per_sec": tot_steps / dt,
            "engine": "pool", "compute_dtype": compute_dtype,
            "device": device, "config": 5,
        }))
        return 0

    raise SystemExit(f"unknown BENCH_CONFIG={config}")


if __name__ == "__main__":
    sys.exit(main())
