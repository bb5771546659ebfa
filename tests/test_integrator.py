"""Integrator tests: RK order/accuracy, event detection, physics endpoints."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adiabatic_raytracer.config import NumericsConfig, Scene
from adiabatic_raytracer.constants import C_KM, G_NEW
from adiabatic_raytracer.ops.integrator import integrate_pool
from adiabatic_raytracer.ops.propagate import propagate


def _run_simple(rhs, cond, u0, t0, t1, cfg, **kw):
    B = u0.shape[0]
    defaults = dict(
        save_lnt=jnp.stack([jnp.linspace(a, b, cfg.n_save) for a, b in zip(t0, t1)]),
        kill_at_surface=jnp.zeros(B, bool),
        r_ns=0.0,
        x0_cart=jnp.full((B, 3), 1e30),  # never matches the start-dup filter
        max_crossings=jnp.full(B, 100, jnp.int32),
    )
    defaults.update(kw)
    return integrate_pool(rhs, cond, u0, t0, t1, {}, cfg, **defaults)


def test_harmonic_oscillator_accuracy():
    """u'' = -u over 10 periods; endpoint error ~ tolerance."""
    cfg = NumericsConfig(rtol=1e-9, atol=1e-9)
    rhs = lambda u, t, a: jnp.array([u[1], -u[0]])
    cond = lambda u, t, a: jnp.array(1.0)
    B = 3
    u0 = jnp.tile(jnp.array([1.0, 0.0]), (B, 1))
    t0 = jnp.zeros(B)
    t1 = jnp.full(B, 20.0 * np.pi)
    res = _run_simple(rhs, cond, u0, t0, t1, cfg, detect_events=False)
    np.testing.assert_allclose(np.asarray(res.u), np.tile([1.0, 0.0], (B, 1)), atol=1e-6)
    assert np.all(np.asarray(res.steps) < 2000)


def test_stiff_exponential():
    cfg = NumericsConfig(rtol=1e-8, atol=1e-10)
    rhs = lambda u, t, a: -u
    cond = lambda u, t, a: jnp.array(1.0)
    u0 = jnp.ones((2, 1))
    res = _run_simple(rhs, cond, u0, jnp.zeros(2), jnp.full(2, 5.0), cfg,
                      detect_events=False)
    np.testing.assert_allclose(np.asarray(res.u)[:, 0], np.exp(-5.0), rtol=1e-7)


def test_event_detection_linear():
    """u' = 1; condition sin(u) has roots at multiples of pi."""
    cfg = NumericsConfig(rtol=1e-8, atol=1e-8, max_crossings=8)
    rhs = lambda u, t, a: jnp.ones_like(u)
    cond = lambda u, t, a: jnp.sin(u[0])
    u0 = jnp.full((2, 1), 0.1)
    res = _run_simple(rhs, cond, u0, jnp.zeros(2), jnp.full(2, 10.0), cfg,
                      max_crossings=jnp.full(2, 8, jnp.int32))
    n = int(res.n_cross[0])
    assert n == 3  # pi, 2pi, 3pi in (0.1, 10.1)
    roots = np.asarray(res.cross_u)[0, :n, 0]
    np.testing.assert_allclose(roots, [np.pi, 2 * np.pi, 3 * np.pi], rtol=1e-6)


def test_event_termination():
    """max_crossings=1 terminates at the first root with state at the root."""
    cfg = NumericsConfig(rtol=1e-8, atol=1e-8)
    rhs = lambda u, t, a: jnp.ones_like(u)
    cond = lambda u, t, a: u[0] - 2.0
    u0 = jnp.zeros((2, 1))
    res = _run_simple(rhs, cond, u0, jnp.zeros(2), jnp.full(2, 10.0), cfg,
                      max_crossings=jnp.ones(2, jnp.int32))
    assert bool(res.cut_short[0])
    np.testing.assert_allclose(np.asarray(res.u)[:, 0], 2.0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(res.lnt), 2.0, atol=1e-8)


# ---------------------------------------------------------------------------
# physics endpoints
# ---------------------------------------------------------------------------

SC_VACUUM = Scene(mass_a=1e-5, theta_m=0.0, omega_pul=1.0, b0=1.0, r_ns=10.0,
                  mass_ns=1.0)  # B0=1 G: plasma negligible at erg ~ 1e-5 eV


def _propagate_photons(sc, x0, khat, t_end, cfg=None, erg_val=1e-5):
    cfg = cfg or NumericsConfig()
    B = x0.shape[0]
    erg = jnp.full(B, erg_val)
    return propagate(
        x0, khat, sc, cfg,
        erg=erg,
        delta_w=-jnp.ones(B),
        lnt0=jnp.full(B, cfg.ln_t_start),
        lnt1=jnp.full(B, np.log(t_end)),
        is_photon=jnp.ones(B, bool),
        max_crossings=jnp.ones(B, jnp.int32),
        species="photon",
        detect_events=False,
    )


def test_flat_space_straight_line():
    # mass_ns=0 outright: the reference's `flat` switch still normalizes the
    # launch momentum with the massive metric (RayTracer.jl:181-189), which
    # would give speed sqrt(A(r0)) c instead of c.
    sc = Scene(mass_a=1e-5, theta_m=0.0, b0=1.0, mass_ns=0.0, flat=True)
    x0 = jnp.array([[50.0, 5.0, 30.0], [40.0, -20.0, 10.0]])
    khat = jnp.array([[1.0, 0.2, -0.1], [0.3, 0.9, 0.3]])
    khat = khat / jnp.linalg.norm(khat, axis=1, keepdims=True)
    t_end = 1e-3
    # erg >> m_a so the axion-shell launch normalization (ax_fix, see
    # RayTracer.jl:185) gives an ultra-relativistic, effectively luminal ray
    res = _propagate_photons(sc, x0, khat, t_end, erg_val=1.0)
    want = np.asarray(x0) + C_KM * t_end * np.asarray(khat)
    got = np.asarray(res.traj[:, -1, :])
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-3)
    # momentum direction unchanged
    vdir = np.array(res.mom[:, -1, :])
    vdir /= np.linalg.norm(vdir, axis=1, keepdims=True)
    np.testing.assert_allclose(vdir, np.asarray(khat), atol=1e-7)


def test_schwarzschild_light_bending():
    """Weak-field deflection alpha = 4GM/(c^2 b) + 15 pi (GM/c^2)^2 / (4 b^2)."""
    m = G_NEW * 1.0 / C_KM**2  # GM/c^2 in km
    b = 300.0
    x_start = -3000.0
    x0 = jnp.array([[x_start, b, 0.0]])
    khat = jnp.array([[1.0, 0.0, 0.0]])
    t_end = 6000.0 / C_KM * 1.3
    res = _propagate_photons(SC_VACUUM, x0, khat, t_end, erg_val=1.0)
    v = np.asarray(res.mom[0, -1, :])
    alpha = np.arctan2(-v[1], v[0])
    want = 4 * m / b + 15 * np.pi * m**2 / (4 * b**2)
    np.testing.assert_allclose(alpha, want, rtol=0.02)


def test_energy_conservation_aligned():
    """Aligned rotator (theta_m=0): the plasma is static, so e7 (energy drift)
    must stay constant along photon rays."""
    sc = Scene(mass_a=1e-5, theta_m=0.0, omega_pul=1.0, b0=1e14, r_ns=10.0, mass_ns=1.0)
    x0 = jnp.array([[60.0, 10.0, 40.0]])
    khat = jnp.array([[0.5, 0.5, 0.7]])
    khat = khat / jnp.linalg.norm(khat, axis=1, keepdims=True)
    res = _propagate_photons(sc, x0, khat, 1e-3, erg_val=1.3e-5)
    e7 = np.asarray(res.erg[0])
    np.testing.assert_allclose(e7, e7[0], rtol=1e-7)


def test_pi_controller_accuracy_and_steps():
    """cfg.pi_beta enables the Lund/Hairer predictive controller
    (dopri5.f's beta): same endpoint accuracy contract as the I controller,
    never more attempted steps on a smooth problem (the errold boost damps
    the accept/reject limit cycle).  beta=0 is the default and reproduces
    the plain I controller bit-for-bit (pinned by the golden e2e rows)."""
    rhs = lambda u, t, a: jnp.stack([u[1], -jnp.sin(u[0])])  # pendulum
    cond = lambda u, t, a: jnp.array(1.0)
    B = 4
    u0 = jnp.stack([jnp.linspace(0.1, 2.5, B), jnp.zeros(B)], axis=1)
    t0 = jnp.zeros(B)
    t1 = jnp.full(B, 50.0)
    cfg_i = NumericsConfig(rtol=1e-7, atol=1e-9)
    cfg_pi = NumericsConfig(rtol=1e-7, atol=1e-9, pi_beta=0.04)
    res_i = _run_simple(rhs, cond, u0, t0, t1, cfg_i, detect_events=False)
    res_pi = _run_simple(rhs, cond, u0, t0, t1, cfg_pi, detect_events=False)
    # both hit the shared accuracy contract: endpoints agree to ~tolerance
    np.testing.assert_allclose(np.asarray(res_pi.u), np.asarray(res_i.u),
                               atol=1e-5)
    assert int(np.asarray(res_pi.steps).sum()) <= int(np.asarray(res_i.steps).sum())


def test_flops_per_step_counts_the_scan():
    """The pool integrator's per-step operation count grows linearly with
    the crossing-scan density: each extra interior point costs one Hermite
    + condition evaluation."""
    from adiabatic_raytracer.ops.propagate import flops_per_step

    sc = Scene(theta_m=0.2)
    f = {k: flops_per_step(sc, NumericsConfig(interp_points=k))
         for k in (2, 8, 50)}
    assert 0 < f[2] < f[8] < f[50]
    per_point = (f[50] - f[8]) / 42.0
    np.testing.assert_allclose((f[8] - f[2]) / 6.0, per_point, rtol=1e-9)
    assert f[2] > 6 * per_point * 0.1   # the six RHS evaluations dominate
