"""Conversion-surface sampler tests (vs RayTracer.jl:1480-1653)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adiabatic_raytracer.config import Scene
from adiabatic_raytracer.models.magnetosphere import conversion_surface_radius
from adiabatic_raytracer.ops import sampler


SC = Scene(mass_a=1e-5, ax_g=1e-12, theta_m=0.4, omega_pul=1.0, b0=1e14,
           r_ns=10.0, mass_ns=1.0)


def _setup():
    maxR = float(conversion_surface_radius(SC.mass_a, SC.theta_m, SC.omega_pul,
                                           SC.b0, SC.r_ns))
    n_grid = sampler.default_n_grid(maxR, scan_per_step=8)
    return maxR, n_grid


def test_batch_sampling():
    maxR, n_grid = _setup()
    res = sampler.sample_batch(jax.random.PRNGKey(0), 64, maxR, SC, SC.mass_ns,
                               n_grid=n_grid)
    succ = np.asarray(res.success)
    assert succ.sum() > 5, f"too few successes: {succ.sum()}"
    assert succ.sum() < 64  # rejection must happen too (n_max=6 draw)
    # successful samples lie between the star and the sampling sphere
    r = np.linalg.norm(np.asarray(res.xpos)[succ], axis=1)
    assert np.all(r > SC.r_ns) and np.all(r < 1.2 * maxR)
    assert np.all(np.asarray(res.weight)[succ] >= 1)


def test_crossing_on_surface():
    """Selected crossings are roots of the line condition."""
    maxR, n_grid = _setup()
    res = sampler.sample_batch(jax.random.PRNGKey(1), 32, maxR, SC, SC.mass_ns,
                               n_grid=n_grid)
    succ = np.asarray(res.success)
    idx = np.nonzero(succ)[0]
    for i in idx[:5]:
        g = sampler._line_condition(
            jnp.asarray(res.xpos[i]),
            jnp.asarray(res.v_loc[i]) / jnp.linalg.norm(res.v_loc[i]),
            res.erg_inf[i], SC, SC.mass_ns, True,
        )
        assert abs(float(g)) < 1e-6, float(g)


def test_erg_inf_value():
    maxR, n_grid = _setup()
    res = sampler.sample_batch(jax.random.PRNGKey(2), 8, maxR, SC, SC.mass_ns,
                               n_grid=n_grid)
    # v_infty ~ 220 km/s => erg_inf = m_a (1 + v^2/2c^2) to excellent accuracy
    want = SC.mass_a * (1 + (220.0 / 2.99792e5) ** 2 / 2)
    np.testing.assert_allclose(np.asarray(res.erg_inf), want, rtol=1e-9)


def test_deterministic_given_key():
    maxR, n_grid = _setup()
    r1 = sampler.sample_batch(jax.random.PRNGKey(3), 8, maxR, SC, SC.mass_ns,
                              n_grid=n_grid)
    r2 = sampler.sample_batch(jax.random.PRNGKey(3), 8, maxR, SC, SC.mass_ns,
                              n_grid=n_grid)
    np.testing.assert_array_equal(np.asarray(r1.xpos), np.asarray(r2.xpos))


def _numpy_line_condition(p, vloc, erg, sc):
    """Independent float64 numpy form of the thick-surface line condition
    (RayTracer.jl:1547-1583) at Cartesian points p [N, 3]: inverse-trig
    free (at t = 0 the dipole's azimuthal factors are Cartesian ratios)."""
    from adiabatic_raytracer.constants import (
        C_KM, G_NEW, GAUSS_TO_EV2, HBAR, INV_ALPHA, M_E_EV, SQRT_4PI_ALPHA)

    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    rr = np.sqrt(px * px + py * py + pz * pz)
    cz = pz / rr
    st = np.sqrt(np.clip(1.0 - cz * cz, 1e-30, None))
    rs0 = 2.0 * G_NEW * sc.mass_ns / C_KM ** 2
    aa = np.where(rr < sc.r_ns, 1.0, 1.0 - rs0 / rr)
    dr_dt = (px * vloc[0] + py * vloc[1] + pz * vloc[2]) / rr
    v_th = (pz * dr_dt - rr * vloc[2]) / (rr * st)
    v_ph = (-py * vloc[0] + px * vloc[1]) / (rr * st)
    w_r = dr_dt / np.sqrt(aa) / aa
    w_t = v_th * rr / aa
    w_p = v_ph * (rr * st) / aa
    inside = rr <= sc.r_ns
    rs = np.where(inside, rs0 * (rr / sc.r_ns) ** 3, rs0)
    g_tt = np.where(
        inside,
        -4.0 / (3.0 * np.sqrt(np.clip(1.0 - rs / sc.r_ns, 1e-30, None))
                - np.sqrt(np.clip(1.0 - rr ** 2 * rs / sc.r_ns ** 3, 1e-30,
                                  None))) ** 2,
        -1.0 / (1.0 - rs / rr))
    g_rr = np.where(inside, 1.0 - rr ** 2 * rs / sc.r_ns ** 3, 1.0 - rs / rr)
    g_thth = 1.0 / rr ** 2
    g_pp = 1.0 / (rr * st) ** 2
    nrm = np.sqrt((-(erg ** 2) * g_tt - sc.mass_a ** 2)
                  / (g_rr * w_r ** 2 + g_thth * w_t ** 2 + g_pp * w_p ** 2))
    w_r, w_t, w_p = w_r * nrm, w_t * nrm, w_p * nrm
    cm, sm = np.cos(sc.theta_m), np.sin(sc.theta_m)
    bnorm = sc.b0 * (sc.r_ns / rr) ** 3 / 2.0
    cp, sp = px / (rr * st), py / (rr * st)
    br = 2.0 * bnorm * (cm * cz + sm * st * cp)
    bth = bnorm * (cm * st - sm * cz * cp)
    bph = bnorm * sm * sp
    bz = br * cz - bth * st
    nelec = np.abs(2.0 * sc.omega_pul * bz) / SQRT_4PI_ALPHA * GAUSS_TO_EV2 * HBAR
    wp = np.sqrt(4.0 * np.pi * nelec / INV_ALPHA / M_E_EV)
    bl = (br / np.sqrt(g_rr), bth / np.sqrt(g_thth), bph / np.sqrt(g_pp))
    bmag = np.sqrt(g_rr * bl[0] ** 2 + g_thth * bl[1] ** 2 + g_pp * bl[2] ** 2)
    kp = (g_rr * w_r * bl[0] + g_thth * w_t * bl[1]
          + g_pp * w_p * bl[2]) / bmag
    ksqr = g_tt * erg ** 2 + g_rr * w_r ** 2 + g_thth * w_t ** 2 + g_pp * w_p ** 2
    e2 = erg ** 2 / g_rr
    return 0.5 * (ksqr + wp ** 2 * (e2 - kp ** 2) / e2) / erg ** 2


@pytest.mark.parametrize("theta_m", [0.0, 0.2, 0.6])
def test_line_condition_matches_numpy_at_production_width(theta_m):
    """The sampler's XLA line condition (the dense [lines, n_grid] scan of
    find_samples_new) agrees with an independent numpy evaluation along
    whole sampling lines at the production grid width."""
    sc = Scene(mass_a=1e-5, ax_g=1e-12, theta_m=theta_m, omega_pul=1.0,
               b0=1e14, r_ns=10.0, mass_ns=1.0)
    maxR = float(conversion_surface_radius(sc.mass_a, sc.theta_m,
                                           sc.omega_pul, sc.b0, sc.r_ns))
    n_grid = sampler.default_n_grid(maxR)
    assert n_grid > 2000
    s_grid = np.linspace(0.0, 2.2 * maxR, n_grid)
    for line in range(3):
        geo = sampler._draw_one(jax.random.PRNGKey(10 + line), maxR, sc,
                                220.0, True, jnp.float64)
        pts = (np.asarray(geo.x0)[None, :]
               + s_grid[:, None] * np.asarray(geo.vvec)[None, :])
        got = np.asarray(jax.jit(jax.vmap(lambda p: sampler._line_condition(
            p, geo.vvec_loc, geo.erg_inf, sc, sc.mass_ns, True)))(
                jnp.asarray(pts)))
        want = _numpy_line_condition(pts, np.asarray(geo.vvec_loc),
                                     float(geo.erg_inf), sc)
        assert np.all(np.isfinite(got))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12 * scale)
        # sign flips (the sampler's roots) are the same grid intervals
        np.testing.assert_array_equal(np.sign(got[1:] * got[:-1]),
                                      np.sign(want[1:] * want[:-1]))
