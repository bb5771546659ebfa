"""Conversion-physics tests (vs RayTracer.jl:706-790, 1311-1473; MainRunner.jl:67-124)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adiabatic_raytracer.config import Scene
from adiabatic_raytracer.constants import C_KM, G_NEW
from adiabatic_raytracer.models.magnetosphere import omega_p_sph
from adiabatic_raytracer.ops import conversion as cv
from adiabatic_raytracer.ops.dispersion import k_norm_cart, k_sphere
from adiabatic_raytracer.ops.geometry import cart_to_sph


SC = Scene(mass_a=1e-5, ax_g=1e-12, theta_m=0.4, omega_pul=1.0, b0=1e14,
           r_ns=10.0, mass_ns=1.0)


def _conv_point():
    """A point near the conversion surface with an on-shell axion momentum."""
    x_cart = jnp.array([12.0, 4.0, 18.0])
    khat = jnp.array([0.2, -0.3, 0.93])
    khat = khat / jnp.linalg.norm(khat)
    vmag = jnp.sqrt(2 * G_NEW * 1.0 / jnp.linalg.norm(x_cart)) / C_KM
    erg_inf = SC.mass_a * (1.0 + float(vmag) ** 2 / 2)
    k_cart = k_norm_cart(x_cart, khat, 0.0, erg_inf, SC, SC.mass_ns, is_photon=False)
    return x_cart, k_cart, jnp.asarray(erg_inf)


def test_prob_positive_and_coupling_scaling():
    x, k, erg = _conv_point()
    p1 = cv.get_prob_nonad(x, k, erg, SC)
    sc10 = Scene(**{**{f: getattr(SC, f) for f in
                       ("mass_a", "theta_m", "omega_pul", "b0", "r_ns", "mass_ns")},
                    "ax_g": 1e-11})
    p2 = cv.get_prob_nonad(x, k, erg, sc10)
    assert float(p1) > 0 and np.isfinite(float(p1))
    np.testing.assert_allclose(float(p2) / float(p1), 100.0, rtol=1e-10)


def test_prob_plausible_magnitude():
    """P_nonAD for g=1e-12/GeV, B0=1e14 G should be a small number in (1e-12, 1)."""
    x, k, erg = _conv_point()
    p = float(cv.get_prob_nonad(x, k, erg, SC))
    assert 1e-12 < p < 1.0


def test_dwp_ds_iso_matches_fd():
    """Isotropic limit: |w'| = |khat . grad omega_p| (finite differences)."""
    sc = Scene(mass_a=1e-5, theta_m=0.4, isotropic=True, melrose=False)
    x_cart, k_cart, erg = _conv_point()
    ks = k_sphere(x_cart, k_cart, sc.mass_ns)
    w_erg = erg / jnp.sqrt(1 - 2 * G_NEW * 1.0 / jnp.linalg.norm(x_cart) / C_KM**2)
    out = cv.dwp_ds(x_cart, ks, 0.0, w_erg, sc, sc.mass_ns)
    w_prime = float(out[0])

    # finite-difference directional derivative of omega_p along khat (covariant)
    x_sph = cart_to_sph(x_cart)
    from adiabatic_raytracer.models.metric import metric_inverse
    g = metric_inverse(x_sph, sc.mass_ns)
    kmag = jnp.sqrt(g[1] * ks[0] ** 2 + g[2] * ks[1] ** 2 + g[3] * ks[2] ** 2)
    khat_cov = ks / kmag
    eps = 1e-6

    def wp(x):
        return float(omega_p_sph(x, 0.0, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                                 zero_in=True))

    grad_fd = np.array([
        (wp(x_sph.at[i].add(eps)) - wp(x_sph.at[i].add(-eps))) / (2 * eps)
        for i in range(3)
    ])
    want = abs(float(g[1] * khat_cov[0] * grad_fd[0] + g[2] * khat_cov[1] * grad_fd[1]
                     + g[3] * khat_cov[2] * grad_fd[2]))
    np.testing.assert_allclose(w_prime, want, rtol=1e-4)


def test_v_infinity_magnitude():
    """|v_inf(v_loc)| = sqrt(|v_loc|^2 - 2 G M / (r c^2))."""
    theta, phi, r = 0.7, 1.2, 25.0
    v_loc = jnp.array([0.3, -0.2, 0.25])  # above escape velocity (~0.34c at r=25)
    vinf = jnp.stack([cv.v_infinity(theta, phi, r, v_loc, v_comp=c) for c in range(3)])
    want = np.sqrt(float(jnp.sum(v_loc**2)) - 2 * G_NEW / r / C_KM**2)
    np.testing.assert_allclose(float(jnp.linalg.norm(vinf)), want, rtol=1e-10)


def test_solve_vel_cs_roundtrip():
    theta, phi, r = 0.7, 1.2, 25.0
    v_loc = jnp.array([0.3, -0.2, 0.25])  # above escape velocity (~0.34c at r=25)
    vinf = jnp.stack([cv.v_infinity(theta, phi, r, v_loc, v_comp=c) for c in range(3)])
    v_back, accur = cv.solve_vel_cs(theta, phi, r, vinf, guess=v_loc * 1.2)
    np.testing.assert_allclose(np.asarray(v_back), np.asarray(v_loc), rtol=1e-8)
    assert float(accur) < 1e-10


def test_jacobian_fv_finite():
    x = jnp.array([12.0, 4.0, 18.0])
    v = jnp.array([0.5, -0.3, 0.45])  # above escape velocity at r~22 km
    j = cv.jacobian_fv(x, v)
    assert np.isfinite(float(j)) and float(j) > 0


def test_g_det():
    x_sph = jnp.array([15.0, 0.8, 1.1])
    val = cv.g_det(x_sph, 0.0, SC, SC.mass_ns)
    assert 0.5 < float(val) < 1.0  # GR shrinks the area element
    val_flat = cv.g_det(x_sph, 0.0, SC, SC.mass_ns, flat=True)
    assert float(val_flat) == 1.0
