"""Dispersion layer property tests (vs RayTracer.jl:530-685)."""

import jax.numpy as jnp
import numpy as np
import pytest

from adiabatic_raytracer.config import Scene
from adiabatic_raytracer.models.metric import metric_inverse
from adiabatic_raytracer.ops import dispersion as disp
from adiabatic_raytracer.ops.geometry import cart_to_sph, celerity_from_cart, sph_to_cart


SC = Scene(mass_a=1e-5, theta_m=0.4, omega_pul=1.0, b0=1e14, r_ns=10.0, mass_ns=1.0)


def _shell_point():
    # near (outside) the conversion surface for m_a = 1e-5
    x_cart = jnp.array([80.0, 35.0, 120.0])
    khat = jnp.array([0.3, -0.5, 0.81])
    khat = khat / jnp.linalg.norm(khat)
    return x_cart, khat


def test_photon_knorm_on_shell():
    """After k_norm_cart (full dispersion), H_photon == 0."""
    x_cart, khat = _shell_point()
    erg = 1.2e-5
    k_cart = disp.k_norm_cart(x_cart, khat, 0.0, erg, SC, SC.mass_ns, is_photon=True)
    w = celerity_from_cart(x_cart, k_cart, SC.mass_ns)
    h = disp.hamiltonian_photon(cart_to_sph(x_cart), w, 0.0, erg, SC, SC.mass_ns,
                                zero_in=True)
    assert abs(float(h)) / erg**2 < 1e-10


def test_axion_knorm_on_shell():
    x_cart, khat = _shell_point()
    erg = 1.00002e-5  # slow axion: erg barely above mass
    k_cart = disp.k_norm_cart(x_cart, khat, 0.0, erg, SC, SC.mass_ns, is_photon=False)
    w = celerity_from_cart(x_cart, k_cart, SC.mass_ns)
    h = disp.hamiltonian_axion(cart_to_sph(x_cart), w, erg, SC.mass_ns)
    # On the axion shell k.k = -m^2, so H_axion = -m^2/2 (RayTracer.jl:632-640).
    np.testing.assert_allclose(float(h), -SC.mass_a**2 / 2.0, rtol=1e-9)


def test_omega_function_consistency():
    """H_photon(x, k, erg = omega*sqrt(g_rr)) == 0 when omega = omega_function(x,k).

    Verifies the Melrose Hamiltonian and the closed-form local frequency are
    roots of the same dispersion relation (accounting for the reference's
    sqrt(2) quirk, which we undo here with the 2^(1/4) factor)."""
    x_cart, khat = _shell_point()
    x_sph = cart_to_sph(x_cart)
    w = celerity_from_cart(x_cart, khat * 2e-5, SC.mass_ns)
    om_ref = disp.omega_function(x_sph, w, 0.0, SC, SC.mass_ns)
    om_true = om_ref / 2.0**0.25  # undo reference's /sqrt(2)-instead-of-/2
    g_tt, g_rr, _, _ = metric_inverse(x_sph, SC.mass_ns)
    erg_inf = om_true * jnp.sqrt(g_rr)
    h = disp.hamiltonian_photon(x_sph, w, 0.0, erg_inf, SC, SC.mass_ns)
    assert abs(float(h)) / float(erg_inf) ** 2 < 1e-10


def test_kpar_bounds():
    """|k_par| <= |k| with equality iff k parallel B."""
    x_cart, khat = _shell_point()
    x_sph = cart_to_sph(x_cart)
    w = celerity_from_cart(x_cart, khat, SC.mass_ns)
    kp = disp.k_par(x_sph, w, 0.0, SC, SC.mass_ns)
    g_tt, g_rr, g_thth, g_pp = metric_inverse(x_sph, SC.mass_ns)
    kmag = jnp.sqrt(g_rr * w[0] ** 2 + g_thth * w[1] ** 2 + g_pp * w[2] ** 2)
    assert abs(float(kp)) <= float(kmag) * (1 + 1e-12)
    ct = disp.ctheta_b_sphere(x_sph, w, 0.0, SC, SC.mass_ns)
    np.testing.assert_allclose(float(kp) / float(kmag), float(ct), rtol=1e-10)


def test_isotropic_mode():
    sc_iso = Scene(mass_a=1e-5, theta_m=0.4, isotropic=True, melrose=False)
    x_cart, khat = _shell_point()
    erg = 1.2e-5
    k_cart = disp.k_norm_cart(x_cart, khat, 0.0, erg, sc_iso, sc_iso.mass_ns, is_photon=True)
    w = celerity_from_cart(x_cart, k_cart, sc_iso.mass_ns)
    h = disp.hamiltonian_photon(cart_to_sph(x_cart), w, 0.0, erg, sc_iso, sc_iso.mass_ns,
                                zero_in=True)
    assert abs(float(h)) / erg**2 < 1e-10


def test_celerity_roundtrip():
    """cart -> celerity -> cart velocity recovers direction."""
    from adiabatic_raytracer.ops.geometry import celerity_to_cart_vel

    x_cart, khat = _shell_point()
    w = celerity_from_cart(x_cart, khat, SC.mass_ns)
    v_back = celerity_to_cart_vel(cart_to_sph(x_cart), w, SC.mass_ns)
    v_back = v_back / jnp.linalg.norm(v_back)
    np.testing.assert_allclose(np.asarray(v_back), np.asarray(khat), rtol=1e-9)
