"""Magnetosphere field tests (vs RayTracer.jl GJ model family)."""

import jax.numpy as jnp
import numpy as np

from adiabatic_raytracer.constants import GAUSS_TO_EV2, HBAR
from adiabatic_raytracer.models import magnetosphere as mag
from adiabatic_raytracer.ops.geometry import sph_to_cart


def ref_omega_p(bz, omega):
    """Independent transcription of the GJ plasma-frequency formula."""
    nelec = abs(2.0 * omega * bz) / np.sqrt(4 * np.pi / 137.0) * 1.95e-2 * HBAR
    return np.sqrt(4 * np.pi * nelec / 137.0 / 5.0e5)


def test_aligned_dipole_components():
    """theta_m = 0: pure static dipole, closed form."""
    b0, r_ns = 1e14, 10.0
    r, theta = 30.0, 0.8
    br, bth, bph = mag.dipole_sph(jnp.array([r, theta, 1.1]), 0.0, 0.0, 1.0, b0, r_ns)
    bnorm = b0 * (r_ns / r) ** 3 / 2
    np.testing.assert_allclose(float(br), 2 * bnorm * np.cos(theta), rtol=1e-12)
    np.testing.assert_allclose(float(bth), bnorm * np.sin(theta), rtol=1e-12)
    np.testing.assert_allclose(float(bph), 0.0, atol=1e-20)


def test_omega_p_aligned_value():
    b0, r_ns, omega = 1e14, 10.0, 1.0
    r, theta = 30.0, 0.8
    bnorm = b0 * (r_ns / r) ** 3 / 2
    bz = 2 * bnorm * np.cos(theta) * np.cos(theta) - bnorm * np.sin(theta) * np.sin(theta)
    want = ref_omega_p(bz, omega)
    got = mag.omega_p_sph(jnp.array([r, theta, 1.1]), 0.0, 0.0, omega, b0, r_ns)
    np.testing.assert_allclose(float(got), want, rtol=1e-12)


def test_omega_p_zero_in():
    x_in = jnp.array([5.0, 0.8, 1.1])
    assert float(mag.omega_p_sph(x_in, 0.0, 0.3, 1.0, 1e14, 10.0, zero_in=True)) == 0.0
    assert float(mag.omega_p_sph(x_in, 0.0, 0.3, 1.0, 1e14, 10.0, zero_in=False)) > 0.0


def test_cart_sph_consistency():
    """Cartesian B from rotation of spherical components."""
    x_sph = jnp.array([22.0, 1.2, -0.7])
    x_cart = sph_to_cart(x_sph)
    args = (0.3, 0.9, 1.3, 1e14, 10.0)  # t, theta_m, omega, b0, r_ns
    b_xyz = mag.b_cart(x_cart, *args)
    br, bth, bph = mag.dipole_sph(x_sph, *args)
    # |B| must agree between bases
    np.testing.assert_allclose(
        float(jnp.linalg.norm(b_xyz)),
        float(jnp.sqrt(br**2 + bth**2 + bph**2)),
        rtol=1e-10,
    )
    # omega_p computed via either path agrees
    wp_sph = mag.omega_p_sph(x_sph, *args, zero_in=False)
    wp_cart = mag.omega_p_cart(x_cart, *args)
    np.testing.assert_allclose(float(wp_sph), float(wp_cart), rtol=1e-10)


def test_rotation_phase():
    """Field pattern co-rotates: B(phi, t) = B(phi - omega dt, 0)."""
    args = (0.5, 2.0, 1e14, 10.0)  # theta_m, omega, b0, r_ns
    dt = 0.37
    x1 = jnp.array([25.0, 1.0, 0.9])
    x0 = jnp.array([25.0, 1.0, 0.9 - 2.0 * dt])
    b1 = mag.dipole_sph(x1, dt, *args)
    b0_ = mag.dipole_sph(x0, 0.0, *args)
    np.testing.assert_allclose(np.asarray(b1), np.asarray(b0_), rtol=1e-10)


def test_boundary_layer_term():
    sc_args = dict(mass_a=1e-5, bndry_lyr=1.0)
    x = jnp.array([40.0, 0.8, 1.1])
    base = mag.omega_p_sph(x, 0.0, 0.3, 1.0, 1e14, 10.0, zero_in=False)
    with_bl = mag.omega_p_sph(x, 0.0, 0.3, 1.0, 1e14, 10.0, zero_in=False, **sc_args)
    pole_val = ref_omega_p(1e14, 1.0)
    rmax = 10.0 * (pole_val / 1e-5) ** (2.0 / 3.0)
    want_term = pole_val * (10.0 / 40.0) ** 1.5 * np.exp(-(40.0 - rmax * 1.0) / (0.1 * rmax))
    np.testing.assert_allclose(float(with_bl - base), want_term, rtol=1e-10)


def test_conversion_surface_radius():
    """r_c = 1.01 r_NS (omega_p(theta_m/2)/m_a)^(2/3)."""
    mass_a, theta_m, omega, b0, r_ns = 1e-5, 0.4, 1.0, 1e14, 10.0
    got = mag.conversion_surface_radius(mass_a, theta_m, omega, b0, r_ns)
    x_eval = r_ns * np.array([np.sin(theta_m / 2), 0.0, np.cos(theta_m / 2)])
    wp = float(mag.omega_p_cart(jnp.asarray(x_eval), 0.0, theta_m, omega, b0, r_ns))
    np.testing.assert_allclose(float(got), r_ns * (wp / mass_a) ** (2 / 3) * 1.01, rtol=1e-10)
    assert 10.0 < float(got) < 1000.0  # sanity: ~25 km for these defaults
