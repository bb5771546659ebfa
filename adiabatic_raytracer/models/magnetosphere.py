"""Goldreich–Julian magnetosphere: misaligned rotating dipole B and plasma frequency.

One parameterized implementation replaces the six near-duplicate evaluators of
the reference (`GJ_Model_vec` RayTracer.jl:854-891, `GJ_Model_ωp_vec` 1066-1103,
`Dipole_SPH` 1105-1118, `GJ_Model_ωp_vecSPH` 1120-1170, `GJ_Model_ωp_scalar`
1172-1209, `GJ_Model_scalar` 1211-1247, `GJ_Model_Sphereical` 1268-1309).

All functions broadcast over leading axes; points are (..., 3).
"""

from __future__ import annotations

import jax.numpy as jnp

from adiabatic_raytracer.constants import (
    GAUSS_TO_EV2,
    HBAR,
    INV_ALPHA,
    M_E_EV,
    SQRT_4PI_ALPHA,
)
from adiabatic_raytracer.models.metric import metric_inverse
from adiabatic_raytracer.utils.precise import cos_p, sin_p


def _omega_p_of_bz(bz, omega_pul):
    """Plasma frequency [eV] from the corotation charge density n_GJ ~ Omega.B.

    RayTracer.jl:877-878: n_e = |2 Omega B_z| / sqrt(4 pi / 137) * 1.95e-2 * hbar,
    omega_p = sqrt(4 pi n_e / 137 / 5e5).
    """
    nelec = jnp.abs(2.0 * omega_pul * bz) / SQRT_4PI_ALPHA * GAUSS_TO_EV2 * HBAR
    return jnp.sqrt(4.0 * jnp.pi * nelec / INV_ALPHA / M_E_EV)


def dipole_sph(x_sph, t, theta_m, omega_pul, b0, r_ns):
    """Orthonormal spherical components (B_r, B_theta, B_phi) [Gauss] of the
    rotating misaligned dipole (Dipole_SPH, RayTracer.jl:1105-1118)."""
    r = x_sph[..., 0]
    theta = x_sph[..., 1]
    phi = x_sph[..., 2]
    psi = phi - omega_pul * t
    bnorm = b0 * (r_ns / r) ** 3 / 2.0
    # precise trig: device-native f32 sin/cos may be too noisy for
    # rtol=1e-7 (utils/precise.py)
    ct, st = cos_p(theta), sin_p(theta)
    cm, sm = cos_p(theta_m), sin_p(theta_m)
    cp, sp = cos_p(psi), sin_p(psi)
    br = 2.0 * bnorm * (cm * ct + sm * st * cp)
    btheta = bnorm * (cm * st - sm * ct * cp)
    bphi = bnorm * sm * sp
    return br, btheta, bphi


def _bndry_lyr_term(r, mass_a, bndry_lyr, omega_pul, b0, r_ns):
    """Exponential boundary-layer addition to omega_p for r >= r_NS
    (RayTracer.jl:1155-1162).  Returns 0 where disabled or inside the star."""
    pole_val = _omega_p_of_bz(b0, omega_pul)
    rmax = r_ns * (pole_val / mass_a) ** (2.0 / 3.0)
    term = pole_val * (r_ns / r) ** 1.5 * jnp.exp(-(r - rmax * bndry_lyr) / (0.1 * rmax))
    return jnp.where((bndry_lyr > 0.0) & (r >= r_ns), term, 0.0)


def omega_p_sph(x_sph, t, theta_m, omega_pul, b0, r_ns, *, mass_a=1e-5,
                bndry_lyr=-1.0, zero_in=True):
    """omega_p [eV] at spherical points (GJ_Model_ωp_vecSPH, RayTracer.jl:1120-1170)."""
    r = x_sph[..., 0]
    theta = x_sph[..., 1]
    br, btheta, _ = dipole_sph(x_sph, t, theta_m, omega_pul, b0, r_ns)
    bz = br * cos_p(theta) - btheta * sin_p(theta)
    wp = _omega_p_of_bz(bz, omega_pul)
    wp = wp + _bndry_lyr_term(r, mass_a, bndry_lyr, omega_pul, b0, r_ns)
    if zero_in:
        wp = jnp.where(r <= r_ns, 0.0, wp)
    return wp


def _cart_to_sph_point(x):
    r = jnp.sqrt(jnp.sum(x * x, axis=-1))
    theta = jnp.arccos(x[..., 2] / r)
    phi = jnp.arctan2(x[..., 1], x[..., 0])
    return jnp.stack([r, theta, phi], axis=-1)


def omega_p_cart(x_cart, t, theta_m, omega_pul, b0, r_ns, *, mass_a=1e-5,
                 bndry_lyr=-1.0, zero_in=False):
    """omega_p [eV] at Cartesian points (GJ_Model_ωp_vec, RayTracer.jl:1066-1103).
    Note: the reference's Cartesian evaluator never zeroes the interior."""
    return omega_p_sph(_cart_to_sph_point(x_cart), t, theta_m, omega_pul, b0, r_ns,
                       mass_a=mass_a, bndry_lyr=bndry_lyr, zero_in=zero_in)


def b_cart(x_cart, t, theta_m, omega_pul, b0, r_ns):
    """Cartesian B-vector [Gauss] (GJ_Model_vec, RayTracer.jl:854-891)."""
    x_sph = _cart_to_sph_point(x_cart)
    theta = x_sph[..., 1]
    phi = x_sph[..., 2]
    br, btheta, bphi = dipole_sph(x_sph, t, theta_m, omega_pul, b0, r_ns)
    ct, st = jnp.cos(theta), jnp.sin(theta)
    cp, sp = jnp.cos(phi), jnp.sin(phi)
    bx = br * st * cp + btheta * ct * cp - bphi * sp
    by = br * st * sp + btheta * ct * sp + bphi * cp
    bz = br * ct - btheta * st
    return jnp.stack([bx, by, bz], axis=-1)


def b_sph_lower(x_sph, t, theta_m, omega_pul, b0, r_ns, mass_ns):
    """Covariant spherical B components B_i = B_{(i)} / sqrt(g^{ii})
    (GJ_Model_Sphereical with return_comp=-1, RayTracer.jl:1296-1298).
    Units: Gauss (no eV^2 conversion here, matching the reference)."""
    br, btheta, bphi = dipole_sph(x_sph, t, theta_m, omega_pul, b0, r_ns)
    g_tt, g_rr, g_thth, g_pp = metric_inverse(x_sph, mass_ns, r_ns=10.0)
    return jnp.stack(
        [br / jnp.sqrt(g_rr), btheta / jnp.sqrt(g_thth), bphi / jnp.sqrt(g_pp)],
        axis=-1,
    )


def b_sph_component(x_sph, t, theta_m, omega_pul, b0, r_ns, mass_ns, comp):
    """Scalar B quantities for AD seeding (GJ_Model_Sphereical return_comp=0..3,
    RayTracer.jl:1299-1307): 0 -> |B| * 1.95e-2 (orthonormal magnitude, eV^2);
    1..3 -> contravariant components B^i * 1.95e-2."""
    br, btheta, bphi = dipole_sph(x_sph, t, theta_m, omega_pul, b0, r_ns)
    if comp == 0:
        return jnp.sqrt(br**2 + btheta**2 + bphi**2) * GAUSS_TO_EV2
    g_tt, g_rr, g_thth, g_pp = metric_inverse(x_sph, mass_ns, r_ns=10.0)
    if comp == 1:
        return br / jnp.sqrt(g_rr) * g_rr * GAUSS_TO_EV2
    if comp == 2:
        return btheta / jnp.sqrt(g_thth) * g_thth * GAUSS_TO_EV2
    if comp == 3:
        return bphi / jnp.sqrt(g_pp) * g_pp * GAUSS_TO_EV2
    raise ValueError(f"comp must be in 0..3, got {comp}")


def conversion_surface_radius(mass_a, theta_m, omega_pul, b0, r_ns, t_in=0.0):
    """Estimate of the maximum conversion-surface radius, used to size the
    sampling disk (Find_Conversion_Surface, RayTracer.jl:1250-1263)."""
    theta_ev = jnp.where(theta_m < jnp.pi / 2.0, theta_m / 2.0, (theta_m + jnp.pi) / 2.0)
    x_eval = r_ns * jnp.stack(
        [jnp.sin(theta_ev), jnp.zeros_like(theta_ev), jnp.cos(theta_ev)], axis=-1
    )
    om_test = omega_p_cart(x_eval, t_in, theta_m, omega_pul, b0, r_ns)
    return r_ns * (om_test / mass_a) ** (2.0 / 3.0) * 1.01


def cyclotron_freq_cart(x_cart, t, theta_m, omega_pul, b0, r_ns):
    """Electron cyclotron frequency [eV] (cyclotronF_vec, RayTracer.jl:798-802)."""
    b = b_cart(x_cart, t, theta_m, omega_pul, b0, r_ns)
    bmag = jnp.sqrt(jnp.sum(b * b, axis=-1))
    return bmag * 0.3 / 5.11e5 * (1.95e-20 * 1e18)
