"""Schwarzschild metric (inverse components) and Christoffel symbols.

Conventions follow the reference (RayTracer.jl:455-527): signature (-,+,+,+),
*contravariant* diagonal components g^{tt}, g^{rr}, g^{theta theta},
g^{phi phi} in spherical coordinates (r [km], theta, phi), with an interior
continuation for r <= r_NS in which the enclosed mass scales as (r/r_NS)^3.

All functions are scalar-per-point over the last axis (shape (..., 3)) and
safe under `jax.grad`/`jacfwd` (double-where guards against NaN cotangents).
"""

from __future__ import annotations

import jax.numpy as jnp

from adiabatic_raytracer.constants import C_KM, G_NEW
from adiabatic_raytracer.utils.precise import sin_p


def schwarzschild_radius(mass_ns):
    """r_s = 2 G M / c^2 [km] (RayTracer.jl:194)."""
    return 2.0 * G_NEW * mass_ns / C_KM**2


def metric_inverse(x_sph, mass_ns, r_ns=10.0):
    """Inverse metric components at spherical points x_sph = (..., [r, theta, phi]).

    Mirrors `g_schwartz` (RayTracer.jl:455-501), including the quirk that for
    r <= r_NS the Schwarzschild radius is first scaled by (r/r_NS)^3 and the
    interior (constant-density-like) lapse formula is then evaluated with the
    *scaled* r_s.  mass_ns may be 0 (flat space).
    """
    r = x_sph[..., 0]
    sin_theta = sin_p(x_sph[..., 1])
    rs0 = schwarzschild_radius(mass_ns)
    inside = r <= r_ns
    rs = jnp.where(inside, rs0 * (r / r_ns) ** 3, rs0)

    one_m = 1.0 - rs / r
    g_tt = -1.0 / one_m
    g_rr = one_m
    g_thth = 1.0 / r**2
    g_pp = 1.0 / (r * sin_theta) ** 2

    # Interior continuation (RayTracer.jl:496-497).  Guard the untaken branch:
    # its sqrt args can go negative far outside the star, which would poison
    # gradients through the jnp.where below.
    arg1 = jnp.where(inside, 1.0 - rs / r_ns, 1.0)
    arg2 = jnp.where(inside, 1.0 - r**2 * rs / r_ns**3, 1.0)
    g_tt_in = -4.0 / (3.0 * jnp.sqrt(arg1) - jnp.sqrt(arg2)) ** 2
    g_rr_in = arg2

    g_tt = jnp.where(inside, g_tt_in, g_tt)
    g_rr = jnp.where(inside, g_rr_in, g_rr)
    return g_tt, g_rr, g_thth, g_pp


def lapse_A(r, mass_ns):
    """A = 1 - r_s/r (exterior lapse; celerity transforms, RayTracer.jl:209)."""
    return 1.0 - schwarzschild_radius(mass_ns) / r


def christoffel(x_sph, mass_ns):
    """The ten Christoffel-symbol combinations used by `conversion_prob`.

    Mirrors `Cristoffel` (RayTracer.jl:503-527).  Note the reference computes
    GM from the full NS mass regardless of its `flat` switch; we reproduce
    that by simply taking mass_ns as given.  Returns
    (G_rrr, G_rtt, G_rpp, G_trt, G_tpp, G_prp, G_ptp, G_ttr, G_ppr, G_ppt).
    """
    r = x_sph[..., 0]
    theta = x_sph[..., 1]
    gm = G_NEW * mass_ns / C_KM**2
    g_rrr = -gm / (r * (r - 2.0 * gm))
    g_rtt = -(r - 2.0 * gm)
    g_rpp = -(r - 2.0 * gm) * jnp.sin(theta) ** 2
    g_trt = 1.0 / r
    g_tpp = -jnp.sin(theta) * jnp.cos(theta)
    g_prp = 1.0 / r
    g_ptp = jnp.cos(theta) / jnp.sin(theta)
    g_ttr = 1.0 / r
    g_ppr = 1.0 / r
    g_ppt = jnp.cos(theta) / jnp.sin(theta)
    return g_rrr, g_rtt, g_rpp, g_trt, g_tpp, g_prp, g_ptp, g_ttr, g_ppr, g_ppt
