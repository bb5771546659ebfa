"""Dispersion relations: photon/axion Hamiltonians, local frequency, on-shell
normalization and k-parallel projection.

Mirrors the L2 layer of the reference (RayTracer.jl:530-685, 1044-1058,
1311-1325) as pure functions of (point, momentum, time, scene).

Momentum convention: covariant spherical ("celerity") components
k = (k_r, k_theta, k_phi) carrying the energy scale in eV (i.e. w * erg).
`erg` is the conserved energy-at-infinity -p_t.
"""

from __future__ import annotations

import jax.numpy as jnp

from adiabatic_raytracer.config import Scene
from adiabatic_raytracer.models.magnetosphere import b_sph_lower, omega_p_sph
from adiabatic_raytracer.models.metric import metric_inverse
from adiabatic_raytracer.ops.geometry import cart_to_sph, celerity_from_cart


def _clamp_r(x_sph, r_ns):
    """The reference clamps r below the stellar surface before evaluating the
    photon dispersion (RayTracer.jl:531, 560)."""
    return x_sph.at[..., 0].set(jnp.maximum(x_sph[..., 0], r_ns))


def k_par(x_sph, k, t, sc: Scene, mass_ns, b_mass_ns=None):
    """Momentum component parallel to B (K_par, RayTracer.jl:1044-1058).

    b_mass_ns: mass used when lowering the B components (the reference's
    `flat` switch inside GJ_Model_Sphereical); defaults to mass_ns.
    """
    if b_mass_ns is None:
        b_mass_ns = mass_ns
    b_low = b_sph_lower(x_sph, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns, b_mass_ns)
    g_tt, g_rr, g_thth, g_pp = metric_inverse(x_sph, mass_ns)
    bmag = jnp.sqrt(g_rr * b_low[..., 0] ** 2 + g_thth * b_low[..., 1] ** 2 + g_pp * b_low[..., 2] ** 2)
    return (
        g_rr * k[..., 0] * b_low[..., 0]
        + g_thth * k[..., 1] * b_low[..., 1]
        + g_pp * k[..., 2] * b_low[..., 2]
    ) / bmag


def ctheta_b_sphere(x_sph, k, t, sc: Scene, mass_ns):
    """cos(angle between k and B) in the covariant 3-metric
    (Ctheta_B_sphere, RayTracer.jl:957-971)."""
    b_low = b_sph_lower(x_sph, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns, mass_ns)
    g_tt, g_rr, g_thth, g_pp = metric_inverse(x_sph, mass_ns)
    bnorm = jnp.sqrt(g_rr * b_low[..., 0] ** 2 + g_thth * b_low[..., 1] ** 2 + g_pp * b_low[..., 2] ** 2)
    knorm = jnp.sqrt(g_rr * k[..., 0] ** 2 + g_thth * k[..., 1] ** 2 + g_pp * k[..., 2] ** 2)
    return (
        g_rr * k[..., 0] * b_low[..., 0]
        + g_thth * k[..., 1] * b_low[..., 1]
        + g_pp * k[..., 2] * b_low[..., 2]
    ) / (knorm * bnorm)


def hamiltonian_photon(x_sph, k, t, erg, sc: Scene, mass_ns, *, zero_in=False,
                       bndry_lyr=-1.0):
    """Photon Hamiltonian, three dispersion modes (RayTracer.jl:530-556).

    Production mode is the anisotropic Melrose form (Gen_Samples.jl:167):
        H = 1/2 [ k.k + g^tt erg^2 + wp^2 (erg^2/g_rr - kpar^2)/(erg^2/g_rr) ]

    bndry_lyr is passed explicitly because the reference's photon RHS omits
    the boundary-layer term in the spatial gradients but includes it in the
    time derivative (RayTracer.jl:84-88) — call sites choose.
    """
    x0 = _clamp_r(x_sph, sc.r_ns)
    wp = omega_p_sph(x0, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                     mass_a=sc.mass_a, bndry_lyr=bndry_lyr, zero_in=zero_in)
    g_tt, g_rr, g_thth, g_pp = metric_inverse(x0, mass_ns)
    ksqr = g_tt * erg**2 + g_rr * k[..., 0] ** 2 + g_thth * k[..., 1] ** 2 + g_pp * k[..., 2] ** 2
    if sc.isotropic:
        return 0.5 * (ksqr + wp**2)
    if not sc.melrose:
        ct = ctheta_b_sphere(x0, k, t, sc, mass_ns)
        e2 = erg**2 / g_rr
        return 0.5 * (ksqr - wp**2 * (1.0 - ct**2) / (wp**2 * ct**2 - e2) * e2)
    kp = k_par(x0, k, t, sc, mass_ns)
    e2 = erg**2 / g_rr
    return 0.5 * (ksqr + wp**2 * (e2 - kp**2) / e2)


def hamiltonian_axion(x_sph, k, erg, mass_ns):
    """Axion Hamiltonian H = 1/2 k.k (massive geodesic; the mass enters via
    the on-shell energy normalization).  RayTracer.jl:632-640."""
    g_tt, g_rr, g_thth, g_pp = metric_inverse(x_sph, mass_ns)
    ksqr = g_tt * erg**2 + g_rr * k[..., 0] ** 2 + g_thth * k[..., 1] ** 2 + g_pp * k[..., 2] ** 2
    return 0.5 * ksqr


def omega_function(x_sph, k, t, sc: Scene, mass_ns, *, iso=None, kmag=None,
                   zero_in=False, bndry_lyr=-1.0):
    """Local photon frequency omega(x, k) (omega_function, RayTracer.jl:558-589).

    Returns the *local* energy (no lapse factor).  iso defaults to
    sc.isotropic; the anisotropic branch is the Melrose root
        omega^2 = (k.k + wp^2 + sqrt(k.k^2 + 2 k.k wp^2 - 4 kpar^2 wp^2 + wp^4))/2.
    """
    if iso is None:
        iso = sc.isotropic
    x0 = _clamp_r(x_sph, sc.r_ns)
    wp = omega_p_sph(x0, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                     mass_a=sc.mass_a, bndry_lyr=bndry_lyr, zero_in=zero_in)
    g_tt, g_rr, g_thth, g_pp = metric_inverse(x0, mass_ns)
    if kmag is None:
        ksqr = g_rr * k[..., 0] ** 2 + g_thth * k[..., 1] ** 2 + g_pp * k[..., 2] ** 2
    else:
        ksqr = kmag**2
    if iso:
        return jnp.sqrt(ksqr + wp**2)
    kp = k_par(x0, k, t, sc, mass_ns)
    disc = ksqr**2 + 2.0 * ksqr * wp**2 - 4.0 * kp**2 * wp**2 + wp**4
    # NOTE: the reference divides by sqrt(2), not 2 (RayTracer.jl:584) — an
    # apparent off-by-2^(1/4) that is inert in production because only
    # *normalized* gradients of omega_function reach observable quantities.
    # Reproduced verbatim for parity.
    return jnp.sqrt((ksqr + wp**2 + jnp.sqrt(disc)) / jnp.sqrt(2.0))


def k_norm_cart(x_cart, khat_cart, t, erg, sc: Scene, mass_ns, *, is_photon=True,
                ax_fix=False, flat=False):
    """Scale a Cartesian direction onto the dispersion shell
    (k_norm_Cart, RayTracer.jl:643-685).

    Notes from the reference: the metric here always uses the full NS mass;
    the `flat` switch only reaches the K_par B-lowering.  With ax_fix=True the
    photon is normalized onto the *axion* shell (used when spawning photons at
    level crossings, where the shells coincide).
    """
    x_sph = cart_to_sph(x_cart)
    w = celerity_from_cart(x_cart, khat_cart, mass_ns)
    g_tt, g_rr, g_thth, g_pp = metric_inverse(x_sph, mass_ns)
    wsq = g_rr * w[..., 0] ** 2 + g_thth * w[..., 1] ** 2 + g_pp * w[..., 2] ** 2
    if (not is_photon) or ax_fix:
        nrm_sq = (-(erg**2) * g_tt - sc.mass_a**2) / wsq
    else:
        wp = omega_p_sph(x_sph, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                         mass_a=sc.mass_a, bndry_lyr=sc.bndry_lyr, zero_in=True)
        if sc.isotropic:
            kp = 0.0
        else:
            kp = k_par(x_sph, w, t, sc, mass_ns,
                       b_mass_ns=0.0 if flat else mass_ns)
        nrm_sq = (-(erg**2) * g_tt - wp**2) / (wsq - wp**2 / (-(erg**2) * g_tt) * kp**2)
    return jnp.sqrt(nrm_sq)[..., None] * khat_cart


def k_sphere(x_cart, k_cart, mass_ns, flat=False):
    """Cartesian momentum -> covariant celerity (k_sphere, RayTracer.jl:983-1008).
    No 1/erg normalization (matches the reference)."""
    m = 0.0 if flat else mass_ns
    return celerity_from_cart(x_cart, k_cart, m)


def test_on_shell(x_cart, v_loc, v_ifty_mag, time0, sc: Scene, mass_ns, *,
                  iso=True, melrose=False, bndry_lyr=-1.0):
    """On-shell diagnostic: |H|/erg_inf^2 at a batch of launch states
    (test_on_shell, RayTracer.jl:591-629).

    The reference keeps this as a callable debugging probe (not wired into
    the production path): build the celerity state from a local velocity
    direction, renormalize onto the axion shell, and evaluate the photon
    Hamiltonian.  Returns (vals_at_propagating_points, propagating_mask,
    min |H|/erg^2 over the whole batch), where propagating means the local
    energy exceeds omega_p.
    """
    import dataclasses

    from adiabatic_raytracer.constants import C_KM
    from adiabatic_raytracer.models.metric import schwarzschild_radius

    x_cart = jnp.atleast_2d(x_cart)
    v_loc = jnp.atleast_2d(v_loc)
    v_ifty_mag = jnp.atleast_1d(v_ifty_mag)

    r = jnp.linalg.norm(x_cart, axis=-1)
    r_s0 = schwarzschild_radius(mass_ns)
    aa = 1.0 - r_s0 / jnp.maximum(r, sc.r_ns)  # interior clamp (RayTracer.jl:602-603)

    gamma_a = 1.0 / jnp.sqrt(1.0 - (v_ifty_mag / C_KM) ** 2)
    erg_inf = sc.mass_a * jnp.sqrt(1.0 + (v_ifty_mag / C_KM * gamma_a) ** 2)
    erg_loc = erg_inf / jnp.sqrt(aa)

    v0 = v_loc * (erg_loc / jnp.sqrt(erg_loc**2 + sc.mass_a**2))[:, None]
    x_sph = cart_to_sph(x_cart)
    w0 = celerity_from_cart(x_cart, v0, mass_ns)

    g_tt, g_rr, g_thth, g_pp = metric_inverse(x_sph, mass_ns)
    wsq = g_rr * w0[..., 0] ** 2 + g_thth * w0[..., 1] ** 2 + g_pp * w0[..., 2] ** 2
    nrm_sq = (-(erg_inf**2) * g_tt - sc.mass_a**2) / wsq
    w0 = w0 * jnp.sqrt(nrm_sq)[:, None]

    sc_eval = dataclasses.replace(sc, isotropic=bool(iso), melrose=bool(melrose))
    val = hamiltonian_photon(x_sph, w0, time0, erg_inf, sc_eval, mass_ns,
                             zero_in=False, bndry_lyr=bndry_lyr) / erg_inf**2
    wp = omega_p_sph(x_sph, time0, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                     mass_a=sc.mass_a, bndry_lyr=bndry_lyr, zero_in=False)
    propagating = erg_loc > wp
    vals = jnp.where(propagating, val, jnp.nan)
    return vals, propagating, jnp.min(jnp.abs(val))
