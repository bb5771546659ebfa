"""Coordinate and momentum transforms: Cartesian <-> spherical, celerity.

These mirror the inline transform blocks of `propagate`
(RayTracer.jl:196-216, 404-416) and `k_sphere` (983-1008).

State conventions (as in the reference):
  * x_sph = [r, theta, phi] with r in km
  * "celerity" momenta w = (p_r, p_theta, p_phi) (covariant, lower index),
    built from a Cartesian direction vector by
        v_pl = (dr/dt, r dtheta/dt, r sin(theta) dphi/dt)
        w    = (v_r / sqrt(A), v_th * r, v_ph * r sin th) / A,  A = 1 - r_s/r
  * the integrator state stores w / erg_inf (order-1 values).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from adiabatic_raytracer.models.metric import lapse_A, metric_inverse


def cart_to_sph(x):
    """(..., 3) Cartesian -> [r, theta, phi]."""
    r = jnp.sqrt(jnp.sum(x * x, axis=-1))
    theta = jnp.arccos(x[..., 2] / r)
    phi = jnp.arctan2(x[..., 1], x[..., 0])
    return jnp.stack([r, theta, phi], axis=-1)


def sph_to_cart(x_sph):
    r, theta, phi = x_sph[..., 0], x_sph[..., 1], x_sph[..., 2]
    st, ct = jnp.sin(theta), jnp.cos(theta)
    return jnp.stack([r * st * jnp.cos(phi), r * st * jnp.sin(phi), r * ct], axis=-1)


def cart_vel_to_sph(x_cart, v_cart):
    """Cartesian velocity -> (dr/dt, r dth/dt, r sth dph/dt) (RayTracer.jl:205-206)."""
    r = jnp.sqrt(jnp.sum(x_cart * x_cart, axis=-1))
    sin_theta = jnp.sqrt(jnp.clip(1.0 - (x_cart[..., 2] / r) ** 2, 1e-30, None))
    dr_dt = jnp.sum(x_cart * v_cart, axis=-1) / r
    v_th = (x_cart[..., 2] * dr_dt - r * v_cart[..., 2]) / (r * sin_theta)
    v_ph = (-x_cart[..., 1] * v_cart[..., 0] + x_cart[..., 0] * v_cart[..., 1]) / (r * sin_theta)
    return jnp.stack([dr_dt, v_th, v_ph], axis=-1)


def celerity_from_cart(x_cart, v_cart, mass_ns):
    """Cartesian direction -> covariant celerity w (RayTracer.jl:209-211).

    Units: [eV, eV km, eV km] when v_cart carries an energy scale; the overall
    scale is arbitrary for direction vectors (later normalized on-shell).
    """
    x_sph = cart_to_sph(x_cart)
    r = x_sph[..., 0]
    sin_theta = jnp.sin(x_sph[..., 1])
    v_pl = cart_vel_to_sph(x_cart, v_cart)
    a = lapse_A(r, mass_ns)
    w = jnp.stack(
        [
            v_pl[..., 0] / jnp.sqrt(a),
            v_pl[..., 1] * r,
            v_pl[..., 2] * (r * sin_theta),
        ],
        axis=-1,
    ) / a[..., None]
    return w


def celerity_to_cart_vel(x_sph, w, mass_ns, a=None):
    """Covariant celerity w -> Cartesian proper velocity (RayTracer.jl:406-416).

    v_pl = [w_r sqrt(A), w_th / r, w_ph / (r sth)] * A, then rotated to
    Cartesian.  The caller multiplies in the energy scale (erg) as needed.
    Pass `a` to override the lapse (e.g. interior-scaled, RayTracer.jl:398-406).
    """
    r, theta, phi = x_sph[..., 0], x_sph[..., 1], x_sph[..., 2]
    if a is None:
        a = lapse_A(r, mass_ns)
    v_r = w[..., 0] * jnp.sqrt(a) * a
    v_th = w[..., 1] / r * a
    v_ph = w[..., 2] / (r * jnp.sin(theta)) * a
    st, ct = jnp.sin(theta), jnp.cos(theta)
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    v_tmp = st * v_r + ct * v_th
    vx = cp * v_tmp - sp * v_ph
    vy = sp * v_tmp + cp * v_ph
    vz = ct * v_r - st * v_th
    return jnp.stack([vx, vy, vz], axis=-1)


def spatial_dot(x_sph, a, b, mass_ns):
    """Covariant 3-dot sum_i g^{ii} a_i b_i (spatial_dot, RayTracer.jl:973-981)."""
    g_tt, g_rr, g_thth, g_pp = metric_inverse(x_sph, mass_ns)
    return g_rr * a[..., 0] * b[..., 0] + g_thth * a[..., 1] * b[..., 1] + g_pp * a[..., 2] * b[..., 2]


def spatial_norm(x_sph, a, mass_ns):
    return jnp.sqrt(spatial_dot(x_sph, a, a, mass_ns))


# ---------------------------------------------------------------------------
# Conversion-surface-angle diagnostics (single-point; vmap over batches).
# These are inventoried components of the reference that are dead in its
# production path — provided for API parity and analysis use.
# ---------------------------------------------------------------------------


def _surface_normal_sph(x_sph, t, sc, mass_ns):
    """Covariant, metric-normalized gradient of omega_p: the conversion-
    surface normal (surfNorm inner block, RayTracer.jl:914-916)."""
    from adiabatic_raytracer.models.magnetosphere import omega_p_sph

    grd = jax.grad(
        lambda xp: omega_p_sph(xp, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                               mass_a=sc.mass_a, bndry_lyr=sc.bndry_lyr)
    )(x_sph)
    return grd / spatial_norm(x_sph, grd, mass_ns)


def surf_norm(x_cart, k_cart, t, sc, mass_ns, *, return_vec=False):
    """cos(angle) between the ray momentum and the conversion-surface normal
    grad(omega_p), in the covariant 3-metric (surfNorm, RayTracer.jl:895-933).
    Single point; vmap for batches."""
    x_sph = cart_to_sph(x_cart)
    w = celerity_from_cart(x_cart, k_cart, mass_ns)
    snorm = _surface_normal_sph(x_sph, t, sc, mass_ns)
    ctheta = spatial_dot(x_sph, w, snorm, mass_ns) / spatial_norm(x_sph, w, mass_ns)
    if return_vec:
        return ctheta, snorm
    return ctheta


def angle_vg_snorm(x_cart, vg_cart, t, sc, mass_ns, *, return_vec=False):
    """cos(angle) between the group velocity and the conversion-surface normal
    (angle_vg_sNorm, RayTracer.jl:1011-1042).  The reference evaluates the
    identical covariant-celerity projection as surfNorm; only the Mvars
    plumbing differs, so this shares the implementation."""
    return surf_norm(x_cart, vg_cart, t, sc, mass_ns, return_vec=return_vec)


def theta_b_cart(x_cart, k_cart, t, sc):
    """Angle between k and B in flat Cartesian components
    (theta_B, RayTracer.jl:951-955)."""
    from adiabatic_raytracer.models.magnetosphere import b_cart

    b = b_cart(x_cart, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns)
    cos_t = jnp.sum(k_cart * b, axis=-1) / jnp.sqrt(
        jnp.sum(k_cart * k_cart, axis=-1) * jnp.sum(b * b, axis=-1))
    return jnp.arccos(cos_t)


def dtheta_dr_proj(x_cart, k_cart, t, sc):
    """|k_hat . grad(theta_B)| (dθdr_proj, RayTracer.jl:1060-1063).
    Single point; vmap for batches."""
    grd = jax.grad(lambda x: theta_b_cart(x, k_cart, t, sc))(x_cart)
    return jnp.abs(jnp.sum(k_cart * grd)) / jnp.sqrt(jnp.sum(k_cart * k_cart))


def dwdr_abs_proj(x_cart, k_cart, t, sc):
    """|k_hat . grad(omega_p)| in Cartesian coordinates.  The reference's
    `d2wdr2_abs_vec` calls a `dwdr_abs_vec` that is NOT defined anywhere in
    the repo (dangling dead-code dependency, RayTracer.jl:939-942); this is
    the projection its name and call signature imply."""
    from adiabatic_raytracer.models.magnetosphere import omega_p_cart

    grd = jax.grad(
        lambda x: omega_p_cart(x, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                               mass_a=sc.mass_a, bndry_lyr=sc.bndry_lyr)
    )(x_cart)
    return jnp.abs(jnp.sum(k_cart * grd)) / jnp.sqrt(jnp.sum(k_cart * k_cart))


def d2wdr2_abs_vec(x_cart, k_cart, t, sc):
    """Second directional derivative bundle of omega_p along the ray
    (d2wdr2_abs_vec, RayTracer.jl:936-949):

        (2/tan(theta_B) * dθdr_proj * dwdr - d2wdr2_proj) / sin(theta_B)^2

    The reference function is dead code whose inner `dwdr_abs_vec` is
    undefined there; this implements the formula with `dwdr_abs_proj` in
    that role.  Single point; vmap for batches."""
    d2_grd = jax.grad(lambda x: dwdr_abs_proj(x, k_cart, t, sc))(x_cart)
    khat_norm = jnp.sqrt(jnp.sum(k_cart * k_cart))
    d2_proj = jnp.abs(jnp.sum(k_cart * d2_grd)) / khat_norm
    dwdr = dwdr_abs_proj(x_cart, k_cart, t, sc)
    theta = theta_b_cart(x_cart, k_cart, t, sc)
    d0dr = dtheta_dr_proj(x_cart, k_cart, t, sc)
    return (2.0 / jnp.tan(theta) * d0dr * dwdr - d2_proj) / jnp.sin(theta) ** 2
