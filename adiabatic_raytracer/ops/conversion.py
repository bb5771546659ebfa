"""Conversion physics: Landau–Zener probability, gradient bundles, jacobians.

Mirrors the reference layer L4a:
  * k_gamma            RayTracer.jl:1311-1325
  * dwp_ds             RayTracer.jl:1327-1403 (gradient bundle along the ray)
  * conversion_prob    RayTracer.jl:1405-1473 (Landau–Zener, aniso prefactor)
  * get_prob_nonad     MainRunner.jl:67-124  (driver-side wrapper)
  * g_det              RayTracer.jl:734-754  (area jacobian sqrt(-g) ratio)
  * v_infinity / jacobian_fv   RayTracer.jl:756-790 (Liouville phase-space weight)
  * solve_vel_cs       RayTracer.jl:706-732  (Newton inverse; dead in prod path)

All hand-rolled ForwardDiff dual seeding of the reference becomes forward-mode
AD (`jax.jacfwd` — forward tangents stay O(1), so the f32 compute path cannot
underflow the way reverse-mode cotangents do through 1e13-scale B fields).
Functions are scalar per point; batch via `jax.vmap` at the call site.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from adiabatic_raytracer.config import Scene
from adiabatic_raytracer.constants import C_KM, G_NEW, GAUSS_TO_EV2, HBAR
from adiabatic_raytracer.models.magnetosphere import (
    b_sph_component,
    b_sph_lower,
    omega_p_sph,
)
from adiabatic_raytracer.models.metric import christoffel, metric_inverse
from adiabatic_raytracer.ops.dispersion import omega_function
from adiabatic_raytracer.ops.geometry import cart_to_sph


def _sdot(g, a, b):
    _, g_rr, g_thth, g_pp = g
    return g_rr * a[0] * b[0] + g_thth * a[1] * b[1] + g_pp * a[2] * b[2]


def k_gamma(x_sph, ksphere, t, erg_inf, sc: Scene, mass_ns, *, bndry_lyr=-1.0,
            flat=False):
    """Photon momentum magnitude on the anisotropic shell
    (k_gamma, RayTracer.jl:1311-1325).  Note the reference's
    erg_loc = erg_inf / g_rr (not /sqrt(g_rr)) — reproduced verbatim."""
    g = metric_inverse(x_sph, mass_ns)
    _, g_rr, g_thth, g_pp = g
    b_low = b_sph_lower(x_sph, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                        0.0 if flat else mass_ns)
    wp = omega_p_sph(x_sph, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                     mass_a=sc.mass_a, bndry_lyr=bndry_lyr, zero_in=True)
    kmag = jnp.sqrt(_sdot(g, ksphere, ksphere))
    bmag = jnp.sqrt(_sdot(g, b_low, b_low))
    ct = _sdot(g, b_low, ksphere) / (kmag * bmag)
    if sc.isotropic:
        ct = ct * 0.0
    erg_loc = erg_inf / g_rr
    return erg_loc * jnp.sqrt(erg_loc**2 - wp**2) / jnp.sqrt(erg_loc**2 - wp**2 * ct**2)


def dwp_ds(x_cart, ksphere, t, w_erg, sc: Scene, mass_ns, *, flat=False,
           bndry_lyr=-1.0):
    """Gradient bundle along the ray (dwp_ds, RayTracer.jl:1327-1403).

    Returns (|w'|, |k'|, |E'|, cos_w, |v_g|, dk_vg, dE_vg, k_vg).
    x_cart Cartesian, ksphere covariant spherical, w_erg the local photon
    energy omega_erg."""
    x_sph = cart_to_sph(x_cart)
    rr = x_sph[0]
    wp = omega_p_sph(x_sph, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                     mass_a=sc.mass_a, bndry_lyr=bndry_lyr, zero_in=True)
    erg_inf = jnp.sqrt(1.0 - 2.0 * G_NEW * mass_ns / rr / C_KM**2) * w_erg
    g = metric_inverse(x_sph, mass_ns)
    _, g_rr, g_thth, g_pp = g
    b_low = b_sph_lower(x_sph, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                        0.0 if flat else mass_ns)
    kmag = jnp.sqrt(_sdot(g, ksphere, ksphere))
    khat = ksphere / kmag
    kb_norm = _sdot(g, b_low, khat)
    v_ortho = -(b_low - kb_norm * khat)
    v_ortho = v_ortho / jnp.sqrt(_sdot(g, v_ortho, v_ortho))
    bmag = jnp.sqrt(_sdot(g, b_low, b_low))
    ct = _sdot(g, b_low, ksphere) / (kmag * bmag)
    st = jnp.sin(jnp.arccos(ct))
    if sc.isotropic:
        ct = ct * 0.0
        st = st / st
    xi = st**2 / (1.0 - ct**2 * wp**2 / w_erg**2)
    aniso_mix = wp**2 / w_erg**2 * xi / (st / ct)

    def wp_of(x):
        return omega_p_sph(x, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                           mass_a=sc.mass_a, bndry_lyr=bndry_lyr, zero_in=True)

    grad_wp = jax.jacfwd(wp_of)(x_sph)
    grad_wp_norm = grad_wp / jnp.sqrt(_sdot(g, grad_wp, grad_wp))
    w_prime = _sdot(g, khat, grad_wp) + aniso_mix * _sdot(g, v_ortho, grad_wp)

    grad_kg = jax.jacfwd(
        lambda x: k_gamma(x, ksphere, t, erg_inf, sc, mass_ns,
                          bndry_lyr=bndry_lyr, flat=flat)
    )(x_sph)
    grad_kg_norm = grad_kg / jnp.sqrt(_sdot(g, grad_kg, grad_kg))
    k_prime = _sdot(g, khat, grad_kg) + aniso_mix * _sdot(g, v_ortho, grad_kg)

    grad_om = jax.jacfwd(
        lambda x: omega_function(x, ksphere, t, sc, mass_ns, iso=sc.isotropic)
    )(x_sph)
    grad_om_norm = grad_om / jnp.sqrt(_sdot(g, grad_om, grad_om))
    cos_w = jnp.abs(_sdot(g, khat, grad_om_norm))

    v_group = jax.jacfwd(
        lambda k: omega_function(x_sph, k, t, sc, mass_ns, iso=sc.isotropic)
    )(ksphere)
    v_group = v_group / jnp.array([g_rr, g_thth, g_pp])
    vg_norm = jnp.sqrt(_sdot(g, v_group, v_group))
    vg_hat = v_group / vg_norm

    slength = jnp.sqrt(
        1.0 + (wp**2 / w_erg**2 * st**2 / (1.0 - wp**2 / w_erg**2 * ct**2) * (ct / st)) ** 2
    )
    if sc.isotropic:
        slength = slength / slength
    new_guess = (slength / vg_norm) * _sdot(g, khat, grad_om)

    dk_vg = jnp.abs(_sdot(g, vg_hat, grad_kg_norm))
    k_vg = jnp.abs(_sdot(g, vg_hat, khat))
    de_vg = jnp.abs(_sdot(g, vg_hat, grad_om_norm))

    return (jnp.abs(w_prime), jnp.abs(k_prime), jnp.abs(new_guess), cos_w,
            vg_norm, dk_vg, de_vg, k_vg)


def conversion_prob(x_sph, ksphere, t, w_erg, sc: Scene, mass_ns, *, flat=False,
                    bndry_lyr=-1.0, one_d=False, wp_mass_a_default=False):
    """Landau–Zener conversion probability P_nonAD
    (conversion_prob, RayTracer.jl:1405-1473).

    Returns (Prob, |vhat.gradE|, cos_w, |gradE|, cos_w_2, |gradE_2|).
    wp_mass_a_default: reproduce get_Prob_nonAD's omission of Mass_a when
    evaluating the *scalar* omega_p (MainRunner.jl:99) — its boundary-layer
    rmax then uses the default 1e-5, while the omega_p *gradient* inside
    conversion_prob uses the true mass (RayTracer.jl:1427)."""
    g = metric_inverse(x_sph, mass_ns)
    _, g_rr, g_thth, g_pp = g
    b_mass = 0.0 if flat else mass_ns
    b_low = b_sph_lower(x_sph, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns, b_mass)
    wp_mass_a = 1e-5 if wp_mass_a_default else sc.mass_a
    wp = omega_p_sph(x_sph, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                     mass_a=wp_mass_a, bndry_lyr=bndry_lyr, zero_in=True)
    kmag = jnp.sqrt(_sdot(g, ksphere, ksphere))
    khat = ksphere / kmag
    bmag = jnp.sqrt(_sdot(g, b_low, b_low)) * GAUSS_TO_EV2  # eV^2
    ct = _sdot(g, b_low, ksphere) * GAUSS_TO_EV2 / (kmag * bmag)
    st = jnp.sin(jnp.arccos(ct))
    if sc.isotropic:
        ct = ct * 0.0
        st = st / st
    vloc = jnp.sqrt(w_erg**2 - sc.mass_a**2) / w_erg
    rr = x_sph[0]
    erg_inf = jnp.sqrt(1.0 - 2.0 * G_NEW * mass_ns / rr / C_KM**2) * w_erg

    if sc.isotropic:
        dmu_e = jax.jacfwd(
            lambda x: omega_function(x, ksphere, t, sc, mass_ns, iso=True,
                                     kmag=kmag)
        )(x_sph)
        dmu_e2 = dmu_e
    else:
        (g_rrr, g_rtt, g_rpp, g_trt, g_tpp, g_prp, g_ptp, g_ttr, g_ppr,
         g_ppt) = christoffel(x_sph, mass_ns)

        dmu_wp = jax.jacfwd(
            lambda x: omega_p_sph(x, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                                  mass_a=sc.mass_a, bndry_lyr=bndry_lyr,
                                  zero_in=True)
        )(x_sph)
        dmu_babs = jax.jacfwd(
            lambda x: b_sph_component(x, t, sc.theta_m, sc.omega_pul, sc.b0,
                                      sc.r_ns, b_mass, 0)
        )(x_sph)
        grads_bi = [
            jax.jacfwd(
                lambda x, c=c: b_sph_component(x, t, sc.theta_m, sc.omega_pul,
                                               sc.b0, sc.r_ns, b_mass, c)
            )(x_sph)
            for c in (1, 2, 3)
        ]
        k1, k2, k3 = ksphere[0], ksphere[1], ksphere[2]
        term1 = k1 * grads_bi[0] + k2 * grads_bi[1] + k3 * grads_bi[2]
        b1, b2, b3 = b_low[0], b_low[1], b_low[2]
        ev = GAUSS_TO_EV2
        term2_r = (k1 * (g_rr * b1 * ev) * g_rrr + k2 * g_trt * (b2 * g_thth * ev)
                   + k3 * g_prp * (b3 * g_pp * ev))
        term2_t = (k1 * (g_thth * b2 * ev) * g_rtt + k3 * g_ptp * (b3 * g_pp * ev)
                   + k2 * (g_rr * b1 * ev) * g_ttr)
        term2_p = (k1 * (g_pp * b3 * ev) * g_rpp + k2 * g_tpp * (b3 * g_pp * ev)
                   + k3 * g_ppr * (b1 * g_rr * ev) + k3 * g_ppt * (b2 * g_thth * ev))
        dmu_ct = (term1 + jnp.array([term2_r, term2_t, term2_p])) / (kmag * bmag) \
            - ct * dmu_babs / bmag

        v_group = jax.jacfwd(
            lambda k: omega_function(x_sph, k, t, sc, mass_ns, iso=sc.isotropic)
        )(ksphere)
        vg1, vg2, vg3 = v_group[0], v_group[1], v_group[2]
        t2r = g_rrr * k1 * (g_rr * vg1) + g_trt * k2 * (g_thth * vg2) + g_prp * k3 * (g_pp * vg3)
        t2t = g_rtt * k1 * (g_thth * vg2) + g_ptp * k3 * (g_pp * vg3) + g_ttr * k2 * (g_rr * vg1)
        t2p = (g_rpp * k1 * (g_pp * vg3) + g_tpp * k2 * (g_pp * vg3)
               + g_ppr * k3 * (g_rr * vg1) + g_ppt * k3 * (g_thth * vg2))
        term2 = jnp.array([t2r, t2t, t2p])

        pre_f = wp / jnp.abs(w_erg**5 + ct**2 * w_erg * (wp**4 - 2.0 * wp**2 * w_erg**2))
        dmu_e = pre_f * (w_erg**4 * st**2 * dmu_wp
                         - w_erg**2 * ct * wp * (w_erg**2 - wp**2) * dmu_ct)
        dmu_e2 = dmu_e + term2

    grad_e_norm = dmu_e / jnp.sqrt(_sdot(g, dmu_e, dmu_e))
    grad_e2_norm = dmu_e2 / jnp.sqrt(_sdot(g, dmu_e2, dmu_e2))
    cos_w = jnp.abs(_sdot(g, khat, grad_e_norm))
    cos_w_2 = jnp.abs(_sdot(g, khat, grad_e2_norm))
    vhat_grad_e = _sdot(g, khat, dmu_e)
    grad_emag = _sdot(g, dmu_e, dmu_e)
    grad_emag_2 = _sdot(g, dmu_e2, dmu_e2)

    # The final P_nonAD line (RayTracer.jl:1465-1468).  GROUPING IS
    # LOAD-BEARING on the f32 path: XLA's algebraic simplifier reassociates
    # pure literals together, and written naively ((ax_g * 1e-9 * bmag)**2 /
    # (... C_KM * HBAR)) it folds (1e-9)^2-scale constants into a factor
    # below the f32 denormal floor — the compiled scalar program returned
    # prob == 0 where the eager op-by-op evaluation was correct (measured:
    # jit f32 0.0 vs eager 2.27e-3; batch >= 2 escaped only because fusion
    # decisions differ by shape).  All literal constants are pre-folded into
    # ONE python-f64 factor and the same-scale quantities divide first.
    ax_coupling = sc.ax_g * bmag                      # ~1e-12 * 1e7..1e13
    lit = float(jnp.pi) / 2.0 * 1e-18 / (C_KM * HBAR)  # python f64: ~8e-9
    if one_d:
        prob = lit * ax_coupling * (ax_coupling / (vloc * jnp.abs(vhat_grad_e)))
    else:
        prefactor = w_erg**4 * st**2 / (ct**2 * wp**2 * (wp**2 - 2.0 * w_erg**2) + w_erg**4)
        prob = lit * prefactor * ax_coupling * (
            ax_coupling / (jnp.abs(vhat_grad_e) * vloc))
    return (prob, jnp.abs(vhat_grad_e), cos_w, jnp.sqrt(grad_emag), cos_w_2,
            jnp.sqrt(grad_emag_2))


def get_prob_nonad(pos_cart, k_cart, erg_inf_ini, sc: Scene, *, flat=None):
    """Driver-side conversion probability at a point
    (get_Prob_nonAD, MainRunner.jl:67-124).  Scalar per point; vmap to batch.

    Uses the *full* NS mass for the metric (the reference closes over the
    global Mass_NS) with `flat` only lowering the B components."""
    if flat is None:
        flat = sc.flat
    mass_ns = sc.mass_ns
    x_sph = cart_to_sph(pos_cart)
    rmag = x_sph[0]
    t = 0.0
    # celerity momenta with the flat switch (k_sphere, RayTracer.jl:983-1008)
    from adiabatic_raytracer.ops.dispersion import k_sphere as _ks

    ksphere = _ks(pos_cart, k_cart, mass_ns, flat=flat)
    erg_ax = erg_inf_ini / jnp.sqrt(1.0 - 2.0 * G_NEW * mass_ns / rmag / C_KM**2)
    prob, *_ = conversion_prob(
        x_sph, ksphere, t, erg_ax, sc, mass_ns, flat=flat,
        bndry_lyr=sc.bndry_lyr, one_d=False, wp_mass_a_default=True,
    )
    return prob


def g_det(x_sph, t, sc: Scene, mass_ns, *, flat=False, bndry_lyr=-1.0):
    """sqrt(-g) area-jacobian ratio for the sampling measure
    (g_det, RayTracer.jl:734-754)."""
    if flat:
        return jnp.ones(x_sph.shape[:-1], x_sph.dtype)
    g_tt, g_rr, g_thth, g_pp = metric_inverse(x_sph, mass_ns, r_ns=sc.r_ns)
    r = x_sph[..., 0]

    def wp_of(x):
        return omega_p_sph(x, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                           mass_a=sc.mass_a, bndry_lyr=bndry_lyr, zero_in=False)

    dwp = jax.jacfwd(wp_of)(x_sph)
    dr_th = dwp[0] ** -1 * dwp[1]
    dr_p = dwp[0] ** -1 * dwp[2]
    a = g_rr
    s2 = jnp.sin(x_sph[..., 1]) ** 2
    sqrt_det = r * jnp.sqrt(s2 * (a * r**2 + dr_th**2) + dr_p**2)
    sqrt_det_nogr = r * jnp.sqrt(s2 * (r**2 + dr_th**2) + dr_p**2)
    return sqrt_det / sqrt_det_nogr


def v_infinity(theta, phi, r, vel_loc, *, v_comp=0, mass_ns=1.0):
    """Asymptotic velocity component from local velocity
    (v_infinity, RayTracer.jl:771-790).  v_comp in {0,1,2} (x,y,z)."""
    vmag = jnp.sqrt(jnp.sum(vel_loc**2))
    gmr = G_NEW * mass_ns / r / C_KM**2
    v_inf = jnp.sqrt(vmag**2 - 2.0 * gmr)
    rhat = jnp.array([jnp.sin(theta) * jnp.cos(phi), jnp.sin(theta) * jnp.sin(phi),
                      jnp.cos(theta)])
    rv = jnp.sum(vel_loc * rhat)
    denom = v_inf**2 + gmr - v_inf * rv
    return (v_inf**2 * vel_loc[v_comp] + v_inf * gmr * rhat[v_comp]
            - v_inf * vel_loc[v_comp] * rv) / denom


def jacobian_fv(x_cart, vel_loc, mass_ns=1.0):
    """|det d v_inf / d v_loc|^-1 — Liouville phase-space weight
    (jacobian_fv, RayTracer.jl:756-769)."""
    rmag = jnp.sqrt(jnp.sum(x_cart**2))
    phi = jnp.arctan2(x_cart[1], x_cart[0])
    theta = jnp.arccos(x_cart[2] / rmag)

    def vinf(v):
        return jnp.stack([
            v_infinity(theta, phi, rmag, v, v_comp=c, mass_ns=mass_ns)
            for c in (0, 1, 2)
        ])

    jj = jnp.linalg.det(jax.jacfwd(vinf)(vel_loc))
    return jnp.abs(jj) ** -1


def solve_vel_cs(theta, phi, r, ns_vel, *, guess=None, mass_ns=1.0, iters=50):
    """Invert the v_infinity map with a damped Newton iteration
    (solve_vel_CS, RayTracer.jl:706-732; NLsolve in the reference).
    Dead in the production path; provided for component parity."""
    ff = jnp.sum(ns_vel**2)
    gmr = G_NEW * mass_ns / r / C_KM**2
    rhat = jnp.array([jnp.sin(theta) * jnp.cos(phi), jnp.sin(theta) * jnp.sin(phi),
                      jnp.cos(theta)])

    def resid(x):
        rv = jnp.sum(x * rhat)
        denom = ff + gmr - jnp.sqrt(ff) * rv
        return (ff * x + jnp.sqrt(ff) * gmr * rhat - jnp.sqrt(ff) * x * rv) / (
            ns_vel * denom) - 1.0

    x = jnp.asarray(guess) if guess is not None else jnp.full(3, 0.1, jnp.result_type(ns_vel))

    def body(_, x):
        f = resid(x)
        j = jax.jacfwd(resid)(x)
        dx = jnp.linalg.solve(j, f)
        return x - dx

    x = jax.lax.fori_loop(0, iters, body, x)
    accur = jnp.sqrt(jnp.sum(resid(x) ** 2))
    return x, accur
