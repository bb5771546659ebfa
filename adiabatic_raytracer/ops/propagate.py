"""Reference-facing ray propagation: physics RHS + crossing condition + transforms.

The batched equivalent of `propagate` (RayTracer.jl:171-452): normalizes
the launch momentum onto the dispersion shell, transforms to spherical
celerity state, runs the pooled adaptive integrator with the thick-surface
level-crossing event and the stellar-surface kill, and transforms results
back to Cartesian.

State layout per ray: u = [r, theta, phi, w_r, w_th, w_ph, e7] with the
covariant celerity w normalized by erg_inf and e7 = erg_inf * Delta_omega
(negative; the reference's u[:,7], RayTracer.jl:216).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from adiabatic_raytracer.config import NumericsConfig, Scene
from adiabatic_raytracer.constants import C_KM, G_NEW
from adiabatic_raytracer.models.magnetosphere import omega_p_sph
from adiabatic_raytracer.models.metric import metric_inverse, schwarzschild_radius
from adiabatic_raytracer.ops.dispersion import (
    hamiltonian_axion,
    hamiltonian_photon,
    k_norm_cart,
    k_par,
)
from adiabatic_raytracer.ops.geometry import (
    cart_to_sph,
    celerity_from_cart,
    celerity_to_cart_vel,
    sph_to_cart,
)
from adiabatic_raytracer.ops.integrator import PoolResult, integrate_pool


class PropagateResult(NamedTuple):
    traj: Any        # [B, NS, 3] Cartesian positions on the save grid
    mom: Any         # [B, NS, 3] Cartesian proper velocities (x erg scale)
    erg: Any         # [B, NS]  e7 (= erg * Delta_omega) along the trajectory
    fail: Any        # [B] 1.0 if the ray survived, 0.0 if it ended below 1.01 r_NS
    cut_short: Any   # [B] bool: terminated by max_crossings
    xc: Any          # [B, MAXC, 3] crossing positions (Cartesian)
    kc: Any          # [B, MAXC, 3] crossing momenta (proper velocity x erg)
    tc: Any          # [B, MAXC] proper time at crossing
    dwc: Any         # [B, MAXC] Delta_omega at crossing (e7 / erg)
    n_cross: Any     # [B]
    times: Any       # [B, NS] save grid (log-time)
    final_lnt: Any   # [B]
    ns_hit: Any      # [B] bool
    maxed: Any       # [B] bool
    steps: Any       # [B]


def _cast_tree(x, dtype):
    return jax.tree_util.tree_map(lambda v: jnp.asarray(v, dtype), x)


def crossing_condition(u, lnt, erg_dummy, sc: Scene, mass_eff):
    """Thick-surface level-crossing condition (RayTracer.jl:254-297).

    Momenta are renormalized onto the *axion* shell; the root of the
    (Melrose-form) photon Hamiltonian then marks where the photon dispersion
    crosses the axion dispersion.  Normalized by erg_inf^2.
    """
    x = u[0:3]
    w = u[3:6]
    erg_inf = u[6]  # negative: erg * Delta_omega
    t = jnp.exp(lnt)
    g_tt, g_rr, g_thth, g_pp = metric_inverse(x, mass_eff)
    wsq = g_rr * w[0] ** 2 + g_thth * w[1] ** 2 + g_pp * w[2] ** 2
    nrm_sq = (-(erg_inf**2) * g_tt - sc.mass_a**2) / wsq
    w_ax = w * jnp.sqrt(nrm_sq)
    wp = omega_p_sph(x, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                     mass_a=sc.mass_a, bndry_lyr=sc.bndry_lyr, zero_in=True)
    if sc.isotropic:
        kp = 0.0
    else:
        kp = k_par(x, w_ax, t, sc, mass_eff)
    ksqr = g_tt * erg_inf**2 + g_rr * w_ax[0] ** 2 + g_thth * w_ax[1] ** 2 + g_pp * w_ax[2] ** 2
    e2 = erg_inf**2 / g_rr
    return 0.5 * (ksqr + wp**2 * (e2 - kp**2) / e2) / erg_inf**2


def make_rhs(sc: Scene, mass_eff, time0, species: str, compute_dtype: str = "state"):
    """Hamilton's equations in log-time (func!/func_axion!, RayTracer.jl:71-123).

    species: 'photon' | 'axion' | 'mixed' — static hint letting XLA drop the
    unused Hamiltonian in pure batches.  Quirk preserved from the reference:
    the photon's spatial gradients exclude the boundary-layer plasma term
    while its time derivative includes it (RayTracer.jl:84-88).

    compute_dtype="f32": evaluate the physics in float32 while the caller's
    integration state stays f64 (see NumericsConfig.compute_dtype).
    """
    if compute_dtype == "f32":
        sc = _cast_tree(sc, jnp.float32)
        mass_eff = jnp.float32(mass_eff)
        time0 = jnp.float32(time0)

    def rhs(u, lnt, ray_args):
        out_dtype = u.dtype
        erg = ray_args["erg"]
        is_photon = ray_args["is_photon"]
        if compute_dtype == "f32":
            u = u.astype(jnp.float32)
            lnt = lnt.astype(jnp.float32)
            erg = erg.astype(jnp.float32)
        from adiabatic_raytracer.utils.precise import exp_p

        t = exp_p(lnt)
        time = time0 + t
        x = u[0:3]
        e7 = u[6]
        k_scaled = u[3:6] * erg
        g_rr = metric_inverse(x, mass_eff)[1]

        def h_spatial(z):
            xx, kk = z[0:3], z[3:6]
            if species == "photon":
                return hamiltonian_photon(xx, kk, time, -e7, sc, mass_eff, bndry_lyr=-1.0)
            if species == "axion":
                return hamiltonian_axion(xx, kk, erg, mass_eff)
            hp = hamiltonian_photon(xx, kk, time, -e7, sc, mass_eff, bndry_lyr=-1.0)
            ha = hamiltonian_axion(xx, kk, erg, mass_eff)
            return jnp.where(is_photon, hp, ha)

        # f32 mode must use forward-mode AD: reverse-mode cotangents flowing
        # through the B-field-scale (1e13) intermediates underflow the f32
        # subnormal/flush threshold and corrupt the gradient; forward tangents
        # stay O(1).  (f64 keeps the cheaper reverse pass.)
        d_op = jax.jacfwd if compute_dtype == "f32" else jax.grad
        gh = d_op(h_spatial)(jnp.concatenate([x, k_scaled]))
        dh_dx, dh_dk = gh[0:3], gh[3:6]

        if species == "axion":
            du_x = dh_dk * C_KM * t * g_rr / erg
            du_w = -dh_dx * C_KM * t * g_rr / erg / erg
            return jnp.concatenate([du_x, du_w, jnp.zeros_like(u[6:7])]).astype(out_dtype)

        # photon pieces
        dh_dt = d_op(
            lambda tt: hamiltonian_photon(x, k_scaled, tt, -e7, sc, mass_eff,
                                          bndry_lyr=sc.bndry_lyr)
        )(time)
        du_x_ph = dh_dk * C_KM * t * g_rr / (-e7)
        du_w_ph = -dh_dx * C_KM * t * g_rr / (-e7) / erg
        du_e7_ph = dh_dt * t * g_rr / (-e7)
        frozen = u[0] <= sc.r_ns * 1.01  # RayTracer.jl:86
        du_ph = jnp.where(
            frozen, 0.0, jnp.concatenate([du_x_ph, du_w_ph, du_e7_ph[None]])
        )
        if species == "photon":
            return du_ph.astype(out_dtype)

        du_x_ax = dh_dk * C_KM * t * g_rr / erg
        du_w_ax = -dh_dx * C_KM * t * g_rr / erg / erg
        du_ax = jnp.concatenate([du_x_ax, du_w_ax, jnp.zeros_like(u[6:7])])
        return jnp.where(is_photon, du_ph, du_ax).astype(out_dtype)

    return rhs


def lapse_interior(r, mass_ns, r_ns):
    """1 - r_s(r)/r with the enclosed-mass (r/r_NS)^3 interior scaling used in
    the reference's post-solve transform (RayTracer.jl:398-406)."""
    m = jnp.where(r < r_ns, mass_ns * r**3 / r_ns**3, mass_ns)
    return 1.0 - 2.0 * G_NEW * m / C_KM**2 / r


def propagate(
    x0_cart,            # [B, 3]
    k0_cart,            # [B, 3] direction (any scale)
    sc: Scene,
    cfg: NumericsConfig,
    *,
    erg,                # [B] energy at infinity erg_inf_ini
    delta_w,            # [B] Delta_omega at launch (negative, ~-1)
    lnt0,               # [B] per-ray log-time start
    lnt1,               # [B] log-time end
    is_photon,          # [B] bool
    max_crossings,      # [B] int (1 = stop at first recorded crossing)
    species: str = "mixed",
    time0=0.0,
    detect_events: bool = True,
) -> PropagateResult:
    B = x0_cart.shape[0]
    mass_eff = sc.mass_ns_eff

    # On-shell normalization at launch (RayTracer.jl:179-186).  Both branches
    # of the reference normalize onto the *axion* shell here (photons with
    # ax_fix=true), so a single formula covers photon and axion.
    k0n = k_norm_cart(x0_cart, k0_cart, time0, erg, sc, sc.mass_ns,
                      is_photon=True, ax_fix=True)

    x_sph0 = cart_to_sph(x0_cart)
    w0 = celerity_from_cart(x0_cart, k0n, mass_eff) / erg[:, None]
    u0 = jnp.concatenate([x_sph0, w0, (erg * delta_w)[:, None]], axis=1)

    NS = cfg.n_save
    frac = jnp.linspace(0.0, 1.0, NS)
    save_lnt = lnt0[:, None] + (lnt1 - lnt0)[:, None] * frac[None, :]

    rhs = make_rhs(sc, mass_eff, time0, species, compute_dtype=cfg.compute_dtype)

    if cfg.compute_dtype == "f32":
        sc_c = _cast_tree(sc, jnp.float32)
        mass_c = jnp.float32(mass_eff)

        def cond_fn(u, lnt, ray_args):
            return crossing_condition(u.astype(jnp.float32),
                                      lnt.astype(jnp.float32),
                                      ray_args["erg"], sc_c, mass_c).astype(u.dtype)
    else:

        def cond_fn(u, lnt, ray_args):
            return crossing_condition(u, lnt, ray_args["erg"], sc, mass_eff)

    ray_args = {"erg": erg, "is_photon": is_photon}
    res: PoolResult = integrate_pool(
        rhs, cond_fn, u0, lnt0, lnt1, ray_args, cfg,
        save_lnt=save_lnt,
        kill_at_surface=is_photon,
        r_ns=sc.r_ns,
        x0_cart=x0_cart,
        max_crossings=max_crossings,
        detect_events=detect_events,
    )

    return finalize_propagate(res, erg, sc, mass_eff, save_lnt)


def finalize_propagate(res: PoolResult, erg, sc: Scene, mass_eff, save_lnt) -> PropagateResult:
    """Transform a PoolResult back to Cartesian outputs (RayTracer.jl:393-444)."""
    save_x_sph = res.save_u[..., 0:3]
    save_w = res.save_u[..., 3:6] * erg[:, None, None]
    a_save = lapse_interior(save_x_sph[..., 0], mass_eff, sc.r_ns)
    traj = sph_to_cart(save_x_sph)
    mom = celerity_to_cart_vel(save_x_sph, save_w, mass_eff, a=a_save)
    erg_out = res.save_u[..., 6]

    fail = jnp.where(res.u[:, 0] <= sc.r_ns * 1.01, 0.0, 1.0)

    # crossings: proper velocity at the crossing point (RayTracer.jl:334-342)
    cross_x_sph = res.cross_u[..., 0:3]
    xc = sph_to_cart(cross_x_sph)
    kc = celerity_to_cart_vel(cross_x_sph, res.cross_u[..., 3:6] * erg[:, None, None],
                              mass_eff)
    tc = jnp.exp(res.cross_lnt)
    dwc = res.cross_u[..., 6] / erg[:, None]

    return PropagateResult(
        traj=traj, mom=mom, erg=erg_out, fail=fail, cut_short=res.cut_short,
        xc=xc, kc=kc, tc=tc, dwc=dwc, n_cross=res.n_cross, times=save_lnt,
        final_lnt=res.lnt, ns_hit=res.ns_hit, maxed=res.maxed, steps=res.steps,
    )


def flops_per_step(sc: Scene, cfg: NumericsConfig, species: str = "photon"):
    """Operation count of one attempted DP5 step of the pool integrator, per
    ray, from XLA's cost analysis of its building blocks (make_rhs,
    crossing_condition and the Hermite interpolant, lowered for the CPU in
    the state dtype).

    Per attempted step (ops/integrator.integrate_pool): 6 RHS evaluations
    (stages 2-6 and the FSAL end point), interp_points - 1 interior
    Hermite + condition evaluations of the crossing scan, and the end-point
    condition.  Event refinement (bisection) runs only on steps that bracket
    a crossing and is excluded.  Returns operations per ray-step."""
    from adiabatic_raytracer.ops.integrator import _hermite

    n = 128
    mass_eff = sc.mass_ns_eff
    rhs = make_rhs(sc, mass_eff, 0.0, species, cfg.compute_dtype)

    def cost(f, *args):
        c = jax.jit(f, backend="cpu").lower(*args).compile().cost_analysis()
        if isinstance(c, (list, tuple)):
            c = c[0]
        return float(c.get("flops", 0.0)) / n

    u = jnp.tile(jnp.asarray([15.0, 1.0, 0.5, 0.3, 0.2, 0.1, -1e-5]), (n, 1))
    lnt = jnp.full(n, -5.0)
    args = {"erg": jnp.full(n, 1e-5), "is_photon": jnp.ones(n, bool)}
    f_rhs = cost(jax.vmap(lambda uu, ll, e, p: rhs(
        uu, ll, {"erg": e, "is_photon": p})), u, lnt, args["erg"],
        args["is_photon"])
    f_cond = cost(jax.vmap(lambda uu, ll: crossing_condition(
        uu, ll, None, sc, mass_eff)), u, lnt)
    f_herm = cost(lambda a, b: _hermite(a, b, a, b, 0.1, 0.5), u, u)
    k = max(int(cfg.interp_points), 1)
    return 6.0 * f_rhs + (k - 1) * (f_cond + f_herm) + f_cond
