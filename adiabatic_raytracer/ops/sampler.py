"""Conversion-surface Monte-Carlo sampler.

Batched equivalent of `find_samples_new` (RayTracer.jl:1480-1653): sample a
random disk point and direction, march a straight line through the scene, and
collect the roots of the thick-surface level-crossing condition along it.

Instead of the reference's Euler ODE with a ContinuousCallback, the line is
evaluated on a dense static grid (the line is analytic, so "dense output" is
exact), sign changes are bisected, and a crossing index is drawn à la
importance sampling (weight = number of crossings, selection 1..n_max).

Batched via vmap over per-event PRNG keys.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from adiabatic_raytracer.config import Scene
from adiabatic_raytracer.constants import C_KM, G_NEW
from adiabatic_raytracer.models.magnetosphere import omega_p_cart
from adiabatic_raytracer.models.metric import metric_inverse, schwarzschild_radius
from adiabatic_raytracer.ops.dispersion import k_par

MAX_LINE_CROSSINGS = 16


class SampleResult(NamedTuple):
    success: Any    # [B] bool — a crossing was drawn
    xpos: Any       # [B, 3] selected crossing position (Cartesian)
    r_disk: Any     # [B] disk radius drawn (R_sample)
    weight: Any     # [B] number of crossings found along the line
    v_loc: Any      # [B, 3] local velocity (direction * local magnitude) [c]
    v_ifty: Any     # [B, 3] asymptotic velocity [c]
    erg_inf: Any    # [B] energy at infinity of the sampled axion [eV]


def _line_condition(p_cart, vvec_loc, erg_inf, sc: Scene, mass_ns, thick: bool):
    """Crossing condition along the sampling line (RayTracer.jl:1547-1583).

    For the thick surface: the momentum used for the axion-shell
    normalization points along the *velocity* direction vvec_loc, not the
    line direction."""
    if not thick:
        wp = omega_p_cart(p_cart, 0.0, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                          mass_a=sc.mass_a, bndry_lyr=sc.bndry_lyr)
        return jnp.log(wp) - jnp.log(sc.mass_a)

    rr = jnp.sqrt(jnp.sum(p_cart**2))
    sin_theta = jnp.sqrt(jnp.clip(1.0 - (p_cart[2] / rr) ** 2, 1e-30, None))
    x_sph = jnp.stack([rr, jnp.arccos(p_cart[2] / rr), jnp.arctan2(p_cart[1], p_cart[0])])
    r_s0 = schwarzschild_radius(mass_ns)
    aa = jnp.where(rr < sc.r_ns, 1.0, 1.0 - r_s0 / rr)  # RayTracer.jl:1557-1560

    dr_dt = jnp.sum(p_cart * vvec_loc) / rr
    v_th = (p_cart[2] * dr_dt - rr * vvec_loc[2]) / (rr * sin_theta)
    v_ph = (-p_cart[1] * vvec_loc[0] + p_cart[0] * vvec_loc[1]) / (rr * sin_theta)
    w = jnp.stack([
        dr_dt / jnp.sqrt(aa),
        v_th * rr,
        v_ph * (rr * sin_theta),
    ]) / aa

    g_tt, g_rr, g_thth, g_pp = metric_inverse(x_sph, mass_ns)
    wsq = g_rr * w[0] ** 2 + g_thth * w[1] ** 2 + g_pp * w[2] ** 2
    nrm_sq = (-(erg_inf**2) * g_tt - sc.mass_a**2) / wsq
    w = w * jnp.sqrt(nrm_sq)

    wp = omega_p_cart(p_cart, 0.0, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                      mass_a=sc.mass_a, bndry_lyr=sc.bndry_lyr)
    if sc.isotropic:
        kp = 0.0
    else:
        kp = k_par(x_sph, w, 0.0, sc, mass_ns)
    ksqr = g_tt * erg_inf**2 + g_rr * w[0] ** 2 + g_thth * w[1] ** 2 + g_pp * w[2] ** 2
    e2 = erg_inf**2 / g_rr
    return 0.5 * (ksqr + wp**2 * (e2 - kp**2) / e2) / erg_inf**2


def _accept_crossing(p_cart, erg_inf, sc: Scene, mass_ns):
    """Recording filter (affect!, RayTracer.jl:1585-1597): outside the star
    and locally propagating (erg_local > omega_p)."""
    rr = jnp.sqrt(jnp.sum(p_cart**2))
    x_sph = jnp.stack([rr, jnp.arccos(p_cart[2] / rr), jnp.arctan2(p_cart[1], p_cart[0])])
    _, g_rr, _, _ = metric_inverse(x_sph, mass_ns)
    erg_l = erg_inf / jnp.sqrt(g_rr)
    wp = omega_p_cart(p_cart, 0.0, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                      mass_a=sc.mass_a, bndry_lyr=sc.bndry_lyr)
    return (rr > sc.r_ns) & (erg_l > wp)


def _cast_args(sc: Scene, mass_ns, maxR, compute_dtype: str):
    if compute_dtype == "f32":
        from adiabatic_raytracer.ops.propagate import _cast_tree

        return (_cast_tree(sc, jnp.float32), jnp.float32(mass_ns),
                jnp.float32(maxR), jnp.float32)
    return sc, mass_ns, maxR, jnp.result_type(float)


class _Geometry(NamedTuple):
    x0: Any         # line start (Cartesian)
    vvec: Any       # line direction
    vvec_loc: Any   # local velocity direction
    erg_inf: Any
    r_rnd: Any      # disk radius drawn
    v_ifty: Any     # asymptotic velocity [km/s]
    key_pick: Any   # subkey for the crossing-index draw


def _draw_one(key, maxR, sc: Scene, vmean, flat_sampling: bool, dtype) -> _Geometry:
    """Draw one event's sampling geometry (RayTracer.jl:1483-1542):
    isotropic disk orientation, flat (or legacy 1/r) disk-radius measure,
    isotropic local velocity direction, v_infinity ~ (220 + 1e-5 u)/sqrt(3)
    per component, line start offset -1.1 maxR."""
    ks = jax.random.split(key, 8)
    u = [jax.random.uniform(ks[i], dtype=dtype) for i in range(6)]
    theta_i = jnp.arccos(1.0 - 2.0 * u[0])
    phi_i = 2.0 * jnp.pi * u[1]
    theta_loc = jnp.arccos(1.0 - 2.0 * u[2])
    phi_loc = 2.0 * jnp.pi * u[3]
    phi_rnd = 2.0 * jnp.pi * u[4]
    if flat_sampling:
        r_rnd = jnp.sqrt(u[5]) * maxR   # flat disk measure (find_samples_new)
    else:
        r_rnd = u[5] * maxR             # legacy 1/r measure (find_samples, RayTracer.jl:1674)

    vvec = jnp.stack([jnp.sin(theta_i) * jnp.cos(phi_i),
                      jnp.sin(theta_i) * jnp.sin(phi_i), jnp.cos(theta_i)])
    vvec_loc = jnp.stack([jnp.sin(theta_loc) * jnp.cos(phi_loc),
                          jnp.sin(theta_loc) * jnp.sin(phi_loc), jnp.cos(theta_loc)])

    x1 = r_rnd * jnp.cos(phi_rnd)
    x2 = r_rnd * jnp.sin(phi_rnd)
    # inverse Euler rotation of (x1, x2, 0) into the disk plane (RayTracer.jl:1529)
    x0 = jnp.stack([
        x1 * jnp.cos(-phi_i) * jnp.cos(-theta_i) + x2 * jnp.sin(-phi_i),
        x2 * jnp.cos(-phi_i) - x1 * jnp.sin(-phi_i) * jnp.cos(-theta_i),
        x1 * jnp.sin(-theta_i),
    ])
    x0 = x0 + vvec * (-maxR * 1.1)

    v_ifty = (vmean + jax.random.uniform(ks[6], (3,), dtype=dtype) * 1.0e-5) / jnp.sqrt(3.0)
    v_ifty_mag = jnp.sqrt(jnp.sum(v_ifty**2))
    gamma_a = 1.0 / jnp.sqrt(1.0 - (v_ifty_mag / C_KM) ** 2)
    erg_inf = sc.mass_a * jnp.sqrt(1.0 + (v_ifty_mag / C_KM * gamma_a) ** 2)
    return _Geometry(x0, vvec, vvec_loc, erg_inf, r_rnd, v_ifty, ks[7])


def sample_one(key, maxR, sc: Scene, mass_ns, *, n_grid: int, n_max: int = 6,
               thick: bool = True, bisect_iters: int = 50, vmean: float = 220.0,
               flat_sampling: bool = True, compute_dtype: str = "state"):
    """Draw one conversion-surface sample (one event).  vmap over keys to batch.
    See _draw_one for the sampling measure (RayTracer.jl:1483-1542)."""
    sc, mass_ns, maxR, dtype = _cast_args(sc, mass_ns, maxR, compute_dtype)
    geo = _draw_one(key, maxR, sc, vmean, flat_sampling, dtype)

    # --- dense scan of the condition along the line ---
    s_grid = jnp.linspace(0.0, 2.2 * maxR, n_grid).astype(dtype)
    pts = geo.x0[None, :] + s_grid[:, None] * geo.vvec[None, :]
    cond = lambda p: _line_condition(p, geo.vvec_loc, geo.erg_inf, sc, mass_ns, thick)
    g = jax.vmap(cond)(pts)
    return _select_one(geo, g, s_grid, sc, mass_ns, thick=thick,
                       n_max=n_max, bisect_iters=bisect_iters)


def _select_one(geo: _Geometry, g, s_grid, sc: Scene, mass_ns, *,
                thick: bool, n_max: int, bisect_iters: int) -> SampleResult:
    """Root-refine the scanned condition values and draw a crossing
    (find_samples_new affect!/selection, RayTracer.jl:1585-1647)."""
    dtype = s_grid.dtype
    x0, vvec, vvec_loc, erg_inf = geo.x0, geo.vvec, geo.vvec_loc, geo.erg_inf
    n_grid = s_grid.shape[0]
    cond = lambda p: _line_condition(p, vvec_loc, erg_inf, sc, mass_ns, thick)

    sign = jnp.sign(g)
    flips = sign[1:] * sign[:-1] < 0  # [n_grid-1]
    MAXC = MAX_LINE_CROSSINGS

    # first MAXC flip intervals, in line order (masked-iota + top_k: a
    # static-shape, bit-identical form of jnp.nonzero(size=...))
    idx = jnp.arange(n_grid - 1, dtype=jnp.int32)
    slot_idx = -lax.top_k(-jnp.where(flips, idx, n_grid - 2), MAXC)[0]
    has_root = jnp.arange(MAXC) < jnp.sum(flips)

    s_lo = s_grid[slot_idx]
    s_hi = s_grid[slot_idx + 1]
    g_lo = g[slot_idx]

    def bisect(_, carry):
        s_lo, s_hi, g_lo = carry
        s_mid = 0.5 * (s_lo + s_hi)
        g_mid = jax.vmap(cond)(x0[None, :] + s_mid[:, None] * vvec[None, :])
        left = jnp.sign(g_mid) == jnp.sign(g_lo)
        return (jnp.where(left, s_mid, s_lo), jnp.where(left, s_hi, s_mid),
                jnp.where(left, g_mid, g_lo))

    s_lo, s_hi, _ = lax.fori_loop(0, bisect_iters, bisect, (s_lo, s_hi, g_lo))
    s_star = 0.5 * (s_lo + s_hi)
    p_star = x0[None, :] + s_star[:, None] * vvec[None, :]  # [MAXC, 3]

    ok = has_root & jax.vmap(lambda p: _accept_crossing(p, erg_inf, sc, mass_ns))(p_star)
    n_accepted = jnp.sum(ok.astype(jnp.int32))

    # draw crossing index 1..n_max; succeed iff n_accepted >= draw
    rand_inx = jax.random.randint(geo.key_pick, (), 1, n_max + 1)
    success = n_accepted >= rand_inx
    # position of the rand_inx-th accepted crossing (in line order)
    acc_order = jnp.cumsum(ok.astype(jnp.int32))
    pick = jnp.argmax((acc_order == rand_inx) & ok)
    xpos = p_star[pick]

    v_ifty_mag = jnp.sqrt(jnp.sum(geo.v_ifty**2))
    rmag = jnp.sqrt(jnp.sum(xpos**2))
    vmag_loc = jnp.sqrt(v_ifty_mag**2 + 2.0 * G_NEW * mass_ns / rmag) / C_KM
    v_loc = vvec_loc * vmag_loc

    return SampleResult(
        success=success,
        xpos=xpos,
        r_disk=geo.r_rnd,
        weight=n_accepted.astype(dtype),
        v_loc=v_loc,
        v_ifty=geo.v_ifty / C_KM,
        erg_inf=erg_inf,
    )


def sample_batch(key, batch: int, maxR, sc: Scene, mass_ns, *, n_grid: int,
                 n_max: int = 6, thick: bool = True, flat_sampling: bool = True,
                 compute_dtype: str = "state"):
    """flat_sampling=False selects the legacy 1/r disk-radius measure of
    `find_samples` (RayTracer.jl:1656-1799) instead of the production flat
    measure of `find_samples_new`.  The dense line scan is a pure
    elementwise map over [batch, n_grid], which XLA fuses into one loop."""
    keys = jax.random.split(key, batch)
    return jax.vmap(
        lambda k: sample_one(k, maxR, sc, mass_ns, n_grid=n_grid, n_max=n_max,
                             thick=thick, flat_sampling=flat_sampling,
                             compute_dtype=compute_dtype)
    )(keys)


def default_n_grid(maxR: float, march_dt: float = 0.5, scan_per_step: int = 20) -> int:
    """Grid resolution matching the reference's Euler dt=0.5 with
    interp_points=20 (RayTracer.jl:1599-1613)."""
    import math

    return int(math.ceil(2.2 * float(maxR) / march_dt)) * scan_per_step + 1
