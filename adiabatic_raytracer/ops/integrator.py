"""Batched adaptive Runge–Kutta integrator with event detection.

Batched replacement for the reference's per-ray OrdinaryDiffEq solve
(`propagate`, RayTracer.jl:171-452: Vern6 + ContinuousCallback rootfinding).

Design: a fixed-shape *pool* of rays advances in lockstep inside one
`lax.while_loop`; each ray carries its own adaptive step size, termination
mask and event buffers.  Level crossings are detected by a sign-change scan
of the event condition on cubic-Hermite dense output over each accepted step
(the analogue of ContinuousCallback's interp_points grid, RayTracer.jl:357-358)
followed by bisection refinement.  The refinement runs under a *batch-level*
`lax.cond` so the common no-crossing step pays only the scan.

The Runge–Kutta pair is Dormand–Prince 5(4) with FSAL; tolerances follow the
reference contract (rtol=1e-7, atol=1e-6, dtmin=1e-13 with force_dtmin,
maxiters=1e5; RayTracer.jl:383-384).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from adiabatic_raytracer.config import NumericsConfig

# ---------------------------------------------------------------------------
# Dormand–Prince 5(4) tableau (exact rationals), FSAL
# ---------------------------------------------------------------------------

_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)
_DP_E = tuple(b5 - b4 for b5, b4 in zip(_DP_B5, _DP_B4))


def _hermite(u0, u1, f0, f1, h, tau):
    """Cubic Hermite dense output on [0, 1]; h is the step in the independent
    variable, tau broadcastable against the state."""
    t2 = tau * tau
    t3 = t2 * tau
    return (
        (2 * t3 - 3 * t2 + 1) * u0
        + (t3 - 2 * t2 + tau) * h * f0
        + (-2 * t3 + 3 * t2) * u1
        + (t3 - t2) * h * f1
    )


class PoolState(NamedTuple):
    u: Any           # [B, 7] state
    lnt: Any         # [B] current log-time
    dt: Any          # [B] current step size
    f0: Any          # [B, 7] FSAL derivative at (lnt, u)
    g0: Any          # [B] event condition at (lnt, u)
    done: Any        # [B] bool
    ns_hit: Any      # [B] bool: killed at the stellar surface
    cut_short: Any   # [B] bool: terminated by reaching max_crossings
    maxed: Any       # [B] bool: hit the step limit
    n_cross: Any     # [B] int32
    cross_u: Any     # [B, MAXC, 7] state at recorded crossings
    cross_lnt: Any   # [B, MAXC]
    save_u: Any      # [B, NS, 7] dense-output states on the save grid
    steps: Any       # [B] int32 attempted steps
    lnt_ck: Any      # [B] log-time at the last stall check
    stalled: Any     # [B] bool: cut by the stall detector
    errold: Any      # [B] PI controller memory (last accepted enorm)


class PoolResult(NamedTuple):
    u: Any
    lnt: Any
    save_u: Any
    cross_u: Any
    cross_lnt: Any
    n_cross: Any
    cut_short: Any
    ns_hit: Any
    maxed: Any
    steps: Any
    stalled: Any


def _error_norm(err, u0, u1, rtol, atol):
    scale = atol + rtol * jnp.maximum(jnp.abs(u0), jnp.abs(u1))
    return jnp.sqrt(jnp.mean((err / scale) ** 2, axis=-1))


def _initial_dt(u0, f0, span, rtol, atol):
    scale = atol + rtol * jnp.abs(u0)
    d0 = jnp.sqrt(jnp.mean((u0 / scale) ** 2, axis=-1))
    d1 = jnp.sqrt(jnp.mean((f0 / scale) ** 2, axis=-1))
    dt0 = jnp.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    return jnp.minimum(dt0, 0.1 * span)


def integrate_pool(
    rhs: Callable,            # (u[7], lnt, ray_args) -> du[7]
    cond_fn: Callable,        # (u[7], lnt, ray_args) -> scalar event condition
    u0,                       # [B, 7]
    lnt0,                     # [B]
    lnt1,                     # [B]
    ray_args,                 # pytree with leading axis B (per-ray parameters)
    cfg: NumericsConfig,
    *,
    save_lnt,                 # [B, NS] dense-output grid (ascending)
    kill_at_surface,          # [B] bool: terminate when r < 1.01 r_ns (photons)
    r_ns,                     # scalar
    x0_cart,                  # [B, 3] start positions (crossing start-rejection)
    max_crossings,            # [B] int: terminate after this many recorded crossings
    detect_events: bool = True,
    init_state: PoolState = None,   # resume from a prior (possibly compacted) state
    iter_budget: int = None,        # stop after this many loop iterations
    return_state: bool = False,     # also return the raw PoolState for resumption
):
    """Advance a pool of rays from lnt0 to lnt1 with per-ray adaptive steps.

    Semantics mirror RayTracer.jl:171-452: crossings below 1.01 r_NS and
    crossings that have not moved from the start point (factor 1.0001 per
    |component|, RayTracer.jl:303-322) are rejected without recording.
    """
    B = u0.shape[0]
    dtype = u0.dtype
    MAXC = cfg.max_crossings
    NS = save_lnt.shape[1]
    K = cfg.interp_points

    v_rhs = jax.vmap(rhs)
    v_cond = jax.vmap(cond_fn)

    f_init = v_rhs(u0, lnt0, ray_args)
    g_init = v_cond(u0, lnt0, ray_args)
    span = lnt1 - lnt0
    dt_init = _initial_dt(u0, f_init, span, cfg.rtol, cfg.atol)

    save_u0 = jnp.zeros((B, NS, u0.shape[-1]), dtype)
    # pre-fill slot 0 with the initial state (saveat includes tspan[0])
    save_u0 = save_u0.at[:, 0, :].set(u0)

    if init_state is not None:
        st = init_state
    else:
        st = PoolState(
            u=u0,
            lnt=lnt0,
            dt=dt_init,
            f0=f_init,
            g0=g_init,
            done=jnp.zeros(B, bool) | (span <= 0),
            ns_hit=jnp.zeros(B, bool),
            cut_short=jnp.zeros(B, bool),
            maxed=jnp.zeros(B, bool),
            n_cross=jnp.zeros(B, jnp.int32),
            cross_u=jnp.zeros((B, MAXC, u0.shape[-1]), dtype),
            cross_lnt=jnp.zeros((B, MAXC), dtype),
            save_u=save_u0,
            steps=jnp.zeros(B, jnp.int32),
            lnt_ck=lnt0,
            stalled=jnp.zeros(B, bool),
            errold=jnp.full(B, 1e-4, dtype),
        )

    taus_interior = jnp.linspace(0.0, 1.0, K + 1)[1:-1].astype(dtype)  # [K-1]

    def _sph_to_cart(x_sph):
        r, th, ph = x_sph[..., 0], x_sph[..., 1], x_sph[..., 2]
        st_, ct_ = jnp.sin(th), jnp.cos(th)
        return jnp.stack([r * st_ * jnp.cos(ph), r * st_ * jnp.sin(ph), r * ct_], axis=-1)

    def _process_events(st, active, u_prev, lnt_prev, h, u_new, f_prev, f_new, gs):
        """Locate, refine and record roots of the event condition within the
        accepted steps of `active` rays.  gs: [B, K+1] condition samples."""
        sign = jnp.sign(gs)
        flips = (sign[:, 1:] * sign[:, :-1] < 0) & active[:, None]  # [B, K]
        cursor = jnp.zeros(B, jnp.int32)

        def one_root(carry, _):
            st, cursor = carry
            # first flip index at or after cursor
            idx_grid = jnp.arange(K)[None, :]
            eligible = flips & (idx_grid >= cursor[:, None])
            has = jnp.any(eligible, axis=1)
            idx = jnp.argmax(eligible, axis=1)  # first True (0 if none; masked by has)

            tau_lo = idx.astype(dtype) / K
            tau_hi = (idx + 1).astype(dtype) / K
            g_lo = jnp.take_along_axis(gs, idx[:, None], axis=1)[:, 0]

            def bisect_body(_, tlg):
                tau_lo, tau_hi, g_lo = tlg
                tau_mid = 0.5 * (tau_lo + tau_hi)
                u_mid = _hermite(u_prev, u_new, f_prev, f_new, h[:, None], tau_mid[:, None])
                g_mid = v_cond(u_mid, lnt_prev + tau_mid * h, ray_args)
                go_left = jnp.sign(g_mid) == jnp.sign(g_lo)
                tau_lo = jnp.where(go_left, tau_mid, tau_lo)
                g_lo = jnp.where(go_left, g_mid, g_lo)
                tau_hi = jnp.where(go_left, tau_hi, tau_mid)
                return tau_lo, tau_hi, g_lo

            tau_lo, tau_hi, _ = lax.fori_loop(0, cfg.bisect_iters, bisect_body,
                                              (tau_lo, tau_hi, g_lo))
            tau_star = 0.5 * (tau_lo + tau_hi)
            u_star = _hermite(u_prev, u_new, f_prev, f_new, h[:, None], tau_star[:, None])
            lnt_star = lnt_prev + tau_star * h

            # --- acceptance filters (RayTracer.jl:303-322) ---
            pos = _sph_to_cart(u_star[:, 0:3])
            s = 1.0001
            within = jnp.all(
                (jnp.abs(pos) < jnp.abs(x0_cart) * s) & (jnp.abs(pos) > jnp.abs(x0_cart) / s),
                axis=1,
            )
            start_dup = within & (st.n_cross == 0)
            below_surf = u_star[:, 0] < r_ns * 1.01

            record = has & ~st.done & ~start_dup & ~below_surf & (st.n_cross < MAXC)

            slot = jnp.clip(st.n_cross, 0, MAXC - 1)
            cross_u = jnp.where(
                record[:, None, None], _scatter_rows(st.cross_u, slot, u_star), st.cross_u
            )
            cross_lnt = jnp.where(
                record[:, None], _scatter_vals(st.cross_lnt, slot, lnt_star), st.cross_lnt
            )
            n_cross = st.n_cross + record.astype(jnp.int32)
            term = record & (n_cross >= max_crossings)
            u_out = jnp.where(term[:, None], u_star, st.u)
            lnt_out = jnp.where(term, lnt_star, st.lnt)
            st = st._replace(
                cross_u=cross_u,
                cross_lnt=cross_lnt,
                n_cross=n_cross,
                cut_short=st.cut_short | term,
                done=st.done | term,
                u=u_out,
                lnt=lnt_out,
            )
            cursor = jnp.where(has, idx + 1, K).astype(jnp.int32)
            return (st, cursor), None

        (st, _), _ = lax.scan(one_root, (st, cursor), None, length=cfg.max_roots_per_step)
        return st

    def body(st):
        active = ~st.done
        t0 = st.lnt
        h = jnp.minimum(st.dt, lnt1 - t0)
        h = jnp.maximum(h, 0.0)

        # --- Dormand–Prince stages (FSAL: k1 = st.f0) ---
        ks = [st.f0]
        for i in range(1, 7):
            ui = st.u
            acc = jnp.zeros_like(st.u)
            for j, a in enumerate(_DP_A[i]):
                if a != 0.0:
                    acc = acc + a * ks[j]
            ui = st.u + h[:, None] * acc
            ti = t0 + _DP_C[i] * h
            ks.append(v_rhs(ui, ti, ray_args))
        u_new = st.u + h[:, None] * sum(b * k for b, k in zip(_DP_B5, ks) if b != 0.0)
        f_new = ks[6]  # FSAL: rhs at (t0 + h, u_new)
        err = h[:, None] * sum(e * k for e, k in zip(_DP_E, ks) if e != 0.0)

        enorm = _error_norm(err, st.u, u_new, cfg.rtol, cfg.atol)
        forced = st.dt <= cfg.dt_min * 1.0000001
        accept = ((enorm <= 1.0) | forced) & active & (h > 0)

        # Step controller: plain I by default; Lund/Hairer predictive PI
        # (dopri5.f) when cfg.pi_beta > 0 -- the errold boost damps the
        # accept/reject limit cycle near the error boundary
        en_safe = jnp.where(enorm > 0, enorm, 1e-10)
        if float(cfg.pi_beta):
            expo1 = 0.2 - 0.75 * float(cfg.pi_beta)
            fac = cfg.safety * en_safe ** -expo1 * st.errold ** cfg.pi_beta
            fac = jnp.clip(fac, cfg.min_dt_factor, cfg.max_dt_factor)
            fac = jnp.where(accept, fac, jnp.minimum(fac, 1.0))
        else:
            fac = cfg.safety * en_safe ** -0.2
            fac = jnp.clip(fac, cfg.min_dt_factor, cfg.max_dt_factor)
        dt_next = jnp.maximum(st.dt * fac, cfg.dt_min)

        t1 = t0 + h

        # --- dense output on the save grid ---
        in_step = (save_lnt > t0[:, None]) & (save_lnt <= t1[:, None]) & accept[:, None]
        tau_save = jnp.where(h[:, None] > 0, (save_lnt - t0[:, None]) / h[:, None], 0.0)
        u_save = _hermite(
            st.u[:, None, :], u_new[:, None, :], st.f0[:, None, :], f_new[:, None, :],
            h[:, None, None], tau_save[:, :, None],
        )
        save_u = jnp.where(in_step[:, :, None], u_save, st.save_u)

        g_new = v_cond(u_new, t1, ray_args)

        st2 = PoolState(
            u=jnp.where(accept[:, None], u_new, st.u),
            lnt=jnp.where(accept, t1, st.lnt),
            dt=jnp.where(active, dt_next, st.dt),
            f0=jnp.where(accept[:, None], f_new, st.f0),
            g0=jnp.where(accept, g_new, st.g0),
            done=st.done,
            ns_hit=st.ns_hit,
            cut_short=st.cut_short,
            maxed=st.maxed,
            n_cross=st.n_cross,
            cross_u=st.cross_u,
            cross_lnt=st.cross_lnt,
            save_u=save_u,
            steps=st.steps + active.astype(jnp.int32),
            lnt_ck=st.lnt_ck,
            stalled=st.stalled,
            errold=jnp.where(accept, jnp.maximum(enorm, 1e-4), st.errold),
        )

        if detect_events:
            # event condition on the interior interp grid
            u_taus = _hermite(
                st.u[:, None, :], u_new[:, None, :], st.f0[:, None, :], f_new[:, None, :],
                h[:, None, None], taus_interior[None, :, None],
            )  # [B, K-1, 7]
            lnt_taus = t0[:, None] + taus_interior[None, :] * h[:, None]
            g_interior = jax.vmap(v_cond, in_axes=(1, 1, None), out_axes=1)(
                u_taus, lnt_taus, ray_args
            )
            gs = jnp.concatenate(
                [st.g0[:, None], g_interior, g_new[:, None]], axis=1
            )  # [B, K+1]
            sign_flip_any = jnp.any(
                (jnp.sign(gs[:, 1:]) * jnp.sign(gs[:, :-1]) < 0) & accept[:, None]
            )
            st2 = lax.cond(
                sign_flip_any,
                lambda s: _process_events(s, accept, st.u, t0, h, u_new, st.f0, f_new, gs),
                lambda s: s,
                st2,
            )

        # --- terminal conditions ---
        ns_now = accept & kill_at_surface & (st2.u[:, 0] < r_ns * 1.01) & ~st2.done
        reached = accept & (t1 >= lnt1 - 1e-14) & ~st2.done
        maxed_now = (st2.steps >= cfg.max_steps) & ~st2.done
        # stall detector: no log-time progress over a window of attempts means
        # the ray is grinding at dt_min (see NumericsConfig.stall_window)
        if cfg.stall_window:
            at_window = (jnp.mod(st2.steps, cfg.stall_window) == 0) & (st2.steps > 0)
            stalled_now = (at_window & ~st2.done
                           & (st2.lnt - st2.lnt_ck < cfg.stall_min_progress))
            lnt_ck = jnp.where(at_window, st2.lnt, st2.lnt_ck)
            st2 = st2._replace(stalled=st2.stalled | stalled_now, lnt_ck=lnt_ck,
                               done=st2.done | stalled_now)
        st2 = st2._replace(
            ns_hit=st2.ns_hit | ns_now,
            maxed=st2.maxed | maxed_now,
            done=st2.done | ns_now | reached | maxed_now,
        )
        return st2

    if iter_budget is None:
        st = lax.while_loop(lambda s: jnp.any(~s.done), body, st)
    else:
        st, _ = lax.while_loop(
            lambda c: jnp.any(~c[0].done) & (c[1] < iter_budget),
            lambda c: (body(c[0]), c[1] + 1),
            (st, jnp.zeros((), jnp.int32)),
        )

    # fill save slots beyond each ray's final time with the terminal state
    past_end = save_lnt > st.lnt[:, None]
    save_u = jnp.where(past_end[:, :, None], st.u[:, None, :], st.save_u)

    res = PoolResult(
        u=st.u,
        lnt=st.lnt,
        save_u=save_u,
        cross_u=st.cross_u,
        cross_lnt=st.cross_lnt,
        n_cross=st.n_cross,
        cut_short=st.cut_short,
        ns_hit=st.ns_hit,
        maxed=st.maxed,
        steps=st.steps,
        stalled=st.stalled,
    )
    if return_state:
        return res, st
    return res


def _scatter_rows(buf, slot, rows):
    """buf[B, M, D], slot[B], rows[B, D] -> buf with buf[i, slot[i]] = rows[i]."""
    B = buf.shape[0]
    return buf.at[jnp.arange(B), slot].set(rows)


def _scatter_vals(buf, slot, vals):
    B = buf.shape[0]
    return buf.at[jnp.arange(B), slot].set(vals)
