"""Auxiliary radiative-transfer pieces: cyclotron resonance optical depth and
along-trajectory energy drift.

Mirrors the partially-wired components of the reference:
  * Crossings / get_crossings / apply   RayTracer.jl:29-66   (C3)
  * cyclotronF / cyclotronF_vec         RayTracer.jl:792-802 (C22)
  * tau_cyc                             RayTracer.jl:804-851 (C22; unused in
    the production path but kept for parity)
  * dwdt_vec                            RayTracer.jl:690-704 (C23)
  * dist_diff                           RayTracer.jl:1805-1810

These operate on saved trajectory arrays [B, NS, 3] / [B, NS].
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from adiabatic_raytracer.config import Scene
from adiabatic_raytracer.constants import C_KM, HBAR
from adiabatic_raytracer.models.magnetosphere import (
    b_cart,
    cyclotron_freq_cart,
    omega_p_cart,
)


class Crossings(NamedTuple):
    """Sign-crossing bracketing on a sampled series (RayTracer.jl:29-66):
    i1/i2 bracket indices, weight = linear-interp weight of i1."""
    i1: jnp.ndarray
    i2: jnp.ndarray
    weight: jnp.ndarray
    mask: jnp.ndarray


def get_crossings(a, *, max_crossings: int = 8, keep_all: bool = True) -> Crossings:
    """Fixed-size version of get_crossings: indices just before/after each
    sign change of `a` plus linear-interpolation weights."""
    sign = jnp.sign(a)
    diff = sign[1:] - sign[:-1]
    hit = (diff != 0) if keep_all else (diff > 0)
    i1 = jnp.nonzero(hit, size=max_crossings, fill_value=a.shape[0] - 2)[0]
    mask = jnp.arange(max_crossings) < jnp.sum(hit)
    i2 = i1 + 1
    weight = a[i2] / (a[i2] - a[i1])
    return Crossings(i1=i1, i2=i2, weight=weight, mask=mask)


def apply_crossings(c: Crossings, arr):
    """Interpolate `arr` at the crossing points (apply, RayTracer.jl:38-40)."""
    return arr[c.i1] * c.weight + arr[c.i2] * (1.0 - c.weight)


def tau_cyc(x_traj, k_traj, tarr, t_start, sc: Scene):
    """Cyclotron-resonance optical depth along saved trajectories
    (tau_cyc, RayTracer.jl:804-851).

    x_traj, k_traj: [B, NS, 3]; tarr: [NS]; t_start: [B].
    Finds the first crossing of log(omega_c) - log(mass_a) along each
    trajectory and evaluates tau = pi omega_p^2 / |khat . grad omega_c| / (c hbar).
    """
    B, NS, _ = x_traj.shape

    def one(xs, ks, t0s):
        t0 = tarr + t0s
        cyc = jax.vmap(
            lambda x, t: cyclotron_freq_cart(x, t, sc.theta_m, sc.omega_pul,
                                             sc.b0, sc.r_ns)
        )(xs, t0)
        cx = get_crossings(jnp.log(cyc) - jnp.log(sc.mass_a), max_crossings=1)
        found = cx.mask[0]
        w = cx.weight[0]
        tp = jnp.where(found, t0[cx.i1[0]] * w + (1 - w) * t0[cx.i2[0]], t0[0])
        xp = jnp.where(found, xs[cx.i1[0]] * w + (1 - w) * xs[cx.i2[0]], xs[0])
        kp = jnp.where(found, ks[cx.i1[0]] * w + (1 - w) * ks[cx.i2[0]],
                       jnp.zeros(3, xs.dtype))
        wp = omega_p_cart(xp, tp, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                          mass_a=sc.mass_a, bndry_lyr=sc.bndry_lyr)
        grad_oc = jax.grad(
            lambda x: cyclotron_freq_cart(x, tp, sc.theta_m, sc.omega_pul,
                                          sc.b0, sc.r_ns)
        )(xp)
        kmag = jnp.linalg.norm(kp)
        doc_dl = jnp.abs(jnp.dot(kp, grad_oc)) / jnp.where(kmag > 0, kmag, 1.0)
        tau = jnp.pi * wp**2 / doc_dl / (C_KM * HBAR)
        return jnp.where(kmag > 0, tau, 0.0)

    return jax.vmap(one)(x_traj, k_traj, t_start)


def dwdt_vec(x_traj, k_traj, tarr, t_start, sc: Scene, omega_fn):
    """Accumulated energy drift along trajectories (dwdt_vec,
    RayTracer.jl:690-704): sum of (d omega/dt) * path-length / c."""

    def one(xs, ks, t0s):
        t0 = tarr + t0s

        def seg(i):
            dwdt = jax.grad(lambda t: omega_fn(xs[i], ks[i], t, sc))(t0[i])
            dl = jnp.linalg.norm(xs[i] - xs[i - 1])
            return dwdt * dl / C_KM

        return jnp.sum(jax.vmap(seg)(jnp.arange(1, xs.shape[0])))

    return jax.vmap(one)(x_traj, k_traj, t_start)


def dist_diff(x_traj):
    """Successive radial distance differences in 1/eV (dist_diff,
    RayTracer.jl:1805-1810)."""
    r = jnp.linalg.norm(x_traj, axis=-1)  # [B, NS]
    b = jnp.zeros_like(r)
    b = b.at[:, :-1].set(jnp.abs(r[:, 1:] - r[:, :-1]) / C_KM / HBAR)
    b = b.at[:, -1].set(b[:, -3])
    return b
