"""External numerical anchoring (BASELINE.md <1e-4 contract).

The golden tests elsewhere transcribe the same formulas they check; these
anchor the *integration machinery* against an independent high-precision
oracle (scipy DOP853 at rtol=1e-12 on the identical RHS/event condition) and
pin conversion-probability literals so a silent formula drift fails loudly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.integrate import solve_ivp

from adiabatic_raytracer.config import NumericsConfig, Scene
from adiabatic_raytracer.ops.conversion import get_prob_nonad
from adiabatic_raytracer.ops.dispersion import k_norm_cart
from adiabatic_raytracer.ops.geometry import (
    cart_to_sph,
    celerity_from_cart,
    sph_to_cart,
)
from adiabatic_raytracer.ops.propagate import (
    crossing_condition,
    make_rhs,
    propagate,
)

SC = Scene(theta_m=0.2)
ERG = 1e-5 * (1 + 0.5 * (220.0 / 2.99792e5) ** 2)


def _oracle(x0, k0, sc, species, lnt0, lnt1, with_event=False):
    """Integrate the repo's own RHS with scipy DOP853 at rtol 1e-12."""
    x0j = jnp.asarray(x0[None, :])
    k0j = jnp.asarray(k0[None, :])
    ergj = jnp.asarray(np.array([ERG]))
    k0n = k_norm_cart(x0j, k0j, 0.0, ergj, sc, sc.mass_ns, is_photon=True,
                      ax_fix=True)
    w0 = celerity_from_cart(x0j, k0n, sc.mass_ns) / ergj[:, None]
    u0 = np.concatenate([np.asarray(cart_to_sph(x0j))[0], np.asarray(w0)[0],
                         [ERG * -1.0]])
    rhs = make_rhs(sc, sc.mass_ns_eff, 0.0, species)
    rargs = {"erg": jnp.asarray(ERG), "is_photon": jnp.asarray(species == "photon")}
    f = jax.jit(lambda u, t: rhs(u, t, rargs))
    cnd = jax.jit(lambda u, t: crossing_condition(u, t, None, sc, sc.mass_ns_eff))
    events = (lambda t, y: float(cnd(jnp.asarray(y), jnp.asarray(t)))) if with_event else None
    sol = solve_ivp(lambda t, y: np.asarray(f(jnp.asarray(y), jnp.asarray(t))),
                    (lnt0, lnt1), u0, rtol=1e-12, atol=1e-12, method="DOP853",
                    events=events)
    return sol


def _run_repo(x0, k0, sc, species, lnt0, lnt1, rtol, atol):
    cfg = NumericsConfig(rtol=rtol, atol=atol, interp_points=16, max_crossings=8)
    return propagate(
        jnp.asarray(x0[None, :]), jnp.asarray(k0[None, :]), sc, cfg,
        erg=jnp.asarray(np.array([ERG])), delta_w=-jnp.ones(1),
        lnt0=jnp.full(1, lnt0), lnt1=jnp.full(1, lnt1),
        is_photon=jnp.asarray([species == "photon"]),
        max_crossings=jnp.full(1, 8, jnp.int32), species=species)


def test_photon_endpoint_vs_scipy_oracle():
    """Endpoint error is tolerance-limited: well inside the 1e-4 contract at
    rtol 1e-9, and converging with rtol (so the integrator, events aside,
    solves the same IVP as the oracle)."""
    x0 = np.array([17.0, 4.0, 8.0])
    k0 = np.array([-0.8, 0.15, -0.5])
    lnt0, lnt1 = -30.0, float(np.log(1e-2))
    sol = _oracle(x0, k0, SC, "photon", lnt0, lnt1)
    end_oracle = np.asarray(sph_to_cart(jnp.asarray(sol.y[:3, -1])))

    errs = {}
    for rt, at in ((1e-7, 1e-6), (1e-9, 1e-8)):
        res = _run_repo(x0, k0, SC, "photon", lnt0, lnt1, rt, at)
        e = np.asarray(res.traj[0, -1, :])
        errs[rt] = float(np.max(np.abs(e - end_oracle) / np.linalg.norm(end_oracle)))
    assert errs[1e-9] < 1e-5, errs
    assert errs[1e-7] < 5e-3, errs
    assert errs[1e-9] < errs[1e-7] / 10, errs  # tolerance-limited convergence


def test_crossing_location_vs_scipy_event():
    """Level-crossing position and time match the oracle's event rootfinder
    (the reference's ContinuousCallback role, RayTracer.jl:357-358)."""
    sc_b = dataclasses.replace(SC, b0=-SC.b0)  # backtrace field sign
    x0 = np.array([18.08684675, 0.38234811, -3.57130891])
    k0 = np.array([1.02753178, 0.07189269, -0.38607171])
    lnt0, lnt1 = -30.0, 0.0

    res = _run_repo(x0, k0, sc_b, "axion", lnt0, lnt1, 1e-9, 1e-8)
    nc = int(res.n_cross[0])
    assert nc == 1

    sol = _oracle(x0, k0, sc_b, "axion", lnt0, lnt1, with_event=True)
    assert len(sol.t_events[0]) >= 1
    xc_oracle = np.asarray(sph_to_cart(jnp.asarray(sol.y_events[0][0][:3])))
    xc_repo = np.asarray(res.xc[0, 0])
    np.testing.assert_allclose(xc_repo, xc_oracle, rtol=1e-5)
    t_oracle = float(np.exp(sol.t_events[0][0]))
    np.testing.assert_allclose(float(res.tc[0, 0]), t_oracle, rtol=1e-5)


def test_conversion_prob_pinned_values():
    """P_nonAD at fixed phase-space points, pinned to committed literals
    (conversion_prob, RayTracer.jl:1405-1473 via get_Prob_nonAD,
    MainRunner.jl:67-124): any silent drift of the formula chain fails here."""
    pts = np.array([[18.0868467464, 0.3823481143, -3.5713089138],
                    [16.0, 3.0, 6.0],
                    [14.0, -5.0, 2.0]])
    ks = np.array([[1.0275317786, 0.0718926904, -0.3860717130],
                   [0.6, -0.1, 0.45],
                   [-0.5, 0.3, 0.8]])
    pinned = np.array([5.656528832523e-04, 1.590162116209e-03,
                       1.725595369419e-04])
    got = np.array([
        float(get_prob_nonad(jnp.asarray(p), jnp.asarray(k), jnp.asarray(ERG), SC))
        for p, k in zip(pts, ks)
    ])
    np.testing.assert_allclose(got, pinned, rtol=1e-8)
