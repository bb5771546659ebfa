"""Independent transcription audit of the formula chain.

Compares the package's conversion-physics functions against
`tests/oracle_transcription.py` — a from-scratch mpmath re-transcription of
the Julia lines (RayTracer.jl:1327-1473, 643-685, 734-790, 558-589;
MainRunner.jl:67-124) that imports nothing from the package and replaces AD
with high-precision adaptive finite differences.  This breaks the
self-referentiality of the scipy-oracle/pinned-literal tests: a transcription
error in the chain (e.g. a Christoffel sign) would have to be made twice,
independently, to pass here.

Tolerance: the package evaluates in f64 on CPU, so agreement is limited only
by f64 rounding through the chain (~1e-12 relative); we assert 1e-10.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mpmath as mp

import oracle_transcription as oracle

mp.mp.dps = 40

SC_KW = dict(mass_a=1e-5, ax_g=1e-12, theta_m=0.37, omega_pul=1.0,
             b0=1e14, r_ns=10.0, mass_ns=1.0)
RTOL = 1e-10
N_PTS = 20


def _scene():
    from adiabatic_raytracer.config import Scene

    return Scene(**SC_KW)


def _points(n=N_PTS, seed=7):
    """Random phase-space points in the conversion region: position near the
    surface, w_erg a bit above max(wp, mass_a), ksphere from a random local
    velocity direction (mirroring the production inputs)."""
    from adiabatic_raytracer.models.magnetosphere import omega_p_sph
    from adiabatic_raytracer.ops.dispersion import k_sphere

    rng = np.random.default_rng(seed)
    sc = _scene()
    pts = []
    while len(pts) < n:
        r = rng.uniform(11.0, 35.0)
        th = np.arccos(rng.uniform(-0.95, 0.95))
        ph = rng.uniform(-np.pi, np.pi)
        x_sph = np.array([r, th, ph])
        t = float(rng.uniform(0.0, 2.0))
        wp = float(omega_p_sph(jnp.asarray(x_sph), t, sc.theta_m, sc.omega_pul,
                               sc.b0, sc.r_ns, mass_a=sc.mass_a))
        w_erg = max(wp, SC_KW["mass_a"]) * (1.0 + rng.uniform(0.05, 0.8))
        x_cart = np.array([r * np.sin(th) * np.cos(ph),
                           r * np.sin(th) * np.sin(ph), r * np.cos(th)])
        vdir = rng.normal(size=3)
        vdir /= np.linalg.norm(vdir)
        v_loc = vdir * rng.uniform(0.05, 0.5)
        ks = np.asarray(k_sphere(jnp.asarray(x_cart), jnp.asarray(v_loc),
                                 SC_KW["mass_ns"]))
        pts.append((x_sph, x_cart, ks, t, w_erg, v_loc))
    return pts


@pytest.fixture(scope="module")
def points():
    return _points()


def _rel(a, b):
    a = float(a)
    b = float(b)
    return abs(a - b) / max(abs(b), 1e-300)


def test_omega_function(points):
    from adiabatic_raytracer.ops.dispersion import omega_function

    sc = _scene()
    for x_sph, _, ks, t, _, _ in points:
        got = float(omega_function(jnp.asarray(x_sph), jnp.asarray(ks), t, sc,
                                   sc.mass_ns, iso=False))
        want = oracle.omega_function(x_sph, ks, t, sc.theta_m, sc.omega_pul,
                                     sc.b0, sc.r_ns, sc.mass_ns, sc.mass_a)
        assert _rel(got, want) < RTOL


def test_k_norm_cart_branches(points):
    from adiabatic_raytracer.ops.dispersion import k_norm_cart

    sc = _scene()
    for x_sph, x_cart, _, t, w_erg, v_loc in points[:10]:
        erg = w_erg * np.sqrt(1.0 - float(2 * oracle.GNEW * 1.0
                                          / x_sph[0] / oracle.C_KM**2))
        for kwargs in (dict(is_photon=True, ax_fix=True),
                       dict(is_photon=False),
                       dict(is_photon=True, ax_fix=False)):
            got = np.asarray(k_norm_cart(
                jnp.asarray(x_cart), jnp.asarray(v_loc), t, jnp.asarray(erg),
                sc, sc.mass_ns, **kwargs))
            want = oracle.k_norm_cart(
                x_cart, v_loc, t, erg, sc.theta_m, sc.omega_pul, sc.b0,
                sc.r_ns, sc.mass_ns, sc.mass_a, **kwargs)
            for g, w in zip(got, want):
                assert _rel(g, w) < RTOL


def test_k_gamma(points):
    from adiabatic_raytracer.ops.conversion import k_gamma

    sc = _scene()
    for x_sph, _, ks, t, w_erg, _ in points[:10]:
        erg_inf = w_erg * float(mp.sqrt(
            1 - 2 * oracle.GNEW * 1.0 / mp.mpf(x_sph[0]) / oracle.C_KM**2))
        got = float(k_gamma(jnp.asarray(x_sph), jnp.asarray(ks), t,
                            jnp.asarray(erg_inf), sc, sc.mass_ns))
        want = oracle.k_gamma(x_sph, ks, t, erg_inf, sc.theta_m, sc.omega_pul,
                              sc.b0, sc.r_ns, sc.mass_ns, sc.mass_a)
        assert _rel(got, want) < RTOL


def test_dwp_ds_bundle(points):
    from adiabatic_raytracer.ops.conversion import dwp_ds

    sc = _scene()
    for _, x_cart, ks, t, w_erg, _ in points[:6]:
        got = dwp_ds(jnp.asarray(x_cart), jnp.asarray(ks), t,
                     jnp.asarray(w_erg), sc, sc.mass_ns)
        want = oracle.dwp_ds(x_cart, ks, t, w_erg, sc.theta_m, sc.omega_pul,
                             sc.b0, sc.r_ns, sc.mass_ns, sc.mass_a)
        for g, w in zip(got, want):
            assert _rel(float(g), w) < RTOL


def test_conversion_prob_chain(points):
    from adiabatic_raytracer.ops.conversion import conversion_prob

    sc = _scene()
    for x_sph, _, ks, t, w_erg, _ in points:
        got = conversion_prob(jnp.asarray(x_sph), jnp.asarray(ks), t,
                              jnp.asarray(w_erg), sc, sc.mass_ns)
        want = oracle.conversion_prob(
            sc.ax_g, x_sph, ks, t, w_erg, sc.theta_m, sc.omega_pul, sc.b0,
            sc.r_ns, sc.mass_ns, sc.mass_a)
        for g, w in zip(got, want):
            assert _rel(float(g), w) < RTOL


def test_get_prob_nonad(points):
    from adiabatic_raytracer.ops.conversion import get_prob_nonad

    sc = _scene()
    for x_sph, x_cart, _, _, w_erg, v_loc in points:
        erg_inf = w_erg * float(mp.sqrt(
            1 - 2 * oracle.GNEW * 1.0 / mp.mpf(x_sph[0]) / oracle.C_KM**2))
        got = float(get_prob_nonad(jnp.asarray(x_cart), jnp.asarray(v_loc),
                                   jnp.asarray(erg_inf), sc))
        want = oracle.get_prob_nonad(
            x_cart, v_loc, sc.mass_a, sc.ax_g, sc.theta_m, sc.omega_pul,
            sc.b0, sc.r_ns, erg_inf, sc.mass_ns)
        assert _rel(got, want) < RTOL


def test_g_det(points):
    from adiabatic_raytracer.ops.conversion import g_det

    sc = _scene()
    for x_sph, _, _, t, _, _ in points[:10]:
        got = float(g_det(jnp.asarray(x_sph), t, sc, sc.mass_ns))
        want = oracle.g_det(x_sph, t, sc.theta_m, sc.omega_pul, sc.b0,
                            sc.r_ns, sc.mass_ns, sc.mass_a)
        assert _rel(got, want) < RTOL


def test_v_infinity_and_jacobian(points):
    from adiabatic_raytracer.ops.conversion import jacobian_fv, v_infinity

    sc = _scene()
    for x_sph, x_cart, _, _, _, v_loc in points[:10]:
        # v_infinity needs |v|^2 > 2 GM/r/c^2 (escape ~0.52 at r=11); scale up
        v = v_loc / np.linalg.norm(v_loc) * 0.8
        r = float(x_sph[0])
        for c in range(3):
            got = float(v_infinity(jnp.asarray(x_sph[1]), jnp.asarray(x_sph[2]),
                                   jnp.asarray(r), jnp.asarray(v), v_comp=c,
                                   mass_ns=sc.mass_ns))
            want = oracle.v_infinity(x_sph[1], x_sph[2], r, v, v_comp=c,
                                     mass_ns=sc.mass_ns)
            assert _rel(got, want) < RTOL
        got_j = float(jacobian_fv(jnp.asarray(x_cart), jnp.asarray(v),
                                  mass_ns=sc.mass_ns))
        want_j = oracle.jacobian_fv(x_cart, v, mass_ns=sc.mass_ns)
        assert _rel(got_j, want_j) < RTOL
