"""Metric layer golden-value and property tests (vs RayTracer.jl:455-527)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adiabatic_raytracer.constants import C_KM, G_NEW
from adiabatic_raytracer.models import metric


def ref_metric_exterior(r, theta, mass_ns):
    """Independent re-derivation of the exterior inverse Schwarzschild metric."""
    rs = 2.0 * G_NEW * mass_ns / C_KM**2
    A = 1.0 - rs / r
    return -1.0 / A, A, 1.0 / r**2, 1.0 / (r * np.sin(theta)) ** 2


def test_exterior_values():
    x = jnp.array([25.0, 0.7, 1.3])
    g = metric.metric_inverse(x, 1.0)
    expected = ref_metric_exterior(25.0, 0.7, 1.0)
    for got, want in zip(g, expected):
        np.testing.assert_allclose(float(got), want, rtol=1e-12)


def test_flat_limit():
    x = jnp.array([25.0, 0.7, 1.3])
    g_tt, g_rr, g_thth, g_pp = metric.metric_inverse(x, 0.0)
    np.testing.assert_allclose(float(g_tt), -1.0, rtol=1e-12)
    np.testing.assert_allclose(float(g_rr), 1.0, rtol=1e-12)


def test_interior_continuity_at_surface():
    """Interior continuation must match the exterior at r = r_NS."""
    eps = 1e-9
    below = metric.metric_inverse(jnp.array([10.0 - eps, 1.0, 0.5]), 1.0)
    above = metric.metric_inverse(jnp.array([10.0 + eps, 1.0, 0.5]), 1.0)
    for b, a in zip(below, above):
        np.testing.assert_allclose(float(b), float(a), rtol=1e-6)


def test_interior_formula_value():
    """Spot-check interior formula with the reference's scaled-r_s convention."""
    r, r_ns, m = 5.0, 10.0, 1.0
    rs = 2.0 * G_NEW * m / C_KM**2 * (r / r_ns) ** 3
    want_g_rr = 1.0 - r**2 * rs / r_ns**3
    want_g_tt = -4.0 / (3.0 * np.sqrt(1 - rs / r_ns) - np.sqrt(1 - r**2 * rs / r_ns**3)) ** 2
    g_tt, g_rr, _, _ = metric.metric_inverse(jnp.array([r, 1.0, 0.5]), m)
    np.testing.assert_allclose(float(g_rr), want_g_rr, rtol=1e-12)
    np.testing.assert_allclose(float(g_tt), want_g_tt, rtol=1e-12)


def test_gradient_no_nan_across_surface():
    f = lambda x: metric.metric_inverse(x, 1.0)[1]
    for r in [5.0, 9.999, 10.001, 50.0, 1e5]:
        g = jax.grad(f)(jnp.array([r, 1.0, 0.5]))
        assert np.all(np.isfinite(np.asarray(g))), r


def test_christoffel_values():
    r, theta, m = 30.0, 0.9, 1.5
    gm = G_NEW * m / C_KM**2
    out = metric.christoffel(jnp.array([r, theta, 0.3]), m)
    want = (
        -gm / (r * (r - 2 * gm)),
        -(r - 2 * gm),
        -(r - 2 * gm) * np.sin(theta) ** 2,
        1 / r,
        -np.sin(theta) * np.cos(theta),
        1 / r,
        np.cos(theta) / np.sin(theta),
        1 / r,
        1 / r,
        np.cos(theta) / np.sin(theta),
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(want), rtol=1e-12)
