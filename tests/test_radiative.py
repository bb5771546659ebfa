"""Tests for crossing utils, cyclotron optical depth, energy drift."""

import jax.numpy as jnp
import numpy as np

from adiabatic_raytracer.config import Scene
from adiabatic_raytracer.ops import radiative as rad

SC = Scene(mass_a=1e-5, theta_m=0.3, omega_pul=1.0, b0=1e14, r_ns=10.0, mass_ns=1.0)


def test_get_crossings_linear():
    x = jnp.linspace(0, 4 * np.pi, 200)
    c = rad.get_crossings(jnp.sin(x + 0.1))
    n = int(c.mask.sum())
    assert n == 4  # roots at pi-0.1, 2pi-0.1, 3pi-0.1, 4pi-0.1
    roots = rad.apply_crossings(c, x)[:n]
    np.testing.assert_allclose(np.asarray(roots),
                               [np.pi - 0.1, 2 * np.pi - 0.1, 3 * np.pi - 0.1,
                                4 * np.pi - 0.1], rtol=1e-3)


def test_tau_cyc_runs():
    # radially outgoing trajectory crossing the cyclotron resonance
    NS = 64
    rr = np.linspace(11, 5000, NS)
    x = np.zeros((1, NS, 3))
    x[0, :, 0] = rr * 0.6
    x[0, :, 2] = rr * 0.8
    k = np.broadcast_to(np.array([0.6, 0.0, 0.8]) * 1e-5, (1, NS, 3)).copy()
    tarr = jnp.linspace(0, 1e-2, NS)
    tau = rad.tau_cyc(jnp.asarray(x), jnp.asarray(k), tarr, jnp.zeros(1), SC)
    assert np.isfinite(float(tau[0])) and float(tau[0]) >= 0


def test_dist_diff():
    x = np.zeros((1, 4, 3))
    x[0, :, 0] = [10.0, 20.0, 40.0, 70.0]
    d = rad.dist_diff(jnp.asarray(x))
    from adiabatic_raytracer.constants import C_KM, HBAR

    np.testing.assert_allclose(np.asarray(d)[0, 0], 10 / C_KM / HBAR, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(d)[0, -1], np.asarray(d)[0, -3], rtol=1e-12)
