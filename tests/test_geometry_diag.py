"""Conversion-surface-angle diagnostics and on-shell probe
(surfNorm / theta_B / angle_vg_sNorm / dθdr_proj / d2wdr2_abs_vec,
RayTracer.jl:895-1063; test_on_shell, RayTracer.jl:591-629)."""

import jax
import jax.numpy as jnp
import numpy as np

from adiabatic_raytracer.config import Scene
from adiabatic_raytracer.ops import geometry
from adiabatic_raytracer.ops.dispersion import ctheta_b_sphere
from adiabatic_raytracer.ops.dispersion import test_on_shell as on_shell_diag

SC = Scene(mass_a=1e-5, ax_g=1e-12, theta_m=0.3, omega_pul=1.0, b0=1e14,
           r_ns=10.0, mass_ns=1.0)

X = jnp.asarray([18.0, 6.0, 9.0])
K = jnp.asarray([-0.7, 0.2, -0.4])


def test_surf_norm_cosine_and_unit_normal():
    ct, snorm = geometry.surf_norm(X, K, 0.0, SC, SC.mass_ns, return_vec=True)
    assert -1.0 <= float(ct) <= 1.0
    x_sph = geometry.cart_to_sph(X)
    nrm = geometry.spatial_norm(x_sph, snorm, SC.mass_ns)
    np.testing.assert_allclose(float(nrm), 1.0, rtol=1e-10)
    # reversing the momentum flips the cosine
    ct2 = geometry.surf_norm(X, -K, 0.0, SC, SC.mass_ns)
    np.testing.assert_allclose(float(ct2), -float(ct), rtol=1e-10)
    # angle_vg_sNorm evaluates the identical projection
    np.testing.assert_allclose(
        float(geometry.angle_vg_snorm(X, K, 0.0, SC, SC.mass_ns)), float(ct))


def test_theta_b_matches_covariant_angle_in_flat_space():
    """In flat space the covariant celerity angle equals the Cartesian angle."""
    th = geometry.theta_b_cart(X, K, 0.0, SC)
    x_sph = geometry.cart_to_sph(X)
    w = geometry.celerity_from_cart(X, K, 0.0)
    ct_cov = ctheta_b_sphere(x_sph, w, 0.0, SC, 0.0)
    np.testing.assert_allclose(float(jnp.cos(th)), float(ct_cov), rtol=1e-8)


def test_second_derivative_bundle_finite():
    assert np.isfinite(float(geometry.dtheta_dr_proj(X, K, 0.0, SC)))
    assert float(geometry.dtheta_dr_proj(X, K, 0.0, SC)) >= 0
    assert np.isfinite(float(geometry.dwdr_abs_proj(X, K, 0.0, SC)))
    assert np.isfinite(float(geometry.d2wdr2_abs_vec(X, K, 0.0, SC)))


def test_on_shell_probe():
    x = jnp.stack([X, jnp.asarray([10.5, 0.5, 0.5])])  # far + near-surface
    v = jnp.asarray([[-0.9, 0.1, -0.3], [0.5, 0.5, 0.5]])
    v = v / jnp.linalg.norm(v, axis=1, keepdims=True)
    vmag = jnp.full(2, 220.0)
    vals, mask, min_val = on_shell_diag(x, v, vmag, 0.0, SC, SC.mass_ns,
                                        iso=True, melrose=False)
    m = np.asarray(mask)
    assert m[0]  # far point: erg_local > omega_p, photon propagates
    assert not m[1]  # deep in the magnetosphere: evanescent
    assert np.isfinite(float(min_val))
    assert np.isfinite(np.asarray(vals)[0])


def test_legacy_flat_sampling_measure():
    """find_samples' 1/r measure (flat_sampling=False) draws r uniformly,
    the production measure (True) sqrt-uniformly."""
    from adiabatic_raytracer.ops import sampler

    key = jax.random.PRNGKey(3)
    res_flat = sampler.sample_batch(key, 64, 25.0, SC, SC.mass_ns, n_grid=256,
                                    flat_sampling=True)
    res_leg = sampler.sample_batch(key, 64, 25.0, SC, SC.mass_ns, n_grid=256,
                                   flat_sampling=False)
    rf = np.asarray(res_flat.r_disk)
    rl = np.asarray(res_leg.r_disk)
    # same underlying uniforms: flat measure = sqrt(u)*maxR, legacy = u*maxR
    np.testing.assert_allclose(rf, np.sqrt(rl / 25.0) * 25.0, rtol=1e-10)
