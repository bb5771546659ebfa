"""On-device spectrum / pulse-profile reductions.

Replaces the reference's file-based merge + numpy histogram post-processing
(plot/flux.py:38-48, Combine_Files) with scatter-add histograms that can be
psum-reduced across a device mesh.
"""

from __future__ import annotations

import jax.numpy as jnp


def weighted_histogram(x, w, nbins: int, lo, hi):
    """Fixed-range weighted histogram via scatter-add (flux.py:43-48 semantics:
    values outside [lo, hi] are dropped)."""
    idx = jnp.floor((x - lo) / (hi - lo) * nbins).astype(jnp.int32)
    ok = (idx >= 0) & (idx < nbins)
    idx = jnp.clip(idx, 0, nbins - 1)
    return jnp.zeros(nbins, w.dtype).at[idx].add(jnp.where(ok, w, 0.0))


def pulse_profile_from_pools(pools, samp_back_weight, sln_prob, nbins: int = 50):
    """Per-species phi_f flux histograms straight from tree pools (on device).

    pps = weight * samp_back_weight * sln_prob per final particle, binned in
    the final momentum azimuth (flux.py:38-48).  Returns (photon_hist,
    axion_hist), each [nbins] over phi in [-pi, pi].

    Pass the device-safe sln_base (driver._event_kinematics): full-scale
    sln_prob (~1e39) overflows f32 — scale the returned histograms by the
    host scalar driver.sln_scale afterwards.
    """
    final = pools.is_final & (pools.status == 2)  # [E, P]
    phi_f = jnp.arctan2(pools.fmom[..., 1], pools.fmom[..., 0])  # [E, P]
    pps = pools.weight * samp_back_weight[:, None] * sln_prob[:, None]
    w_ph = jnp.where(final & pools.is_photon, pps, 0.0).reshape(-1)
    w_ax = jnp.where(final & ~pools.is_photon, pps, 0.0).reshape(-1)
    phi = phi_f.reshape(-1)
    pi = jnp.pi
    return (weighted_histogram(phi, w_ph, nbins, -pi, pi),
            weighted_histogram(phi, w_ax, nbins, -pi, pi))
