"""CompactedPropagator must reproduce plain propagate exactly (same step
sequence; compaction only re-orders lanes)."""

import jax.numpy as jnp
import numpy as np

from adiabatic_raytracer.config import NumericsConfig, Scene
from adiabatic_raytracer.ops.propagate import propagate
from adiabatic_raytracer.ops.streaming import CompactedPropagator


def test_compacted_matches_monolithic():
    sc = Scene(mass_a=1e-5, ax_g=1e-12, theta_m=0.2, omega_pul=1.0, b0=1e14,
               r_ns=10.0, mass_ns=1.0)
    cfg = NumericsConfig(interp_points=8)
    B = 64
    rng = np.random.default_rng(3)
    r = rng.uniform(14.0, 24.0, B)
    th = np.arccos(rng.uniform(-0.9, 0.9, B))
    ph = rng.uniform(-np.pi, np.pi, B)
    x = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                  r * np.cos(th)], axis=1)
    v = rng.normal(size=(B, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    erg = np.full(B, 1.0000005e-5)
    args = dict(
        erg=jnp.asarray(erg),
        delta_w=-jnp.ones(B),
        lnt0=jnp.full(B, cfg.ln_t_start),
        lnt1=jnp.full(B, float(np.log(3e-3))),
        is_photon=jnp.ones(B, bool),
        max_crossings=jnp.ones(B, jnp.int32),
    )
    ref = propagate(jnp.asarray(x), jnp.asarray(v), sc, cfg, species="photon",
                    **args)
    cp = CompactedPropagator(sc, cfg, species="photon", chunk_iters=64,
                             min_pool=16)
    got = cp.run(jnp.asarray(x), jnp.asarray(v), args["erg"], args["delta_w"],
                 args["lnt0"], args["lnt1"], args["is_photon"],
                 args["max_crossings"])
    # The chunked program compiles with different fusion boundaries than the
    # monolithic one, so results agree to rounding-amplified tolerance, not
    # bit-exactly.
    np.testing.assert_allclose(np.asarray(got.traj), np.asarray(ref.traj),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(got.n_cross), np.asarray(ref.n_cross))
    steps_ref = np.asarray(ref.steps)
    steps_got = np.asarray(got.steps)
    assert np.mean(np.abs(steps_got - steps_ref)) < 0.05 * steps_ref.mean()
    np.testing.assert_allclose(np.asarray(got.xc), np.asarray(ref.xc),
                               rtol=1e-4, atol=1e-6)


def test_driver_pool_compact_matches_pool(tmp_path):
    """engine='pool_compact' (backtrace through CompactedPropagator) is a
    production path: same rows as engine='pool' up to the compaction
    fusion-boundary noise."""
    from adiabatic_raytracer.config import TreeConfig
    from adiabatic_raytracer.driver import run

    sc = Scene(theta_m=0.2)
    tcfg = TreeConfig(num_cutoff=3, mc_nodes=2, max_nodes=8)
    rows = {}
    for eng in ("pool", "pool_compact"):
        cfg = NumericsConfig(interp_points=8, max_crossings=8, engine=eng)
        out = run(sc, cfg, tcfg, 3, seed=911, save_mode=1, verbose=False,
                  dir_tag=str(tmp_path / eng), event_batch=2)
        rows[eng] = out[0]
    a, b = rows["pool"], rows["pool_compact"]
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[:, 1], b[:, 1])    # species
    np.testing.assert_array_equal(a[:, 21], b[:, 21])  # info
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-12)
