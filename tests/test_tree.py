"""Branching-tree MC engine tests (vs MainRunner.jl:126-352)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adiabatic_raytracer.config import NumericsConfig, Scene, TreeConfig
from adiabatic_raytracer.models.magnetosphere import conversion_surface_radius
from adiabatic_raytracer.ops import sampler, tree
from adiabatic_raytracer.ops.dispersion import k_norm_cart


SC = Scene(mass_a=1e-5, ax_g=1e-12, theta_m=0.4, omega_pul=1.0, b0=1e14,
           r_ns=10.0, mass_ns=1.0)
CFG = NumericsConfig(interp_points=8, max_crossings=8)


def _events(n, key=0):
    maxR = float(conversion_surface_radius(SC.mass_a, SC.theta_m, SC.omega_pul,
                                           SC.b0, SC.r_ns))
    n_grid = sampler.default_n_grid(maxR, scan_per_step=8)
    got = {"x": [], "v": [], "e": []}
    k = jax.random.PRNGKey(key)
    while len(got["x"]) < n:
        k, sub = jax.random.split(k)
        res = sampler.sample_batch(sub, 16, maxR, SC, SC.mass_ns, n_grid=n_grid)
        for i in np.nonzero(np.asarray(res.success))[0]:
            got["x"].append(np.asarray(res.xpos[i]))
            got["v"].append(np.asarray(res.v_loc[i]))
            got["e"].append(float(res.erg_inf[i]))
    x = jnp.asarray(np.stack(got["x"][:n]))
    v = jnp.asarray(np.stack(got["v"][:n]))
    e = jnp.asarray(np.array(got["e"][:n]))
    k_init = k_norm_cart(x, v, 0.0, e, SC, SC.mass_ns, is_photon=True, ax_fix=True)
    return x, k_init, e


def test_backtrace_basic():
    x, k_init, erg = _events(3)
    bt = tree.backtrace(x, k_init, erg, SC, CFG, TreeConfig(), lnt_end=0.0)
    assert np.all(np.asarray(bt.prob0) > 0)
    assert np.all(np.asarray(bt.weight) > 0) and np.all(np.asarray(bt.weight) <= 1.0)
    np.testing.assert_allclose(np.asarray(bt.samp_back_weight),
                               np.asarray(bt.prob0) * np.asarray(bt.weight), rtol=1e-12)
    # every event has at least the fallback crossing
    assert np.all(np.asarray(bt.n_cross) >= 1)
    # tc re-zeroing (MainRunner.jl:627-629): all >= 0 with the last crossing at 0
    tc = np.asarray(bt.tc)
    valid = np.asarray(bt.valid)
    for e in range(3):
        tcs = tc[e][valid[e]]
        assert np.all(tcs >= -1e-15)
        assert abs(tcs.min()) < 1e-15


def test_forward_tree_weight_conservation():
    """Full-tree mode (no MC transition): processed-node weights split exactly,
    so tot_prob + pending weights == 1."""
    x, k_init, erg = _events(3)
    tcfg = TreeConfig(prob_cutoff=1e-10, num_cutoff=4, mc_nodes=100, max_nodes=8)
    out = tree.forward_tree(jax.random.PRNGKey(7), x, k_init, erg, SC, CFG, tcfg,
                            lnt_end=0.0)
    pools = out.pools
    pending_w = np.where(np.asarray(pools.status) == 1, np.asarray(pools.weight), 0.0)
    total = np.asarray(out.tot_prob) + pending_w.sum(axis=1)
    np.testing.assert_allclose(total, 1.0, atol=1e-9)
    assert np.all(np.asarray(out.count) >= 1)
    # info codes are in the documented set
    assert set(np.abs(np.asarray(out.info))).issubset({1, 2, 3, 4})


def test_forward_tree_finals_exist():
    x, k_init, erg = _events(2)
    tcfg = TreeConfig(num_cutoff=3, mc_nodes=3, max_nodes=8)
    out = tree.forward_tree(jax.random.PRNGKey(8), x, k_init, erg, SC, CFG, tcfg,
                            lnt_end=0.0)
    finals = np.asarray(out.pools.is_final) & (np.asarray(out.pools.status) == 2)
    assert finals.sum() >= 1
    # final positions are far from the star
    fpos = np.asarray(out.pools.fpos)[finals]
    assert np.all(np.linalg.norm(fpos, axis=1) > SC.r_ns * 1.1)


def test_compact_finals_matches_pools():
    """compact_finals (the device-side [E,F,14] pack the driver fetches)
    reproduces the host-side final extraction: same nodes, same per-event
    processing order, same field values."""
    x, k_init, erg = _events(3)
    tcfg = TreeConfig(num_cutoff=3, mc_nodes=3, max_nodes=8)
    out = tree.forward_tree(jax.random.PRNGKey(8), x, k_init, erg, SC, CFG, tcfg,
                            lnt_end=0.0)
    F = tree.max_finals(tcfg)
    fp = np.asarray(tree.compact_finals(out.pools, F))
    pl = out.pools
    fin = np.asarray(pl.is_final) & (np.asarray(pl.status) == 2)
    order = np.asarray(pl.order)
    assert fin.sum() >= 1
    for e in range(fin.shape[0]):
        p_ids = np.nonzero(fin[e])[0]
        p_ids = p_ids[np.argsort(order[e, p_ids], kind="stable")]
        valid = fp[e, :, 0] > 0.5
        assert valid.sum() == len(p_ids)
        assert not np.any(valid[len(p_ids):])  # valid slots are a prefix
        for j, p in enumerate(p_ids):
            np.testing.assert_allclose(fp[e, j, 1], float(np.asarray(pl.is_photon)[e, p]))
            np.testing.assert_allclose(fp[e, j, 2], np.asarray(pl.ferg)[e, p], rtol=1e-12)
            np.testing.assert_allclose(fp[e, j, 3], np.asarray(pl.weight)[e, p], rtol=1e-12)
            np.testing.assert_allclose(fp[e, j, 8:11], np.asarray(pl.fpos)[e, p], rtol=1e-12)
            np.testing.assert_allclose(fp[e, j, 11:14], np.asarray(pl.fmom)[e, p], rtol=1e-12)


def test_forward_tree_queue_compaction_invariants():
    """Force the global work-queue compaction path (tree_queue_width < E*K):
    deferral of light lanes must preserve weight conservation and produce a
    valid tree (finals, counts, info codes)."""
    x, k_init, erg = _events(3)
    cfg_w = NumericsConfig(interp_points=8, max_crossings=8, tree_queue_width=4)
    tcfg = TreeConfig(prob_cutoff=1e-10, num_cutoff=4, mc_nodes=100, max_nodes=8)
    out = tree.forward_tree(jax.random.PRNGKey(7), x, k_init, erg, SC, cfg_w, tcfg,
                            lnt_end=0.0)
    pools = out.pools
    pending_w = np.where(np.asarray(pools.status) == 1, np.asarray(pools.weight), 0.0)
    total = np.asarray(out.tot_prob) + pending_w.sum(axis=1)
    np.testing.assert_allclose(total, 1.0, atol=1e-9)
    assert np.all(np.asarray(out.count) >= 1)
    assert set(np.abs(np.asarray(out.info))).issubset({1, 2, 3, 4})


def test_mc_estimator_unbiased_vs_full_tree():
    """The pure-MC mode (count > mc_nodes: one drawn child carrying the full
    parent weight) must be a statistically unbiased estimator of the
    full-tree enumeration (SURVEY §7.3: 'proving the reweighted formulation
    is statistically identical').  Replicate ONE event N times with
    independent keys in MC mode and compare the mean outgoing photon weight
    against the deterministic full-tree value within sampling error."""
    x, k_init, erg = _events(1, key=5)
    cfg = NumericsConfig(interp_points=8, max_crossings=8)
    # generous cutoffs so both modes terminate via prob_cutoff, not truncation
    full_cfg = TreeConfig(prob_cutoff=1e-9, num_cutoff=64, mc_nodes=10_000,
                          max_nodes=64)
    mc_cfg = TreeConfig(prob_cutoff=1e-9, num_cutoff=64, mc_nodes=0,
                        max_nodes=64)

    def photon_weight(out):
        pl = out.pools
        fin = (np.asarray(pl.status) == 2) & np.asarray(pl.is_final) \
            & np.asarray(pl.is_photon)
        return np.sum(np.where(fin, np.asarray(pl.weight), 0.0), axis=1)

    full = tree.forward_tree(jax.random.PRNGKey(0), x, k_init, erg, SC, cfg,
                             full_cfg, lnt_end=0.0)
    assert np.all(np.abs(np.asarray(full.info)) == 2)  # prob_cutoff stop
    w_full = float(photon_weight(full)[0])
    assert w_full > 0

    N = 192
    xN = jnp.repeat(x, N, axis=0)
    kN = jnp.repeat(k_init, N, axis=0)
    eN = jnp.repeat(erg, N, axis=0)
    keysN = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(11), i))(
        jnp.arange(N))
    mc = tree.forward_tree(keysN, xN, kN, eN, SC, cfg, mc_cfg, lnt_end=0.0)
    w_mc = photon_weight(mc)
    se = float(np.std(w_mc, ddof=1)) / np.sqrt(N)
    diff = abs(float(np.mean(w_mc)) - w_full)
    # 4 sigma: flaky odds ~6e-5 under H0; a real bias of order w_full fails
    assert diff < max(4.0 * se, 1e-12), (diff, se, w_full, float(np.mean(w_mc)))


def test_streaming_window_matches_batch():
    """The streaming active-window engine (cfg.tree_window < E: finished
    events' window lanes refill from unstarted events) must produce BITWISE
    identical per-event results to the unwindowed engine — MC draws are
    keyed by (event key, node index) and slot allocation is per event, so
    only the iteration schedule may differ (n_iters/done_it excluded)."""
    x, k_init, erg = _events(6)
    tcfg = TreeConfig(prob_cutoff=1e-10, num_cutoff=3, mc_nodes=2, max_nodes=8)
    # tree_k pinned equal on both engines: auto-K is 1 under the window but
    # mc_nodes+2 without it (ops/tree.py), and the bitwise contract holds
    # only at equal K (node indices are assigned at pop time)
    cfg_b = NumericsConfig(interp_points=8, max_crossings=8, tree_k=4)
    cfg_s = NumericsConfig(interp_points=8, max_crossings=8, tree_k=4,
                           tree_window=2)
    outs = [tree.forward_tree(jax.random.PRNGKey(9), x, k_init, erg, SC, c,
                              tcfg, lnt_end=0.0) for c in (cfg_b, cfg_s)]
    skip = {"n_iters", "done_it"}
    for name in type(outs[0])._fields:
        if name in skip:
            continue
        a, b = getattr(outs[0], name), getattr(outs[1], name)
        for la, lb in zip(jax.tree_util.tree_leaves(a),
                          jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(np.asarray(la), np.asarray(lb),
                                          err_msg=name)


def test_prob_compaction_matches_full():
    """Forcing tiny tree_prob_width exercises both the compacted
    conversion-probability path and its overflow fallback; results must be
    identical to the full evaluation (per-point values are the same fn)."""
    x, k_init, erg = _events(3)
    tcfg = TreeConfig(num_cutoff=3, mc_nodes=3, max_nodes=8)
    cfg_full = NumericsConfig(interp_points=8, max_crossings=8,
                              tree_prob_width=10_000)
    cfg_tiny = NumericsConfig(interp_points=8, max_crossings=8,
                              tree_prob_width=2)
    outs = [tree.forward_tree(jax.random.PRNGKey(8), x, k_init, erg, SC, c,
                              tcfg, lnt_end=0.0) for c in (cfg_full, cfg_tiny)]
    for a, b in zip(jax.tree_util.tree_leaves(outs[0]),
                    jax.tree_util.tree_leaves(outs[1])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_windowed_auto_k1_exact_cutoff_semantics():
    """The windowed engine's auto-K is 1 (ops/tree.py), which makes the
    production default match the reference's per-node cutoff accounting
    EXACTLY (MainRunner.jl:324-339): cutoffs are checked once per iteration
    and an iteration processes exactly one node per event, so no K-batch
    overshoot is possible.  Pins (a) bitwise identity with an explicit
    tree_k=1 unwindowed run (the schedule-only window contract at the
    production K), and (b) the per-node accounting invariants on the
    windowed output: count <= max_nodes + 1 and count_main <= num_cutoff
    (the reference stops *after* the node that crosses the line)."""
    x, k_init, erg = _events(6)
    tcfg = TreeConfig(prob_cutoff=1e-10, num_cutoff=3, mc_nodes=2, max_nodes=6)
    cfg_w = NumericsConfig(interp_points=8, max_crossings=8, tree_window=2)
    cfg_1 = NumericsConfig(interp_points=8, max_crossings=8, tree_k=1)
    out_w, out_1 = [tree.forward_tree(jax.random.PRNGKey(5), x, k_init, erg,
                                      SC, c, tcfg, lnt_end=0.0)
                    for c in (cfg_w, cfg_1)]
    skip = {"n_iters", "done_it"}
    for name in type(out_w)._fields:
        if name in skip:
            continue
        for la, lb in zip(jax.tree_util.tree_leaves(getattr(out_w, name)),
                          jax.tree_util.tree_leaves(getattr(out_1, name))):
            np.testing.assert_array_equal(np.asarray(la), np.asarray(lb),
                                          err_msg=name)
    count = np.asarray(out_w.count)
    count_main = np.asarray(out_w.count_main)
    assert np.all(count <= tcfg.max_nodes + 1), count
    assert np.all(count_main <= tcfg.num_cutoff), count_main
