"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    traj, n_cross, fail = jax.jit(fn)(*args)
    assert np.all(np.isfinite(np.asarray(traj)))


def test_driver_mesh_invariant_with_mc(tmp_path):
    """Production driver: 1-device vs 2-device mesh runs produce identical
    rows at the same seed, with MCNodes=0 forcing every branching through an
    MC draw (per-event keys from global event numbers -> mesh-invariant)."""
    from adiabatic_raytracer.config import NumericsConfig, Scene, TreeConfig
    from adiabatic_raytracer.driver import run

    sc = Scene(theta_m=0.2)
    cfg = NumericsConfig(interp_points=8, max_crossings=8)
    tcfg = TreeConfig(num_cutoff=3, mc_nodes=0, max_nodes=10)
    rows = []
    for nd in (1, 2):
        out = run(sc, cfg, tcfg, 3, seed=4242, save_mode=1, verbose=False,
                  dir_tag=str(tmp_path / f"mesh{nd}"), event_batch=2,
                  mesh_devices=nd)
        assert out is not None
        rows.append(out[0])
    assert rows[0].shape[0] >= 1
    assert rows[0].shape == rows[1].shape
    # discrete structure (event no, species, node count, info, c_bck) must be
    # bit-identical: any MC-draw divergence would flip these first
    for col in (0, 1, 20, 21, 27):
        np.testing.assert_array_equal(rows[0][:, col], rows[1][:, col])
    # continuous columns agree up to XLA fusion-order FP noise (~1e-12)
    np.testing.assert_allclose(rows[0], rows[1], rtol=1e-9, atol=1e-300)


def test_sharded_matches_single_device():
    """1-chip vs 8-chip shardings produce identical per-event results
    (the reference's combine-step equivalence, SURVEY.md §4)."""
    import __graft_entry__ as ge
    import jax.numpy as jnp
    from adiabatic_raytracer.parallel.mesh import (
        event_pipeline_sharded, make_mesh, shard_inputs,
    )

    sc, cfg, tcfg = ge._scene_and_cfg(small=True)
    E = 8
    x, v, erg = ge._synthetic_events(E, seed=3)
    seeds = np.arange(E, dtype=np.int32)

    outs = []
    for nd in (1, 8):
        mesh = make_mesh(nd)
        fn = event_pipeline_sharded(mesh, sc, cfg, tcfg, maxR=25.0,
                                    lnt_end=float(np.log(1e-3)), nbins=16)
        args = shard_inputs(mesh, jnp.asarray(seeds), jnp.asarray(x),
                            jnp.asarray(v), jnp.asarray(erg))
        k_init, sln_prob, cos_w, bt, tr, hists = fn(*args)
        outs.append((np.asarray(sln_prob), np.asarray(bt.samp_back_weight),
                     np.asarray(hists[0])))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-12)
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-10)
    np.testing.assert_allclose(outs[0][2], outs[1][2], rtol=1e-10)


def test_driver_mesh_savemode3_files(tmp_path):
    """--mesh combined with saveMode 3: the clear-text event/final/tree
    writers fetch full sharded pytrees (pools, backtrace) — the files must
    exist and parse with the analysis loaders."""
    import os

    from adiabatic_raytracer.analysis import treeio
    from adiabatic_raytracer.config import NumericsConfig, Scene, TreeConfig
    from adiabatic_raytracer.driver import run

    sc = Scene(theta_m=0.2)
    cfg = NumericsConfig(interp_points=8, max_crossings=8)
    tcfg = TreeConfig(num_cutoff=3, mc_nodes=2, max_nodes=8)
    d = str(tmp_path)
    for sub in ("npy", "event", "tree"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    out = run(sc, cfg, tcfg, 3, seed=4242, save_mode=3, verbose=False,
              dir_tag=d, file_tag="m2", event_batch=2, mesh_devices=2)
    assert out is not None and out[0].shape[0] >= 1
    ev = treeio.load_event_info(os.path.join(d, "event", "event_m2"))
    assert ev[0].shape[0] == 2
    nodes = treeio.load_tree(os.path.join(d, "tree", "tree_m21"))
    assert nodes[0]["species"] == "axion" and len(nodes) >= 2


def test_queue_engine_under_shard_map():
    """The forward-tree queue engine under the driver's collective-free
    2-device shard_map reproduces the single-device trees exactly (the
    per-event keys travel with the events)."""
    import jax.numpy as jnp

    from adiabatic_raytracer.config import NumericsConfig, Scene, TreeConfig
    from adiabatic_raytracer.ops import tree
    from adiabatic_raytracer.parallel.mesh import make_mesh, shard_over_events
    import __graft_entry__ as ge

    sc = Scene(theta_m=0.2)
    cfg = NumericsConfig(interp_points=8, max_crossings=8)
    tcfg = TreeConfig(num_cutoff=3, mc_nodes=0, max_nodes=6)
    E = 4
    x, v, erg = (jnp.asarray(a) for a in ge._synthetic_events(E, seed=5))
    keys = jax.vmap(lambda e: jax.random.fold_in(jax.random.PRNGKey(9), e))(
        jnp.arange(E))

    def fn(keys, x, k, e):
        tr = tree.forward_tree(keys, x, k, e, sc, cfg, tcfg,
                               lnt_end=float(np.log(1e-3)))
        return (tr.count, tr.count_main, tr.info, tr.tot_prob,
                tr.pools.weight, tr.pools.fpos)

    single = jax.tree.map(np.asarray, jax.jit(fn)(keys, x, v, erg))
    sharded = jax.tree.map(np.asarray, jax.jit(
        shard_over_events(make_mesh(2), fn))(keys, x, v, erg))
    assert single[0].min() >= 1
    for a, b in zip(single[:3], sharded[:3]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(single[3:], sharded[3:]):
        # continuous fields agree up to XLA fusion-order noise (~1e-11)
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)


@pytest.mark.parametrize("coordinator", [None, "localhost:1"])
def test_init_distributed_raises_only_with_coordinator(monkeypatch,
                                                        coordinator):
    """A failed jax.distributed.initialize is an error when a coordinator
    was given, and a no-op (single process) when none was."""
    from adiabatic_raytracer.parallel import mesh

    def fail(**kwargs):
        raise RuntimeError("no cluster")

    monkeypatch.setattr(jax.distributed, "initialize", fail)
    if coordinator is None:
        mesh.init_distributed(None)
    else:
        with pytest.raises(RuntimeError, match="no cluster"):
            mesh.init_distributed(coordinator, 2, 0)
