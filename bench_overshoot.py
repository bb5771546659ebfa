#!/usr/bin/env python
"""Quantify the work-queue K-batch cutoff overshoot.

The batched tree engine checks prob/num/max cutoffs once per K-node
iteration (ops/tree.py), so an event may process up to K-1 nodes past the
cutoff the reference checks per node (MainRunner.jl:324-339) — strictly
MORE tree explored.  `tree_k=1` forces one lane per event per iteration,
i.e. exact per-node cutoff semantics at ~K times the iteration count.

This A/B runs the full pipeline at the reference's production cutoffs
(runner_example.sh:4) with tree_k=1 vs the default K, same seed and
sampling stream, and reports the distributional deltas on the OUTPUT
population: rows/event, finals/event, nodes/event, the stop-code (info)
histogram, and the weighted row sums the flux analysis consumes
(sum of weight and weight*sln_prob per species, plot/flux.py:20-35).

Env knobs: BENCH_EVENTS (default 2048), BENCH_EVENT_BATCH (default 512),
BENCH_SEED (default 1769).  Prints one JSON line.
"""

import json
import os
import shutil
import sys
import tempfile
import time

# scratch output stays inside the checkout (results/ is git-ignored)
RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")


def _run(tree_k, n_events, event_batch, seed):
    import jax

    from adiabatic_raytracer.config import NumericsConfig, Scene, TreeConfig
    from adiabatic_raytracer.driver import run

    from adiabatic_raytracer import runtime

    auto = runtime.current_defaults()
    sc = Scene(mass_a=1e-5, ax_g=1e-12, theta_m=0.2, omega_pul=1.0, b0=1e14,
               r_ns=10.0, mass_ns=1.0)
    cfg = NumericsConfig(
        rtol=1e-7, atol=1e-6,
        compute_dtype=auto["compute_dtype"], engine=auto["engine"],
        tree_k=tree_k)
    tcfg = TreeConfig(prob_cutoff=1e-10, num_cutoff=50, mc_nodes=10,
                      max_nodes=100)
    os.makedirs(RESULTS, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="bench_overshoot_", dir=RESULTS)
    try:
        t0 = time.perf_counter()
        rows, _, stats = run(sc, cfg, tcfg, 1 + n_events, seed=seed,
                             save_mode=0, dir_tag=tmp,
                             event_batch=event_batch, verbose=False)
        dt = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    import numpy as np

    rows = np.asarray(rows)
    # tree_.npy schema (MainRunner.jl:670-729, 0-based): col 1 species,
    # col 7 sln_prob, col 8 weight
    is_ph = rows[:, 1] > 0.5
    w = rows[:, 8]
    pps = rows[:, 8] * rows[:, 7]
    return {
        "tree_k": tree_k,
        "rows": int(rows.shape[0]),
        "rows_per_event": round(rows.shape[0] / n_events, 4),
        "finals_per_event": round(stats.finals / n_events, 4),
        "nodes_per_event": round(stats.tot_nodes / n_events, 4),
        "tree_iters": int(stats.tree_iters),
        "info_hist": {str(k): int(v) for k, v in sorted(stats.info_hist.items())},
        "sum_w_photon": float(w[is_ph].sum()),
        "sum_w_axion": float(w[~is_ph].sum()),
        "sum_pps_photon": float(pps[is_ph].sum()),
        "sum_pps_axion": float(pps[~is_ph].sum()),
        "wall_s": round(dt, 2),
    }


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    n_events = int(os.environ.get("BENCH_EVENTS", "2048"))
    event_batch = int(os.environ.get("BENCH_EVENT_BATCH", "512"))
    seed = int(os.environ.get("BENCH_SEED", "1769"))
    n_events = ((n_events + event_batch - 1) // event_batch) * event_batch

    exact = _run(1, n_events, event_batch, seed)
    default = _run(0, n_events, event_batch, seed)
    rel = lambda a, b: round((a - b) / b, 4) if b else None
    print(json.dumps({
        "metric": "tree_cutoff_overshoot_ab",
        "events": n_events,
        "exact_per_node": exact,
        "default_batched": default,
        "delta_rel": {
            "rows_per_event": rel(default["rows_per_event"],
                                  exact["rows_per_event"]),
            "finals_per_event": rel(default["finals_per_event"],
                                    exact["finals_per_event"]),
            "nodes_per_event": rel(default["nodes_per_event"],
                                   exact["nodes_per_event"]),
            "sum_pps_photon": rel(default["sum_pps_photon"],
                                  exact["sum_pps_photon"]),
            "sum_pps_axion": rel(default["sum_pps_axion"],
                                 exact["sum_pps_axion"]),
        },
    }))


if __name__ == "__main__":
    sys.exit(main())
