#!/usr/bin/env python
"""End-to-end production-pipeline throughput: events/s through driver.run.

Times the COMPLETE per-event pipeline of the reference's main_runner_tree
(MainRunner.jl:450-747): conversion-surface sampling -> launch kinematics ->
axion backtrace -> forward branching tree -> row assembly -> npy write, for
each requested propagation engine, in one process.  By default it runs the
reference's production deployment (scripts/runner_example.sh: MassA 1e-5,
B0 1e14, ThetaM 0.2, probCutoff 1e-10, numCutoff 50, MCNodes 10, maxNodes
100, 6,000 events).

Each engine first runs one warm-up batch (compiles the sampler and the
pipeline at the production batch shape: reported as set-up), then the timed
run.  Rows of every engine after the first are compared with the first's
(same seed, same draws): equal row counts and weights within a tolerance
are reported, not asserted.  Prints one JSON line per engine.  Needs a GPU.

Usage:  python bench_pipeline.py [--events 6000] [--engines pool]
                                 [--default_cutoffs] [--event_batch N]
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

# scratch output stays inside the checkout (results/ is git-ignored)
RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=6000)
    ap.add_argument("--engines", default="pool")
    ap.add_argument("--event_batch", type=int, default=0,
                    help="0 = runtime.engine_defaults")
    ap.add_argument("--seed", type=int, default=1769)
    ap.add_argument("--default_cutoffs", action="store_true",
                    help="the reference's default cutoffs instead of the "
                         "production ones")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)

    from adiabatic_raytracer import runtime
    from adiabatic_raytracer.config import NumericsConfig, Scene, TreeConfig
    from adiabatic_raytracer.driver import run

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench_pipeline.py needs a GPU; JAX found "
                         f"{dev.platform!r}")
    runtime.setup_compile_cache()
    auto = runtime.engine_defaults(dev.platform)
    event_batch = args.event_batch or auto["event_batch"]
    tree_window = 128 if event_batch > 128 else 0

    sc = Scene(mass_a=1e-5, ax_g=1e-12, theta_m=0.2, omega_pul=1.0, b0=1e14,
               r_ns=10.0, mass_ns=1.0)
    if args.default_cutoffs:
        tcfg = TreeConfig()
    else:  # runner_example.sh
        tcfg = TreeConfig(prob_cutoff=1e-10, num_cutoff=50, mc_nodes=10,
                          max_nodes=100)

    ref = None
    for engine in args.engines.split(","):
        cfg = NumericsConfig(rtol=1e-7, atol=1e-6,
                             compute_dtype=auto["compute_dtype"],
                             engine=engine, tree_window=tree_window)
        os.makedirs(RESULTS, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix="bench_pipeline_", dir=RESULTS)
        try:
            t0 = time.perf_counter()
            run(sc, cfg, tcfg, 1 + event_batch, seed=args.seed, save_mode=0,
                dir_tag=tmp, event_batch=event_batch, verbose=False)
            t_warm = time.perf_counter() - t0
            t0 = time.perf_counter()
            rows, _, stats = run(sc, cfg, tcfg, 1 + args.events,
                                 seed=args.seed, save_mode=0, dir_tag=tmp,
                                 event_batch=event_batch, verbose=False)
            dt = time.perf_counter() - t0
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        assert rows.ndim == 2 and rows.shape[1] == 13, rows.shape
        assert np.all(np.isfinite(rows[:, 8])), engine
        rec = {
            "metric": "pipeline_events_per_sec",
            "engine": engine,
            "value": args.events / dt,
            "unit": "events/s",
            "events": args.events,
            "wall_s": dt,
            "warmup_batch_s": t_warm,
            "event_batch": event_batch,
            "tree_window": tree_window,
            "cutoffs": ("default" if args.default_cutoffs else "production"),
            "rows": int(rows.shape[0]),
            "nodes": int(stats.tot_nodes),
            "tree_iters": int(stats.tree_iters),
            "t_sample": stats.t_sample, "t_pipeline": stats.t_pipeline,
            "t_fetch": stats.t_fetch, "t_rows": stats.t_rows,
            "t_issue": stats.t_issue, "t_sampd": stats.t_sampd,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
        }
        if ref is None:
            ref = (rows, engine)
        else:
            rec["vs"] = ref[1]
            rec["rows_equal_count"] = bool(rows.shape == ref[0].shape)
            if rows.shape == ref[0].shape:
                w, wr = rows[:, 8], ref[0][:, 8]
                rel = np.abs(w - wr) / np.maximum(np.abs(wr), 1e-300)
                rec["weight_rel_median"] = float(np.median(rel))
                rec["weight_rel_max"] = float(np.max(rel))
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    sys.exit(main())
