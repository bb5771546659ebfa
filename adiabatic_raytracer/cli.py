"""Command-line interface — flag-compatible with the reference
(`julia Gen_Samples.jl`, Gen_Samples.jl:15-134) plus run-time extras.

Usage:  python -m adiabatic_raytracer --MassA 1e-5 --Nts 100 ...
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="adiabatic_raytracer",
        description="JAX adiabatic axion-photon ray tracer",
    )
    # --- the reference's 21 flags (Gen_Samples.jl:18-131) ---
    p.add_argument("--ThetaM", type=float, default=0.0, help="misalignment angle in rad")
    p.add_argument("--Nts", type=int, default=100, help="number photon trajectories")
    p.add_argument("--ftag", type=str, default="", help="file tag")
    p.add_argument("--rotW", type=float, default=1.0, help="rotational freq NS in 1/s")
    p.add_argument("--MassA", type=float, default=1e-5, help="axion mass in eV")
    p.add_argument("--Axg", type=float, default=1e-12, help="coupling in 1/GeV")
    p.add_argument("--B0", type=float, default=1e14, help="surface magnetic field in G")
    p.add_argument("--run_RT", type=int, default=1, help="should we run ray tracer?")
    p.add_argument("--run_Combine", type=int, default=0, help="should we combine file runs")
    p.add_argument("--side_runs", type=int, default=0, help="how many runs do we combine?")
    p.add_argument("--combine_renumber", type=int, default=0,
                   help="combine mode: offset each shard's event ids by the "
                        "accumulated last id (the Combine_Files.py:22 "
                        "behavior; Julia keeps per-shard ids)")
    p.add_argument("--combine_allow_missing", type=int, default=0,
                   help="combine mode: merge whatever shards exist instead "
                        "of requiring all side_runs (Combine_Files.py:10-25)")
    p.add_argument("--rNS", type=float, default=10.0, help="radius NS in km")
    p.add_argument("--Mass_NS", type=float, default=1.0, help="Mass NS in solar masses")
    p.add_argument("--vNS_x", type=float, default=0.0, help="vel NS x in c")
    p.add_argument("--vNS_y", type=float, default=0.0, help="vel NS y in c")
    p.add_argument("--vNS_z", type=float, default=0.0, help="vel NS z in c")
    p.add_argument("--saveMode", type=int, default=0,
                   help="0: essentials npy; 1: more npy; 2: + clear text; 3: + full tree")
    p.add_argument("--probCutoff", type=float, default=1e-10)
    p.add_argument("--numCutoff", type=int, default=5)
    p.add_argument("--MCNodes", type=int, default=5)
    p.add_argument("--maxNodes", type=int, default=50)
    p.add_argument("--seed", type=int, default=-1, help="RNG seed; -1 = random")
    p.add_argument("--bndry_lyr", type=float, default=-1.0,
                   help="boundary-layer power-law index; negative disables")
    # --- run-time extras ---
    p.add_argument("--dir_tag", type=str, default="results")
    p.add_argument("--event_batch", type=int, default=0,
                   help="events propagated per vmapped batch; 0 = auto "
                        "(runtime.engine_defaults: 2000 on GPU, streamed "
                        "through a 128-event tree window; 16 on CPU)")
    p.add_argument("--tree_window", type=int, default=-1,
                   help="forward-tree streaming window (active events per "
                        "iteration; finished events refill from the batch); "
                        "-1 = auto (128 when event_batch > 128 on any "
                        "device), 0 = off")
    p.add_argument("--precision", choices=["f32", "f64"], default="f64")
    p.add_argument("--computeDtype", choices=["auto", "state", "f32"], default="auto",
                   help="physics-evaluation dtype; auto = the state dtype "
                        "(f64) on every platform")
    p.add_argument("--engine", choices=["auto", "pool", "pool_compact"],
                   default="auto",
                   help="tree propagation engine; auto = "
                        "runtime.engine_defaults for the platform; "
                        "pool_compact = pool with straggler-compacted "
                        "backtrace")
    p.add_argument("--platform", type=str, default=None,
                   help="override the JAX platform (cpu/gpu)")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard the event pipeline over an N-device mesh "
                        "(0/1 = single device); the on-device equivalent of "
                        "the reference's N-process fan-out")
    p.add_argument("--pipeline_depth", type=int, default=0,
                   help="dispatched-but-unassembled batches kept in flight; "
                        "0 = auto (2 on the GPU at saveMode<=1 so the finals "
                        "pack's transfer and row assembly hide under the "
                        "next batch's compute, 1 otherwise); results are "
                        "bit-identical across depths")
    p.add_argument("--checkpoint", action="store_true",
                   help="write a per-batch resume state (RNG key + event "
                        "counter + partial rows) next to the output npy")
    p.add_argument("--resume", action="store_true",
                   help="resume a killed run from its checkpoint")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a jax.profiler trace of the run here")
    p.add_argument("--coordinator", type=str, default=None,
                   help="multi-host: coordinator address host:port "
                        "(jax.distributed; the multi-host analogue of the "
                        "reference's SLURM fan-out, runner_GR_tasks.sh)")
    p.add_argument("--nprocs", type=int, default=None,
                   help="multi-host: total number of processes")
    p.add_argument("--procid", type=int, default=None,
                   help="multi-host: this process's index")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    if args.precision == "f64":
        import jax

        jax.config.update("jax_enable_x64", True)

    from adiabatic_raytracer import runtime
    from adiabatic_raytracer.config import NumericsConfig, Scene, TreeConfig
    from adiabatic_raytracer.driver import run
    from adiabatic_raytracer.utils.npyio import combine_files

    runtime.setup_compile_cache()

    # Fixed-parameter block promoted to config (Gen_Samples.jl:157-174)
    sc = Scene(
        mass_a=args.MassA, ax_g=args.Axg, theta_m=args.ThetaM,
        omega_pul=args.rotW, b0=args.B0, r_ns=args.rNS, mass_ns=args.Mass_NS,
        bndry_lyr=args.bndry_lyr, rho_dm=0.45,
        v_ns=(args.vNS_x, args.vNS_y, args.vNS_z),
        flat=False, isotropic=False, melrose=True,
    )
    import jax

    if args.coordinator is not None:
        from adiabatic_raytracer.parallel.mesh import init_distributed

        init_distributed(args.coordinator, args.nprocs, args.procid)
        print(f"distributed: process {jax.process_index()}/"
              f"{jax.process_count()}, {len(jax.devices())} global devices")

    auto = runtime.current_defaults()
    compute_dtype = (auto["compute_dtype"] if args.computeDtype == "auto"
                     else args.computeDtype)
    engine = auto["engine"] if args.engine == "auto" else args.engine
    if args.event_batch <= 0:
        args.event_batch = auto["event_batch"]
    if args.tree_window < 0:
        # auto: window the forward tree at 128 active events whenever the
        # batch is bigger (finished events' window lanes refill immediately
        # instead of the batch draining at ~1-event occupancy;
        # NumericsConfig.tree_window).  Outputs are bitwise identical across
        # windows at fixed K, so this is schedule-only tuning.
        args.tree_window = 128 if args.event_batch > 128 else 0
    cfg = NumericsConfig(atol=1e-6, rtol=1e-7, compute_dtype=compute_dtype,
                         engine=engine, tree_window=args.tree_window)
    tcfg = TreeConfig(prob_cutoff=args.probCutoff, num_cutoff=args.numCutoff,
                      mc_nodes=args.MCNodes, max_nodes=args.maxNodes)

    print(f"Axion parameters: {args.MassA}\n{args.Axg}")
    t0 = time.time()

    if args.run_RT == 1:
        for sub in ("npy", "event", "tree"):
            os.makedirs(os.path.join(args.dir_tag, sub), exist_ok=True)
        run(sc, cfg, tcfg, args.Nts, seed=args.seed, save_mode=args.saveMode,
            file_tag=args.ftag, dir_tag=args.dir_tag,
            event_batch=args.event_batch, mesh_devices=args.mesh,
            checkpoint=args.checkpoint, resume=args.resume,
            profile_dir=args.profile_dir,
            pipeline_depth=args.pipeline_depth)

    if args.run_Combine == 1:
        out = combine_files(args.dir_tag, args.MassA, args.Axg, args.ThetaM,
                            args.rotW, args.B0, args.Nts, 3, args.numCutoff,
                            args.MCNodes, args.maxNodes, args.ftag,
                            args.side_runs,
                            renumber_events=bool(args.combine_renumber),
                            allow_missing=bool(args.combine_allow_missing))
        print(f"combined -> {out}")

    print(f"\ntime diff: {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
