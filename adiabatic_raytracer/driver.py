"""Top-level driver: the batched `main_runner_tree` (MainRunner.jl:355-765).

Per batch of events the pipeline is: conversion-surface sampling -> launch
kinematics and importance weights -> axion backtrace -> forward photon tree ->
row assembly.  Everything up to row assembly runs as jitted, vmapped JAX; row
assembly and file writing are host-side numpy (cold path).

Sampling-attempt accounting reproduces the reference's f_inx bookkeeping
(MainRunner.jl:401,469-477,711-713,749): f_inx = (sampler failures before each
kept success) + (number of final photons), and the sln_prob column of the
output is divided by it at the end.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from adiabatic_raytracer import runtime
from adiabatic_raytracer.config import NumericsConfig, Scene, TreeConfig
from adiabatic_raytracer.constants import C_KM, G_NEW
from adiabatic_raytracer.models.magnetosphere import conversion_surface_radius
from adiabatic_raytracer.ops import sampler, tree
from adiabatic_raytracer.ops.conversion import dwp_ds, g_det, jacobian_fv
from adiabatic_raytracer.ops.dispersion import k_norm_cart, k_sphere
from adiabatic_raytracer.ops.geometry import cart_to_sph
from adiabatic_raytracer.utils.npyio import save_npy, tree_filename
from adiabatic_raytracer.utils.textio import EventFiles, TreeFile

N_COLS = {0: 13, 1: 29}


@dataclass
class RunStats:
    seed: int = 0
    events: int = 0
    finals: int = 0
    sample_attempts: int = 0
    f_inx: int = 0
    tot_nodes: int = 0
    tree_iters: int = 0  # total work-queue iterations (tree.TreeResult.n_iters)
    info_hist: dict = field(default_factory=dict)
    dw_warnings: int = 0
    wall_time: float = 0.0
    # stage wall-times (s): sampling, device pipeline, device->host fetch,
    # host row assembly, clear-text writers
    t_sample: float = 0.0
    t_pipeline: float = 0.0
    t_fetch: float = 0.0
    t_rows: float = 0.0
    t_text: float = 0.0
    # host-blocked dispatch segments (s): issue_batch (arg upload + pipeline
    # dispatch) and sample_dispatch (sampler dispatch) — the host-loop
    # costs the stage timers above miss
    t_issue: float = 0.0
    t_sampd: float = 0.0
    # NS-velocity spherical decomposition (mag, theta, phi), computed-but-
    # unused in the reference as well (MainRunner.jl:418-421)
    vns: tuple = (0.0, 0.0, 0.0)


def sln_scale(sc: Scene, maxR, tcfg: TreeConfig) -> float:
    """Host-side scalar factor of the event weight sln_prob
    (MainRunner.jl:552-558 unit factors): 2*pi*maxR^2 * rho_dm*1e9/mass_a
    * (1e5)^2 * c[km/s] * 1e5 * n_max_sample, magnitude ~1e36-1e42.

    This never goes on device: full sln_prob exceeds f32 max (3.4e38), so
    any f32 copy of it (the f32 compute path, f32 packs) would overflow.
    _event_kinematics therefore returns the O(1e2) per-event factor
    (sln_base); rows and spectra multiply by this scalar in host f64
    (driver.assemble, analysis.flux)."""
    return (2.0 * math.pi * float(maxR) ** 2
            * float(sc.rho_dm) * 1e9 / float(sc.mass_a)
            * (1e5 ** 2) * C_KM * 1e5 * float(tcfg.n_max_sample))


def _event_kinematics(xpos, v_loc, erg_inf, maxR, sc: Scene, tcfg: TreeConfig,
                      compute_dtype: str = "state"):
    """Launch momentum and the per-event weight factor (MainRunner.jl:498-558).

    Returns (k_init, sln_base, cos_w, jac_v) where sln_base =
    |cos_w| * redshift * dense_extra * jac_gr — the per-event, O(1e2) part
    of the reference's sln_prob; the full weight is
    sln_base * sln_scale(sc, maxR, tcfg), assembled in HOST f64 (the scalar
    part is ~1e36-1e42, past the f32 range — see sln_scale).

    compute_dtype="f32": evaluate in f32 with f64 in/outputs."""
    out_dtype = xpos.dtype
    if compute_dtype == "f32":
        from adiabatic_raytracer.ops.propagate import _cast_tree

        sc = _cast_tree(sc, jnp.float32)
        xpos = xpos.astype(jnp.float32)
        v_loc = v_loc.astype(jnp.float32)
        erg_inf = erg_inf.astype(jnp.float32)
    E = xpos.shape[0]
    rmag = jnp.linalg.norm(xpos, axis=1)
    k_init = k_norm_cart(xpos, v_loc, 0.0, erg_inf, sc, sc.mass_ns,
                         is_photon=True, ax_fix=True, flat=sc.flat)
    ksphere = jax.vmap(lambda x, k: k_sphere(x, k, sc.mass_ns, flat=sc.flat))(
        xpos, k_init)
    erg_ax = erg_inf / jnp.sqrt(1.0 - 2.0 * G_NEW * sc.mass_ns / rmag / C_KM**2)
    bundle = jax.vmap(
        lambda x, k, w: dwp_ds(x, k, 0.0, w, sc, sc.mass_ns, flat=sc.flat,
                               bndry_lyr=sc.bndry_lyr)
    )(xpos, ksphere, erg_ax)
    cos_w = bundle[3]
    x_sph = cart_to_sph(xpos)
    jac_gr = jax.vmap(
        lambda x: g_det(x, 0.0, sc, sc.mass_ns, flat=sc.flat, bndry_lyr=sc.bndry_lyr)
    )(x_sph)
    jac_v = jax.vmap(lambda x, v: jacobian_fv(x, v, mass_ns=1.0))(xpos, v_loc)

    dense_extra = 2.0 / jnp.sqrt(jnp.pi) * (1.0 / (220.0 / C_KM)) * jnp.sqrt(
        2.0 * sc.mass_ns * G_NEW / C_KM**2 / rmag)
    redshift = jnp.sqrt(1.0 - 2.0 * G_NEW * sc.mass_ns / rmag / C_KM**2)
    # per-event factor only — the ~1e36-1e42 scalar part (sln_scale) stays
    # on the host (see sln_scale)
    sln_base = jnp.abs(cos_w) * redshift * dense_extra * jac_gr
    return (k_init.astype(out_dtype), sln_base.astype(out_dtype),
            cos_w.astype(out_dtype), jac_v.astype(out_dtype))


@functools.lru_cache(maxsize=8)
def _build_sampler(sc: Scene, cfg: NumericsConfig, maxR, n_grid, n_max,
                   flat_sampling: bool = True, cap: int = 512):
    """Jitted conversion-surface sampler, cached across run() calls so a
    warmup run compiles for the production run (configs are frozen
    dataclasses, hence hashable).

    The successes are COMPACTED ON DEVICE: of the b oversampled draws, only
    the first min(cap, b) successes (in draw order, selected with the
    masked-iota top_k trick, which keeps a static shape) are shipped to the
    host, as ONE [min(cap,b)+1, 11] array of rows (pos_in_chunk, xpos,
    v_loc, erg_inf, v_ifty) with the total success count in the trailer
    row.  The host loop's RNG stream, succ_rate adaptation, and f_inx
    attempt accounting are bit-identical to fetching the full chunk — only
    the fetched bytes shrink (~8x at the default occupancy)."""

    def packed(k, b):
        res = sampler.sample_batch(k, b, maxR, sc, sc.mass_ns,
                                   n_grid=n_grid, n_max=n_max,
                                   flat_sampling=flat_sampling,
                                   compute_dtype=cfg.compute_dtype)
        d = res.xpos.dtype
        rows = jnp.concatenate([
            jnp.arange(b, dtype=d)[:, None], res.xpos, res.v_loc,
            res.erg_inf.astype(d)[:, None], res.v_ifty.astype(d)], axis=1)
        kk = min(cap, b)
        selkey = jnp.where(res.success, -jnp.arange(b, dtype=jnp.float32),
                           jnp.float32(-2.0 * b))
        _, sel = jax.lax.top_k(selkey, kk)     # first kk successes, in order
        n_succ = jnp.sum(res.success).astype(d)
        trailer = jnp.zeros((1, 11), d).at[0, 0].set(n_succ)
        return jnp.concatenate([rows[sel], trailer], axis=0)

    return jax.jit(packed, static_argnums=1)


@functools.lru_cache(maxsize=8)
def _build_pipeline(sc: Scene, cfg: NumericsConfig, tcfg: TreeConfig, maxR,
                    lnt_end, mesh_devices: int):
    """Jitted per-batch event pipeline (kinematics -> backtrace -> forward
    tree), optionally sharded over an event-axis device mesh; cached across
    run() calls.

    cfg.engine == "pool_compact" (single device only) runs the backtrace
    propagation through the host-orchestrated straggler-compaction wrapper
    (ops/streaming.CompactedPropagator) and everything else through the
    jitted pool path."""
    compact_bt = cfg.engine == "pool_compact" and mesh_devices <= 1
    if cfg.engine == "pool_compact":
        import dataclasses

        cfg = dataclasses.replace(cfg, engine="pool")

    def pipeline(keys, xpos, v_loc, erg_inf, bt_res=None):
        k_init, sln_prob, cos_w, jac_v = _event_kinematics(
            xpos, v_loc, erg_inf, maxR, sc, tcfg, cfg.compute_dtype)
        if bt_res is None:
            bt = tree.backtrace(xpos, k_init, erg_inf, sc, cfg, tcfg,
                                lnt_end=lnt_end)
        else:
            bt = tree.backtrace_from_result(xpos, -k_init, erg_inf, bt_res,
                                            sc, cfg)
        tr = tree.forward_tree(keys, xpos, k_init, erg_inf, sc, cfg, tcfg,
                               lnt_end=lnt_end)
        # pack everything the saveMode<=1 row assembly needs into ONE array
        # so the host does ONE device fetch per batch, not ~45; the final
        # nodes are compacted GLOBALLY on device ([cap+1, 14] instead of the
        # worst-case per-event [E, F, 14] — ~25x fewer bytes at production
        # cutoffs), in f32 on the f32-physics path, with the 12 per-event
        # columns appended below the finals pack (padded to 14)
        d = xpos.dtype
        pack_dtype = jnp.float32 if cfg.compute_dtype == "f32" else d
        one = lambda a: a.astype(pack_dtype)[..., None]
        fin_pack = tree.compact_finals_global(
            tr.pools, cfg.finals_cap_per_event * xpos.shape[0],
            out_dtype=pack_dtype, order_stride=2 * tcfg.max_nodes + 4)
        ev_pack = jnp.concatenate([
            sln_prob.astype(pack_dtype)[:, None],
            cos_w.astype(pack_dtype)[:, None], one(tr.count), one(tr.info),
            one(tr.dw_anomalies), bt.samp_back_weight.astype(pack_dtype)[:, None],
            bt.prob0.astype(pack_dtype)[:, None], one(bt.c_bck),
            k_init.astype(pack_dtype), one(tr.n_iters),
            jnp.zeros((xpos.shape[0], 2), pack_dtype)], axis=1)  # [E, 14]
        combo = jnp.concatenate([fin_pack, ev_pack], axis=0)
        return combo, bt, tr

    if mesh_devices > 1:
        from adiabatic_raytracer.parallel.mesh import make_mesh, shard_over_events

        mesh = make_mesh(mesh_devices)
        return jax.jit(shard_over_events(mesh, pipeline))
    if not compact_bt:
        return jax.jit(pipeline)

    # pool_compact: kinematics jitted, backtrace propagation through the
    # chunked straggler-compaction engine, remainder jitted
    import dataclasses as _dc

    from adiabatic_raytracer.ops.streaming import CompactedPropagator

    kin_jit = jax.jit(lambda x, v, e: _event_kinematics(
        x, v, e, maxR, sc, tcfg, cfg.compute_dtype))
    sc_b = _dc.replace(sc, b0=-sc.b0)
    cp = CompactedPropagator(sc_b, cfg, species="axion")
    rest_jit = jax.jit(pipeline)

    def compact_pipeline(keys, xpos, v_loc, erg_inf):
        E = xpos.shape[0]
        k_init = kin_jit(xpos, v_loc, erg_inf)[0]
        bt_res = cp.run(
            xpos, -k_init, erg_inf, -jnp.ones(E, xpos.dtype),
            jnp.full(E, cfg.ln_t_start, xpos.dtype),
            jnp.full(E, lnt_end, xpos.dtype),
            jnp.zeros(E, bool), jnp.full(E, cfg.max_crossings, jnp.int32))
        return rest_jit(keys, xpos, v_loc, erg_inf, bt_res)

    return compact_pipeline


_keys_for = jax.jit(jax.vmap(jax.random.fold_in, in_axes=(None, 0)))


def vns_spherical(v_ns):
    """Spherical decomposition of the NS velocity (MainRunner.jl:418-421).
    Dead in the reference's production path too (its only consumer, the
    vIfty shift at MainRunner.jl:497, is commented out) — provided for API
    parity.  Returns (mag, theta, phi); theta/phi are 0 for a static NS."""
    v = np.asarray(v_ns, np.float64)
    mag = float(np.sqrt(np.sum(v**2)))
    if mag > 0:
        return mag, float(np.arccos(v[2] / mag)), float(np.arctan2(v[1], v[0]))
    return mag, 0.0, 0.0


def _ckpt_paths(out_path: str):
    d, base = os.path.split(out_path)
    return (os.path.join(d, f".ckpt_{base}.json"),
            os.path.join(d, f".ckpt_{base}.partial.npy"))


def _write_checkpoint(out_path: str, key, succ_rate, event_no, remaining,
                      stats: RunStats, rows):
    """Per-shard resume state: RNG key + event counter + accounting
    (SURVEY.md §5 failure-recovery rebuild note).  The partial rows matrix
    rides a sibling .npy; a killed run resumes exactly (same RNG stream)."""
    jpath, npath = _ckpt_paths(out_path)
    os.makedirs(os.path.dirname(jpath) or ".", exist_ok=True)
    if rows:
        np.save(npath, np.concatenate(rows, axis=0))
    state = {
        "key": np.asarray(key).tolist(),
        "succ_rate": succ_rate,
        "event_no": event_no,
        "remaining": remaining,
        "stats": {k: v for k, v in dataclasses.asdict(stats).items()
                  if k != "info_hist"},
        "info_hist": {str(k): v for k, v in stats.info_hist.items()},
        "has_rows": bool(rows),
    }
    with open(jpath + ".tmp", "w") as f:
        json.dump(state, f)
    os.replace(jpath + ".tmp", jpath)


def _load_checkpoint(out_path: str):
    jpath, npath = _ckpt_paths(out_path)
    if not os.path.exists(jpath):
        return None
    with open(jpath) as f:
        state = json.load(f)
    rows = [np.load(npath)] if state.get("has_rows") and os.path.exists(npath) else []
    return state, rows


def _clear_checkpoint(out_path: str):
    for p in _ckpt_paths(out_path):
        if os.path.exists(p):
            os.remove(p)


def run(sc: Scene, cfg: NumericsConfig, tcfg: TreeConfig, n_trajs: int, *,
        seed: int = -1, save_mode: int = 0, file_tag: str = "",
        dir_tag: str = "results", event_batch: int = 16,
        fix_time: float = 0.0, ntimes: int = 3,
        verbose: bool = True, mesh_devices: int = 0,
        checkpoint: bool = False, resume: bool = False,
        max_batches: Optional[int] = None,
        profile_dir: Optional[str] = None,
        pipeline_depth: int = 0) -> Optional[tuple]:
    """Run the full pipeline; returns (saveAll rows ndarray, output path, stats).

    mesh_devices > 1 shards the jitted pipeline (kinematics -> backtrace ->
    forward tree) over the event axis of an n-device mesh — the on-device
    equivalent of the reference's N-process fan-out (runner_example.sh:4-9).
    Per-event RNG keys are derived from the *global* event number, so a
    sharded run produces the same rows as a single-device run at the same
    seed and batching.

    checkpoint=True writes a per-shard resume state (RNG key, event counter,
    accounting, partial rows) next to the output file after every batch;
    resume=True continues a killed run from that state with the identical RNG
    stream (SURVEY.md §5 failure-recovery note).  max_batches stops early
    (checkpoint left in place; the final npy with its f_inx normalization is
    only written on completion).  profile_dir enables a jax.profiler trace of
    the run (the reference's wall-clock instrumentation, upgraded).

    pipeline_depth: number of dispatched-but-unassembled batches kept in
    flight (0 = auto: runtime.engine_defaults at saveMode <= 1, else 1).
    Depth 2 gives each batch a FULL extra batch of device time between
    dispatch and collection, so its finals pack copies to the host
    (copy_to_host_async) while the host samples, dispatches and assembles.
    Results are bit-identical to depth 1 — only the host<->device schedule
    changes.

    Returns None when the conversion surface lies inside the star
    (MainRunner.jl:389-396)."""
    t_run0 = time.time()
    stats = RunStats()
    if seed < 0:
        stats.seed = int(np.random.randint(0, 100000001))
    elif seed == 0:
        stats.seed = int(np.random.SeedSequence().entropy % (2**31))
    else:
        stats.seed = seed

    maxR = float(conversion_surface_radius(sc.mass_a, sc.theta_m, sc.omega_pul,
                                           sc.b0, sc.r_ns, t_in=fix_time))
    if maxR < float(sc.r_ns):
        print("Too small Max R.... quitting....")
        return None

    lnt_end = float(np.log(1.0 / float(sc.omega_pul)))
    n_grid = sampler.default_n_grid(maxR)
    n_max = tcfg.n_max_sample
    out_path = tree_filename(dir_tag, sc.mass_a, sc.ax_g, sc.theta_m, sc.omega_pul,
                             sc.b0, n_trajs, ntimes, tcfg.num_cutoff,
                             tcfg.mc_nodes, tcfg.max_nodes, file_tag)

    rows: list = []
    event_no = 1
    remaining = n_trajs - 1  # the reference loop runs while photon_trajs < Ntajs
    succ_rate = 0.25  # adaptive sampler-success estimate
    key = jax.random.PRNGKey(stats.seed)

    ck = _load_checkpoint(out_path) if resume else None
    if ck is not None:
        state, rows = ck
        key = jnp.asarray(np.array(state["key"], np.uint32))
        succ_rate = state["succ_rate"]
        event_no = state["event_no"]
        remaining = state["remaining"]
        for k, v in state["stats"].items():
            setattr(stats, k, v)
        stats.info_hist = {int(k): v for k, v in state["info_hist"].items()}
        if verbose:
            print(f"Resuming at event {event_no} ({remaining} remaining)")
    if verbose:
        print(f"Using seed {stats.seed}")

    sample_jit = _build_sampler(sc, cfg, maxR, n_grid, n_max,
                                tcfg.flat_sampling, cap=int(event_batch))
    pipeline_jit = _build_pipeline(sc, cfg, tcfg, maxR, lnt_end,
                                   int(mesh_devices or 0))
    pad_to = mesh_devices if mesh_devices and mesh_devices > 1 else 1
    base_key = jax.random.PRNGKey(stats.seed)
    stats.vns = vns_spherical(sc.v_ns)

    ev_files = (EventFiles(dir_tag, file_tag, append=ck is not None)
                if save_mode > 1 else None)

    if profile_dir:
        jax.profiler.start_trace(profile_dir)

    # --- software-pipelined batch loop with ASYNC sampling ---
    # Two overlaps are in play on the single device stream:
    #   * batch i+1's pipeline is DISPATCHED before batch i's outputs are
    #     fetched/assembled (the fetch and host row assembly ride under the
    #     next batch's device compute), and
    #   * batch i+1's PRIMARY sampler chunk is dispatched BEFORE batch i's
    #     pipeline, so by collect time it has already run in the gap after
    #     the previous pipeline — the sampler's device work and its fetch
    #     never stall behind a long tree launch (they did when sampling ran
    #     strictly between pipeline dispatches).
    # RNG: each batch consumes ONE split of the carried key; chunk j of the
    # batch draws from fold_in(batch_key, j), so the draw stream is
    # independent of how dispatches interleave.  A checkpoint written after
    # assembling batch i stores the (key, succ_rate) snapshot taken right
    # after batch i's collect — exactly the state batch i+1's dispatch
    # consumed — so a resumed run reproduces the stream bit-for-bit.
    batches_done = 0
    batches_issued = 0
    issue_event_no = event_no
    issue_remaining = remaining

    def sample_dispatch():
        """Split a batch key and dispatch the primary oversampled chunk."""
        nonlocal key
        t_sd0 = time.time()
        key, bkey = jax.random.split(key)
        sb = 1 << max(int(event_batch / max(succ_rate, 0.02) * 1.5) - 1,
                      7).bit_length()
        handle = sample_jit(jax.random.fold_in(bkey, 0), sb)
        # enqueue the device->host copy behind the sampler compute, so by
        # sample_collect time the pack is already on the host
        handle.copy_to_host_async()
        stats.t_sampd += time.time() - t_sd0
        return {"bkey": bkey, "sb": sb, "handle": handle}

    def sample_collect(s, batch):
        """Fetch the primary chunk; top up synchronously on shortfall."""
        nonlocal succ_rate
        t_s0 = time.time()
        xs, kept_pos = [], []
        got = 0
        chunk_off = 0
        j = 0
        handle, sb = s["handle"], s["sb"]
        while True:
            pk = np.asarray(handle)                     # ONE small fetch
            n_succ = int(pk[-1, 0])
            succ_rate = max(0.5 * succ_rate + 0.5 * n_succ / sb, 0.02)
            take = min(n_succ, batch - got)
            xs.append(pk[:take, 1:])
            # int64 before the offset add: under --precision f32 the packed
            # positions arrive as float32 and chunk_off past 2^24 would
            # corrupt the attempt indices (and with them f_inx)
            kept_pos.append(chunk_off + pk[:take, 0].astype(np.int64))
            chunk_off += sb
            got += take
            if got >= batch:
                break
            if chunk_off > 8_000_000 and got * 1_000_000 < chunk_off:
                # the reference's sampling loop (MainRunner.jl:463-494) spins
                # forever on a scene whose conversion surface is (nearly)
                # unreachable; fail loudly once the yield drops below one
                # success per million draws
                raise RuntimeError(
                    f"conversion-surface sampler produced {got} valid events "
                    f"in {chunk_off} draws — check the scene parameters "
                    f"(mass_a/B0/omega_pul place the surface at maxR={maxR:.3g})")
            j += 1
            need = batch - got
            sb = 1 << max(int(need / max(succ_rate, 0.02) * 1.3) - 1,
                          7).bit_length()
            handle = sample_jit(jax.random.fold_in(s["bkey"], j), sb)
        attempts = int(np.concatenate(kept_pos)[batch - 1]) + 1
        # integration state stays f64 even when the sampler computed in f32
        samp = np.concatenate(xs, axis=0).astype(np.float64)
        return samp, attempts, time.time() - t_s0

    def issue_batch(samp, batch, attempts, t_sample, rng_snap):
        """Dispatch the device pipeline for a collected sample batch."""
        nonlocal issue_event_no, issue_remaining, batches_issued
        xpos, v_loc, erg_inf, v_ifty = (samp[:, 0:3], samp[:, 3:6],
                                        samp[:, 6], samp[:, 7:10])

        # pad the batch up to a mesh-divisible size (outputs discarded);
        # RNG keys come from the *global* event number -> mesh-invariant
        bp = ((batch + pad_to - 1) // pad_to) * pad_to
        gidx = np.arange(bp, dtype=np.int64) + issue_event_no

        def pad(a):
            if bp == batch:
                return a
            reps = [a[-1:]] * (bp - batch)
            return np.concatenate([a] + reps, axis=0)

        t_d0 = time.time()
        keys = _keys_for(base_key, jnp.asarray(gidx))
        handles = pipeline_jit(
            keys, jnp.asarray(pad(xpos)), jnp.asarray(pad(v_loc)),
            jnp.asarray(pad(erg_inf)))
        # the result pack's host copy starts once the batch has aged one
        # iteration (see the loop below), not at dispatch
        rec = {
            "batch": batch, "event_no": issue_event_no, "handles": handles,
            "xpos": xpos, "v_ifty": v_ifty, "attempts": attempts,
            "t_sample": t_sample, "t_dispatch": t_d0,
            # resume state as of the end of this batch's sampling
            "rng_after": rng_snap,
        }
        issue_event_no += batch
        issue_remaining -= batch
        batches_issued += 1
        stats.t_issue += time.time() - t_d0
        return rec

    def assemble(rec, overlap_s=0.0):
        """Fetch one in-flight batch, assemble its rows, write text streams,
        apply its (deferred) sampling accounting, checkpoint.  overlap_s:
        host time spent sampling the NEXT batch between this batch's dispatch
        and now — subtracted so t_pipeline / the event-file per-event time
        measure this batch's pipeline, not the pipelined host work."""
        nonlocal event_no, remaining, batches_done
        batch = rec["batch"]
        xpos, v_ifty = rec["xpos"], rec["v_ifty"]
        assert rec["event_no"] == event_no
        stats.sample_attempts += rec["attempts"]
        stats.f_inx += rec["attempts"] - batch  # failures (MainRunner.jl:469,477)
        stats.t_sample += rec["t_sample"]

        combo, bt, tr = rec["handles"]
        jax.block_until_ready(combo)
        t_f0 = time.time()
        stats.t_pipeline += max(t_f0 - rec["t_dispatch"] - overlap_s, 0.0)
        fp = np.asarray(combo)  # [(n_sh)*(cap_l+1+shard_e), 14], ONE fetch
        stats.t_fetch += time.time() - t_f0
        t_batch = max(time.time() - rec["t_dispatch"] - overlap_s, 0.0)

        t_r0 = time.time()
        # decode the combined pack: under a mesh each shard contributes its
        # own [cap_l+1+shard_e, 14] block — a [cap_l+1, 14] finals pack
        # (tree.compact_finals_global, LOCAL event indices, trailer count at
        # row cap_l) followed by shard_e per-event rows (12 cols + 2 pad)
        n_sh = mesh_devices if mesh_devices and mesh_devices > 1 else 1
        bp = ((batch + pad_to - 1) // pad_to) * pad_to
        shard_e = bp // n_sh
        blocks = fp.reshape(n_sh, -1, 14)
        cap_l = blocks.shape[1] - 1 - shard_e
        fins, evs = [], []
        for s in range(n_sh):
            blk = blocks[s]
            cnt = int(blk[cap_l, 0])
            if cnt > cap_l:
                raise RuntimeError(
                    f"finals pack overflow: {cnt} finals exceed the "
                    f"{cap_l}-row capacity — raise "
                    "NumericsConfig.finals_cap_per_event")
            b = np.array(blk[:cnt], np.float64)  # copy: fp view is read-only
            b[:, 0] += s * shard_e
            fins.append(b)
            evs.append(blk[cap_l + 1:, :12])
        fin = np.concatenate(fins, axis=0)
        evp = np.concatenate(evs, axis=0)[:batch]       # [E, 12]
        fin = fin[fin[:, 0] < batch]        # drop mesh-padding duplicates
        # full event weight: the device ships the O(1e2) per-event factor;
        # the ~1e36-1e42 scalar part multiplies in host f64 (see sln_scale).
        # The f64 cast is load-bearing: evp arrives f32 on the f32 compute
        # path, and NumPy-2 weak-scalar promotion keeps f32_array *
        # python_float in f32, which overflows to inf at this magnitude.
        sln_np = evp[:, 0].astype(np.float64) * sln_scale(sc, maxR, tcfg)
        cosw_np = evp[:, 1]
        count_np = evp[:, 2].astype(np.int64)
        info_np = evp[:, 3].astype(np.int64)
        dw_anom_np = evp[:, 4].astype(np.int64)
        sbw_ev = evp[:, 5]
        bt_prob0 = evp[:, 6]
        bt_c_bck = evp[:, 7].astype(np.int64)
        k_init_np = evp[:, 8:11]
        # replicated per event within a shard; under shard_map each shard runs
        # its own while loop, so aggregate across events (= max over shards)
        stats.tree_iters += int(evp[:, 11].max())

        # --- vectorized row assembly (MainRunner.jl:670-729) ---
        xpos_np = xpos
        vel_eng = np.sum(v_ifty**2, axis=1) / 2.0
        stats.tot_nodes += int(count_np.sum())
        stats.dw_warnings += int(dw_anom_np.sum())
        for iv, cnt in zip(*np.unique(info_np, return_counts=True)):
            stats.info_hist[int(iv)] = stats.info_hist.get(int(iv), 0) + int(cnt)

        # finals arrive globally compacted and (event, processing-order)-
        # sorted from the device (tree.compact_finals_global)
        e_ids = fin[:, 0].astype(np.int64)
        nfin = len(e_ids)
        species_id = fin[:, 1]
        ferg_f = fin[:, 2]
        weight_f = fin[:, 3]
        prob_f = fin[:, 4]
        prob_conv_f = fin[:, 5]
        prob_conv0_f = fin[:, 6]
        t_f = fin[:, 7]
        fpos = fin[:, 8:11]
        fmom = fin[:, 11:14]
        absf = np.linalg.norm(fmom, axis=1)
        absfx = np.linalg.norm(fpos, axis=1)
        phi_f = np.arctan2(fmom[:, 1], fmom[:, 0])
        phi_fx = np.arctan2(fpos[:, 1], fpos[:, 0])
        theta_f = np.arccos(fmom[:, 2] / absf)
        theta_fx = np.arccos(fpos[:, 2] / absfx)
        sbw = sbw_ev[e_ids]
        weight = weight_f * sbw                          # MainRunner.jl:686
        optical_depth = np.zeros(nfin)
        weight_c = np.ones(nfin)
        weight_tmp = weight * (weight_c**2 * np.exp(-optical_depth))
        dw_out = ferg_f / float(sc.mass_a) + vel_eng[e_ids]
        ev_col = (event_no + e_ids).astype(np.float64)
        base = np.stack([
            ev_col, species_id, theta_f, phi_f, theta_fx, phi_fx, absfx,
            sln_np[e_ids], weight_tmp, xpos_np[e_ids, 0], xpos_np[e_ids, 1],
            xpos_np[e_ids, 2], dw_out], axis=1)
        if save_mode > 0:
            extra = np.stack([
                weight, optical_depth, weight_c,
                k_init_np[e_ids, 0], k_init_np[e_ids, 1], k_init_np[e_ids, 2],
                cosw_np[e_ids], count_np[e_ids].astype(np.float64),
                info_np[e_ids].astype(np.float64),
                prob_f, prob_conv_f, prob_conv0_f, sbw, absfx,
                bt_c_bck[e_ids].astype(np.float64), bt_prob0[e_ids]],
                axis=1)
            base = np.concatenate([base, extra], axis=1)
        if nfin:
            rows.append(base)
        stats.f_inx += int((species_id == 1).sum())  # MainRunner.jl:711-713
        stats.finals += nfin
        stats.t_rows += time.time() - t_r0

        # --- clear-text writers (saveMode >= 2; cold path: fetches the full
        # pools/backtrace pytrees) ---
        if save_mode > 1:
            t_t0 = time.time()
            sl = lambda t: jax.tree_util.tree_map(
                lambda a: np.asarray(a)[:batch], t)
            pools = sl(tr.pools)
            bt_np = sl(bt)
            fstart = np.searchsorted(e_ids, np.arange(batch))
            fend = np.searchsorted(e_ids, np.arange(batch), side="right")
            for e in range(batch):
                en = event_no + e
                # incoming-axion state = backtrace trajectory endpoint
                # (nb.x[end], nb.kx[end], MainRunner.jl:600-607)
                ev_files.write_event_head(
                    en, v_ifty[e], float(sln_np[e]),
                    bt_np.x_end[e], bt_np.k_end[e], xpos_np[e], k_init_np[e])
                if save_mode > 2:
                    tree_f = TreeFile(dir_tag, file_tag, en)
                    nraw = int(bt_np.raw_n_cross[e])
                    tree_f.save_node(
                        "axion", float(bt_np.weight[e]), float(bt_np.prob0[e]), 1.0,
                        xc=bt_np.xc[e, :nraw, 0] if nraw else None,
                        yc=bt_np.xc[e, :nraw, 1] if nraw else None,
                        zc=bt_np.xc[e, :nraw, 2] if nraw else None,
                        tc=bt_np.raw_tc[e, :nraw] if nraw else None,
                        traj=bt_np.traj[e], times=bt_np.times[e],
                    )
                    order = pools.order[e]
                    proc = np.nonzero(pools.status[e] == 2)[0]
                    proc = proc[np.argsort(order[proc], kind="stable")]
                    for p in proc:
                        hasx = bool(pools.has_cross[e, p])
                        tree_f.save_node(
                            "photon" if pools.is_photon[e, p] else "axion",
                            float(pools.weight[e, p]), float(pools.prob[e, p]),
                            float(pools.parent_weight[e, p]),
                            xc=[pools.xc[e, p, 0]] if hasx else None,
                            yc=[pools.xc[e, p, 1]] if hasx else None,
                            zc=[pools.xc[e, p, 2]] if hasx else None,
                            tc=[pools.tcx[e, p]] if hasx else None,
                            traj=pools.traj[e, p], times=pools.times[e, p],
                        )
                    tree_f.close()
                for j in range(fstart[e], fend[e]):
                    ev_files.write_final(
                        en, float(weight[j]), int(species_id[j]),
                        float(theta_f[j]), float(phi_f[j]), float(absf[j]),
                        float(theta_fx[j]), float(phi_fx[j]), float(absfx[j]),
                        float(t_f[j]))
                ev_files.write_event_tail(t_batch / batch, int(count_np[e]))
            stats.t_text += time.time() - t_t0

        event_no += batch
        stats.events += batch
        remaining -= batch
        batches_done += 1
        if checkpoint:
            ck_key, ck_rate = rec["rng_after"]
            _write_checkpoint(out_path, ck_key, ck_rate, event_no, remaining,
                              stats, rows)

    from collections import deque

    depth = int(pipeline_depth)
    if depth <= 0:
        # auto: the platform's depth at saveMode <= 1 (the pack's transfer
        # hides under the extra in-flight batch); the saveMode >= 2 text
        # writers fetch whole pools per batch (cold path), keep depth 1
        depth = (runtime.current_defaults()["pipeline_depth"]
                 if save_mode <= 1 else 1)
    depth = max(depth, 1)
    inflight: deque = deque()
    samp_next = sample_dispatch() if issue_remaining > 0 else None
    while issue_remaining > 0 or inflight:
        nxt = None
        if issue_remaining > 0 and (max_batches is None
                                    or batches_issued < max_batches):
            try:
                batch = min(event_batch, issue_remaining)
                samp, attempts, t_sample = sample_collect(samp_next, batch)
                rng_snap = (np.asarray(key).copy(), succ_rate)
                # dispatch the NEXT batch's sampler chunk ahead of this
                # batch's pipeline so it runs in the device gap
                if issue_remaining - batch > 0:
                    samp_next = sample_dispatch()
                nxt = issue_batch(samp, batch, attempts, t_sample, rng_snap)
            except Exception:
                # a sampling failure must not drop the already-computed
                # in-flight batches: assemble (and checkpoint) them first so
                # a resume recomputes nothing
                while inflight:
                    assemble(inflight.popleft())
                raise
        if nxt is not None:
            inflight.append(nxt)
            if len(inflight) >= 2:
                # the age-1 batch has had a full iteration of device time —
                # its compute is (nearly) done, so start its pack's host
                # copy now; assemble()'s np.asarray then collects a finished
                # copy instead of blocking the host on the transfer
                inflight[-2]["handles"][0].copy_to_host_async()
        while len(inflight) > depth or (nxt is None and inflight):
            assemble(inflight.popleft(),
                     overlap_s=nxt["t_sample"] if nxt else 0.0)
        if nxt is None and issue_remaining > 0:  # max_batches early stop
            if verbose:
                print(f"Stopping after {batches_done} batches "
                      f"({remaining} events remaining; checkpoint "
                      f"{'written' if checkpoint else 'NOT written'})")
            break

    if profile_dir:
        jax.profiler.stop_trace()

    save_all = (np.concatenate(rows, axis=0).astype(np.float64) if rows
                else np.zeros((0,)))  # empty-run shape matches np.asarray([])
    if remaining > 0:  # early stop: partial rows, no final normalization/npy
        stats.wall_time = time.time() - t_run0
        return save_all, out_path, stats
    if save_all.size:
        save_all[:, 7] /= float(stats.f_inx) if stats.f_inx else 1.0
    save_npy(out_path, save_all)
    _clear_checkpoint(out_path)
    stats.wall_time = time.time() - t_run0
    if verbose:
        print(f"events={stats.events} finals={stats.finals} f_inx={stats.f_inx} "
              f"nodes={stats.tot_nodes} info={stats.info_hist} "
              f"wall={stats.wall_time:.1f}s "
              f"(sample {stats.t_sample:.1f} pipe {stats.t_pipeline:.1f} "
              f"fetch {stats.t_fetch:.1f} rows {stats.t_rows:.1f} "
              f"issue {stats.t_issue:.1f} sampd {stats.t_sampd:.1f} "
              f"text {stats.t_text:.1f}) -> {out_path}")
    return save_all, out_path, stats
