"""Weighted branching-tree Monte-Carlo engine, batched over events.

Batched redesign of `get_tree` (MainRunner.jl:126-352).  The reference
explores one dynamically-branching tree at a time with a weight-sorted
worklist.  Here each event owns a *fixed-capacity node pool* (SoA arrays);
every iteration selects, per event, the highest-weight pending node (argmax ==
the reference's sort!-then-pop, MainRunner.jl:342), propagates all selected
nodes as one vmapped batch, and spawns children with masked scatter writes.
Events are masked out as their cutoffs fire; the loop is bounded by
max_nodes + 1 iterations (the reference's `count > max_nodes` stop).

Backtracing (the `splittings_cutoff` mode, MainRunner.jl:307-317 + 581-589)
is a single propagate collecting every crossing followed by a survival
reweighting — implemented separately in `backtrace`.

Stop codes (`info`, MainRunner.jl:324-348): 1 = worklist exhausted,
2 = prob_cutoff, 3 = num_cutoff, 4 = max_nodes; negated if the pure-MC mode
(count > MC_nodes) was entered.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from adiabatic_raytracer.config import NumericsConfig, Scene, TreeConfig
from adiabatic_raytracer.ops.conversion import get_prob_nonad
from adiabatic_raytracer.ops.propagate import propagate


def _negate_b(sc: Scene) -> Scene:
    """Backwards-in-time propagation: k -> -k and B -> -B (MainRunner.jl:580-586)."""
    return dataclasses.replace(sc, b0=-sc.b0)


def _prob_batch(pos, k, erg_eff, sc: Scene, compute_dtype: str = "state"):
    """P = 1 - exp(-P_nonAD) at a batch of points (MainRunner.jl:134-137).

    compute_dtype="f32": evaluate in f32 (~1e-7 relative accuracy, far
    inside the 1e-4 parity contract) with f64 in/outputs."""
    out_dtype = jnp.result_type(pos.dtype)
    if compute_dtype == "f32":
        from adiabatic_raytracer.ops.propagate import _cast_tree

        sc = _cast_tree(sc, jnp.float32)
        pos = pos.astype(jnp.float32)
        k = k.astype(jnp.float32)
        erg_eff = erg_eff.astype(jnp.float32)
    p_nonad = jax.vmap(lambda x, kk, e: get_prob_nonad(x, kk, e, sc))(pos, k, erg_eff)
    p_nonad = p_nonad.astype(out_dtype)
    # clamp to [0, 1]: node weights are products of these from a weight-1
    # root, so the clamp guarantees weight <= 1 — the invariant the work
    # queue's lead-lane boost (+4.0 in forward_tree) relies on
    return jnp.clip(1.0 - jnp.exp(-p_nonad), 0.0, 1.0), p_nonad


class BacktraceResult(NamedTuple):
    prob0: Any            # [E] conversion probability at the MC point (nb.prob)
    p_nonad0: Any         # [E] raw P_nonAD at the MC point (Prob_nonAD_0)
    weight: Any           # [E] survival product over backtraced crossings (nb.weight)
    samp_back_weight: Any  # [E] prob0 * weight (MainRunner.jl:630)
    n_cross: Any          # [E] number of (deduped) backtrace crossings
    xc: Any               # [E, MAXC, 3]
    kc: Any               # [E, MAXC, 3]
    tc: Any               # [E, MAXC] re-zeroed at the first conversion (MainRunner.jl:627-629)
    dwc: Any              # [E, MAXC]
    pc: Any               # [E, MAXC] conversion probabilities
    valid: Any            # [E, MAXC] mask
    c_bck: Any            # [E] node count of the backtrace tree (always 1)
    traj: Any             # [E, NS, 3] backtrace trajectory (saveMode 3)
    times: Any            # [E, NS]
    x_end: Any            # [E, 3] backtrace trajectory endpoint (nb.x[end],
    k_end: Any            # [E, 3] nb.kx[end]; the event file's "incoming
                          # axion" state, MainRunner.jl:600-607)
    raw_n_cross: Any      # [E] crossings before dedup/fallback (tree dumps)
    raw_tc: Any           # [E, MAXC] raw crossing times (tree dumps)


def backtrace(xpos, k_init, erg_inf, sc: Scene, cfg: NumericsConfig,
              tcfg: TreeConfig, *, lnt_end) -> BacktraceResult:
    """Backtrace the sampled axion to every level crossing it encountered
    (get_tree with -B0, -k, num_cutoff=0, splittings_cutoff=100000;
    MainRunner.jl:581-589)."""
    E = xpos.shape[0]
    sc_b = _negate_b(sc)
    k_back = -k_init

    res = propagate(
        xpos, k_back, sc_b, cfg,
        erg=erg_inf,
        delta_w=-jnp.ones(E, xpos.dtype),
        lnt0=jnp.full(E, cfg.ln_t_start, xpos.dtype),
        lnt1=jnp.broadcast_to(jnp.asarray(lnt_end, xpos.dtype), (E,)),
        is_photon=jnp.zeros(E, bool),
        max_crossings=jnp.full(E, cfg.max_crossings, jnp.int32),
        species="axion",
    )
    return backtrace_from_result(xpos, k_back, erg_inf, res, sc, cfg)


def backtrace_from_result(xpos, k_back, erg_inf, res, sc: Scene,
                          cfg: NumericsConfig) -> BacktraceResult:
    """Post-process a backtrace PropagateResult (dedup, survival weights,
    fallback, time re-zeroing).  Split out so host-orchestrated propagation
    engines (ops/streaming.CompactedPropagator) can feed the same path."""
    E = xpos.shape[0]
    sc_b = _negate_b(sc)
    prob0, p_nonad0 = _prob_batch(xpos, k_back, erg_inf, sc_b, cfg.compute_dtype)

    MAXC = cfg.max_crossings
    in_count = jnp.arange(MAXC)[None, :] < res.n_cross[:, None]

    # coincident-crossing dedup (MainRunner.jl:227-245): of two consecutive
    # crossings closer than 1e-5, drop the earlier one.
    d = jnp.linalg.norm(res.xc[:, 1:, :] - res.xc[:, :-1, :], axis=-1)
    next_valid = jnp.arange(1, MAXC)[None, :] < res.n_cross[:, None]
    keep_front = jnp.where(next_valid, d > 1e-5, True)
    valid = in_count & jnp.concatenate(
        [keep_front, jnp.ones((E, 1), bool)], axis=1
    )

    erg_eff = erg_inf[:, None] * jnp.abs(res.dwc)
    flat_pos = res.xc.reshape(-1, 3)
    flat_k = res.kc.reshape(-1, 3)
    flat_erg = erg_eff.reshape(-1)
    pc_flat, _ = _prob_batch(flat_pos, flat_k, flat_erg, sc_b,
                             cfg.compute_dtype)
    pc = jnp.where(valid, pc_flat.reshape(E, MAXC), 0.0)

    weight = jnp.prod(jnp.where(valid, 1.0 - pc, 1.0), axis=1)

    # fallback when no crossing was found: the MC point itself is the first
    # conversion (MainRunner.jl:614-624)
    none = res.n_cross == 0
    xc = jnp.where(none[:, None, None], res.xc.at[:, 0, :].set(xpos), res.xc)
    kc = jnp.where(none[:, None, None], res.kc.at[:, 0, :].set(k_back), res.kc)
    tc = jnp.where(none[:, None], res.tc.at[:, 0].set(0.0), res.tc)
    dwc = jnp.where(none[:, None], res.dwc.at[:, 0].set(-1.0), res.dwc)
    pc = jnp.where(none[:, None], pc.at[:, 0].set(prob0), pc)
    valid = jnp.where(none[:, None], jnp.arange(MAXC)[None, :] < 1, valid)
    n_valid = jnp.sum(valid.astype(jnp.int32), axis=1)

    # re-zero time at the last (earliest forward-time) crossing and flip sign
    last_idx = jnp.where(
        n_valid > 0,
        MAXC - 1 - jnp.argmax(valid[:, ::-1], axis=1),
        0,
    )
    t_last = tc[jnp.arange(E), last_idx]
    tc = jnp.where(valid, -(tc - t_last[:, None]), 0.0)

    return BacktraceResult(
        prob0=prob0,
        p_nonad0=p_nonad0,
        weight=weight,
        samp_back_weight=prob0 * weight,
        n_cross=n_valid,
        xc=xc, kc=kc, tc=tc, dwc=dwc, pc=pc, valid=valid,
        c_bck=jnp.ones(E, jnp.int32),
        traj=res.traj,
        times=res.times,
        x_end=res.traj[:, -1, :],
        k_end=res.mom[:, -1, :],
        raw_n_cross=res.n_cross,
        raw_tc=res.tc,
    )


class TreePools(NamedTuple):
    """SoA node pools, [E, P, ...]."""
    pos: Any
    k: Any
    t: Any
    dw: Any
    is_photon: Any
    prob: Any
    weight: Any
    parent_weight: Any
    prob_conv: Any
    prob_conv0: Any
    status: Any        # 0 empty, 1 pending, 2 processed
    is_final: Any
    fpos: Any          # [E, P, 3] trajectory endpoint
    fmom: Any
    ferg: Any          # [E, P] e7 at endpoint
    ftime: Any         # [E, P] final log-time
    traj: Any          # [E, P, NS, 3]
    mom: Any           # [E, P, NS, 3]
    times: Any         # [E, P, NS]
    xc: Any            # [E, P, 3] the (single) crossing of this node
    kc: Any
    tcx: Any
    dwcx: Any
    pcx: Any
    has_cross: Any
    order: Any         # [E, P] processing order (1-based; 0 = unprocessed)


class TreeResult(NamedTuple):
    pools: TreePools
    count: Any        # [E] processed-node count (the reference's `c`)
    count_main: Any   # [E] number of finals
    info: Any         # [E] stop code
    tot_prob: Any     # [E]
    n_alloc: Any      # [E]
    dw_anomalies: Any  # [E] nodes popped with Delta_omega outside (-2, -0.5)
                       # (MainRunner.jl:168-171 per-node sanity print)
    n_iters: Any       # [E] work-queue iterations executed, replicated per
                       # event (perf diagnostic: == the longest sequential
                       # chain across the batch; [E]-shaped so the result
                       # pytree shards uniformly over the event axis)
    done_it: Any       # [E] iteration (1-based) at which each event's
                       # cutoffs fired (perf diagnostic: the batch tail
                       # profile — how many iterations ran with how many
                       # events still active)


def _alloc_pools(E, P, NS, dtype):
    z = lambda *s: jnp.zeros(s, dtype)
    return TreePools(
        pos=z(E, P, 3), k=z(E, P, 3), t=z(E, P), dw=z(E, P),
        is_photon=jnp.zeros((E, P), bool),
        prob=z(E, P), weight=z(E, P), parent_weight=z(E, P),
        prob_conv=z(E, P), prob_conv0=z(E, P),
        status=jnp.zeros((E, P), jnp.int32),
        is_final=jnp.zeros((E, P), bool),
        fpos=z(E, P, 3), fmom=z(E, P, 3), ferg=z(E, P), ftime=z(E, P),
        traj=z(E, P, NS, 3), mom=z(E, P, NS, 3), times=z(E, P, NS),
        xc=z(E, P, 3), kc=z(E, P, 3), tcx=z(E, P), dwcx=z(E, P), pcx=z(E, P),
        has_cross=jnp.zeros((E, P), bool),
        order=jnp.zeros((E, P), jnp.int32),
    )


def forward_tree(key, xpos, k_init, erg_inf, sc: Scene, cfg: NumericsConfig,
                 tcfg: TreeConfig, *, lnt_end) -> TreeResult:
    """Forward branching tree from the MC-selected conversion point
    (get_tree, MainRunner.jl:126-352; parent photon seeded MainRunner.jl:653-664).

    Batched work-queue engine: every iteration selects, per event, the K
    highest-weight pending nodes (K = mc_nodes + 2 bounds the pending count —
    only the first mc_nodes processings can net +1 pending each, the MC mode
    after that is net 0) and propagates all E*K rays as ONE batch instead of
    one ray per event.  Within an iteration nodes are ranked by weight (the reference's sort!-then-pop,
    MainRunner.jl:342); cutoffs are evaluated after each iteration, so a
    batch may overshoot max_nodes/num_cutoff by up to K-1 nodes — strictly
    *more* tree explored than the reference at the same settings.

    `key`: either a single PRNG key (per-event keys derived by folding in the
    event's batch index — single-host layout) or per-event keys of shape
    [E, 2]/[E] typed keys (the sharding-invariant product path: derive them
    from *global* event seeds so results do not depend on the device mesh).
    Each node's MC draw folds in its per-event processing index, so draws are
    invariant to how iterations batch the work.

    cfg.tree_window = N (0 < N < E) runs the loop over an N-wide STREAMING
    WINDOW of active events: pools hold all E events, each iteration gathers
    the window's rows, and a finished event's window lane refills from the
    batch's unstarted events immediately — so the long-chain tail of one
    event overlaps other events' work instead of draining the whole batch
    at ~1-event occupancy.  Per-event results are bitwise identical to the
    unwindowed engine (see NumericsConfig.tree_window).
    """
    E = xpos.shape[0]
    dtype = xpos.dtype
    P = 2 * tcfg.max_nodes + 4
    NS = cfg.n_save
    # Lanes per event per iteration.  Auto: K=1 under the streaming window
    # — per-iteration glue and launch width scale with Ew*K while the
    # window already keeps occupancy high — and K=1 is the reference's
    # exact per-node cutoff semantics (MainRunner.jl:324-339; no K-batch
    # overshoot).  The unwindowed engine keeps K = mc_nodes + 2 (the
    # pending-count bound): there the batch drains to ~1-event occupancy,
    # so per-event width is what keeps launches full.
    if cfg.tree_k > 0:
        K = int(min(P, cfg.tree_k))
    elif cfg.tree_window > 0:
        K = 1
    else:
        K = int(min(P, tcfg.mc_nodes + 2))
    eidx = jnp.arange(E)

    key = jnp.asarray(key)
    per_event = key.shape[:1] == (E,) and (key.ndim == 1 or key.shape == (E, 2))
    if per_event and not (E == 2 and key.ndim == 1 and key.dtype == jnp.uint32):
        keys = key
    else:  # single raw key: derive per-event keys from the batch index
        keys = jax.vmap(lambda e: jax.random.fold_in(key, e))(eidx)

    pools = _alloc_pools(E, P, NS, dtype)
    # seed the parent photon: weight 1, prob from the conversion point
    prob0, _ = _prob_batch(xpos, k_init, erg_inf, sc, cfg.compute_dtype)
    pools = pools._replace(
        pos=pools.pos.at[:, 0, :].set(xpos),
        k=pools.k.at[:, 0, :].set(k_init),
        t=pools.t.at[:, 0].set(0.0),
        dw=pools.dw.at[:, 0].set(-1.0),
        is_photon=pools.is_photon.at[:, 0].set(True),
        prob=pools.prob.at[:, 0].set(prob0),
        weight=pools.weight.at[:, 0].set(1.0),
        parent_weight=pools.parent_weight.at[:, 0].set(1.0),
        prob_conv=pools.prob_conv.at[:, 0].set(-1.0),
        prob_conv0=pools.prob_conv0.at[:, 0].set(-1.0),
        status=pools.status.at[:, 0].set(1),
    )

    dt0_ln = cfg.ln_t_start
    # work-queue launch width: the [E, K] lane grid is mostly inert, so the
    # propagation launch carries only the W globally heaviest valid lanes
    # (every event's lead lane is boosted above all others, so chains always
    # progress each iteration and the `it` bound stays valid); remaining
    # valid lanes stay pending for later iterations.  Within an event the
    # selected lanes form a weight-descending prefix of its top-K list, so
    # count_now ranks, MC draw keys, and cutoff overshoot are untouched
    # whenever W covers all valid lanes (the typical case at the default
    # sizes: median pending per event is ~1).
    # streaming active window (see docstring / NumericsConfig.tree_window):
    # the per-iteration lane grid is [Ew, K]; window lane i holds event
    # aw[i], refilled from the batch's unstarted events as events finish
    Ew = E if cfg.tree_window <= 0 else int(min(cfg.tree_window, E))
    streaming = Ew < E
    W = cfg.tree_queue_width
    if W <= 0:
        W = max(((2 * Ew + 127) // 128) * 128, 128)
    W = int(min(Ew * K, max(W, Ew)))  # >= Ew so every lead lane fits
    W2 = cfg.tree_prob_width
    if W2 <= 0:
        W2 = max(W // 4, 128)
    W2 = int(min(Ew * K, W2))
    lnt1K = jnp.full((Ew, K), lnt_end, dtype)
    jrange = jnp.arange(K, dtype=jnp.int32)[None, :]
    DROP = P  # out-of-range scatter sentinel; writes masked via mode="drop"
    # benign state for inert work-queue lanes (they exit the integrator
    # immediately via lnt0 == lnt1, but must not produce NaNs on the way in)
    pos_safe = jnp.stack([3.0 * sc.r_ns, 0.1 * sc.r_ns, 0.1 * sc.r_ns]).astype(dtype)
    k_safe = jnp.asarray([1.0, 0.0, 0.0], dtype)

    class Carry(NamedTuple):
        pools: TreePools
        tot_prob: Any
        count: Any
        count_main: Any
        info: Any
        done: Any
        n_alloc: Any
        dw_anom: Any
        it: Any
        done_it: Any
        aw: Any       # [Ew] event id held by each window lane
        cursor: Any   # next unstarted event (== E when not streaming)

    carry0 = Carry(
        pools=pools,
        tot_prob=jnp.zeros(E, dtype),
        count=jnp.zeros(E, jnp.int32),
        count_main=jnp.zeros(E, jnp.int32),
        info=jnp.ones(E, jnp.int32),
        done=jnp.zeros(E, bool),
        n_alloc=jnp.ones(E, jnp.int32),
        dw_anom=jnp.zeros(E, jnp.int32),
        it=jnp.zeros((), jnp.int32),
        done_it=jnp.zeros(E, jnp.int32),
        aw=jnp.arange(Ew, dtype=jnp.int32),
        cursor=jnp.asarray(Ew, jnp.int32),
    )

    def flat(a):
        return a.reshape((Ew * K,) + a.shape[2:])

    def unflat(a):
        return a.reshape((Ew, K) + a.shape[1:])

    def body(c: Carry) -> Carry:
        pl = c.pools
        # window gathers: `row` lifts a per-event [E, ...] array onto the
        # [Ew] window; all body arithmetic below runs at window width and
        # per-event updates scatter back through `put` (aw entries are
        # unique, so the scatter is well-defined)
        aw = c.aw
        if streaming:
            row = lambda a: a[aw]
            put = lambda old, new_w: old.at[aw].set(new_w)
        else:
            row = lambda a: a
            put = lambda old, new_w: new_w
        eK = jnp.broadcast_to(aw[:, None], (Ew, K))
        ergK = jnp.broadcast_to(row(erg_inf)[:, None], (Ew, K))
        keys_w = keys[aw] if streaming else keys
        done_w = row(c.done)
        count_w = row(c.count)
        pending = row(pl.status) == 1
        has_pending = jnp.any(pending, axis=1)
        active = ~done_w & has_pending
        # K highest-weight pending nodes per event, weight-descending
        # (== sort! + pop, MainRunner.jl:342, K at a time)
        # selection keys sort in f32 on the f32 compute path (the weights
        # are f32-physics values anyway) — ranking ties break by index
        # either way
        skey = jnp.float32 if cfg.compute_dtype == "f32" else dtype
        wmask = jnp.where(pending & active[:, None], row(pl.weight), -jnp.inf)
        top_w, top_idx = lax.top_k(wmask.astype(skey), K)   # [Ew, K]
        valid = jnp.isfinite(top_w)

        def g2(buf):
            return buf[eK, top_idx]

        pos0 = jnp.where(valid[..., None], g2(pl.pos), pos_safe)
        k0 = jnp.where(valid[..., None], g2(pl.k), k_safe)
        t_node = g2(pl.t)
        dw_node = jnp.where(valid, g2(pl.dw), -1.0)
        is_ph = g2(pl.is_photon)
        w_node = g2(pl.weight)
        prob_conv_parent = g2(pl.prob_conv)
        # per-node processing index: rank within the iteration continues the
        # event's running count (the reference's `count` at pop time)
        count_now = count_w[:, None] + 1 + jrange

        keys_rep = jnp.repeat(keys_w, K, axis=0)

        # --- global work-queue compaction: pick the W lanes to launch ---
        if W < Ew * K:
            gkey = jnp.where(valid, w_node.astype(skey), -jnp.inf)
            gkey = gkey + jnp.where(jrange == 0, 4.0, 0.0).astype(skey)
            # every event's lead lane outranks all non-lead lanes globally
            topv, gsel = lax.top_k(gkey.reshape(Ew * K), W)
            sel = jnp.zeros((Ew * K,), bool).at[gsel].set(jnp.isfinite(topv))
            nsel = jnp.sum(sel.reshape(Ew, K), axis=1)
            valid = valid & (jrange < nsel[:, None])   # tie-safe prefix
            # pack the (now <= W) valid lanes; top_k breaks ties toward lower
            # flat indices, i.e. event-major order
            _, gidx = lax.top_k(valid.reshape(Ew * K).astype(jnp.float32), W)
            gather = lambda a: flat(a)[gidx]

            def expand(field):
                buf = jnp.zeros((Ew * K,) + field.shape[1:], field.dtype)
                return buf.at[gidx].set(field)
        else:
            gather = flat
            expand = lambda a: a

        lnt0 = jnp.log(jnp.maximum(t_node, jnp.exp(jnp.asarray(dt0_ln, dtype))))
        lnt0 = jnp.where(valid, lnt0, lnt1K)  # inert lanes exit immediately
        res = propagate(gather(pos0), gather(k0), sc, cfg,
                        erg=gather(ergK), delta_w=gather(dw_node),
                        lnt0=gather(lnt0), lnt1=gather(lnt1K),
                        is_photon=gather(is_ph), species="mixed",
                        max_crossings=jnp.ones(W, jnp.int32))
        ncr_x = expand(res.n_cross)
        xcs_x = expand(res.xc)
        kcs_x = expand(res.kc)
        tcs_x = expand(res.tc)
        dwcs_x = expand(res.dwc)
        traj_x = expand(res.traj)
        mom_x = expand(res.mom)
        erg_x = expand(res.erg[:, -1])
        flnt_x = expand(res.final_lnt)
        times_x = expand(res.times)

        has_cross = unflat(ncr_x) >= 1
        xc = unflat(xcs_x[:, 0, :])
        kc = unflat(kcs_x[:, 0, :])
        tcx = unflat(tcs_x[:, 0])
        dwcx = unflat(dwcs_x[:, 0])

        # "rare fail" guard (MainRunner.jl:213-224): |velocity component| > 1
        rare_fail = has_cross & jnp.any(jnp.abs(kc) > 1.0, axis=-1) & valid
        cross_ok = has_cross & ~rare_fail & valid

        # conversion-probability compaction: crossings are a small fraction
        # of launched lanes (~10% at production rates), so evaluate P on the
        # W2 first crossing lanes (index-packed via top_k on the mask) and
        # scatter back — per-point values are bit-identical to the full
        # evaluation; rare bursts with more than W2 crossings fall back to
        # evaluating every launched lane.
        xc_s = jnp.where(cross_ok[..., None], xc, pos_safe)
        kc_s = jnp.where(cross_ok[..., None], kc, k_safe)
        erg_c = ergK * jnp.abs(dwcx)
        if W2 < Ew * K:
            ckey = cross_ok.reshape(Ew * K).astype(jnp.float32)
            n_co = jnp.sum(ckey)
            _, cidx = lax.top_k(ckey, W2)

            def compact_prob(_):
                p2, _ = _prob_batch(flat(xc_s)[cidx], flat(kc_s)[cidx],
                                    flat(erg_c)[cidx], sc, cfg.compute_dtype)
                return jnp.zeros((Ew * K,), p2.dtype).at[cidx].set(p2)

            def full_prob(_):
                pw, _ = _prob_batch(gather(xc_s), gather(kc_s),
                                    gather(erg_c), sc, cfg.compute_dtype)
                return expand(pw)

            pcx_flat = lax.cond(n_co <= W2, compact_prob, full_prob, 0)
            pcx = jnp.where(cross_ok, pcx_flat.reshape(Ew, K), 0.0)
        else:
            pcx_w, _ = _prob_batch(gather(xc_s), gather(kc_s),
                                   gather(erg_c), sc, cfg.compute_dtype)
            pcx = jnp.where(cross_ok, unflat(expand(pcx_w)), 0.0)

        # --- record propagation results on the processed nodes ---
        sel_w = jnp.where(valid, top_idx, DROP)
        sel_x = jnp.where(cross_ok, top_idx, DROP)

        def sc2(buf, val, slot):
            return buf.at[eK, slot].set(val, mode="drop")

        traj_k = unflat(traj_x)
        mom_k = unflat(mom_x)
        ferg_v = unflat(erg_x)
        ftime_v = unflat(flnt_x)
        pl = pl._replace(
            status=sc2(pl.status, jnp.full((Ew, K), 2, jnp.int32), sel_w),
            fpos=sc2(pl.fpos, traj_k[:, :, -1, :], sel_w),
            fmom=sc2(pl.fmom, mom_k[:, :, -1, :], sel_w),
            ferg=sc2(pl.ferg, ferg_v, sel_w),
            ftime=sc2(pl.ftime, ftime_v, sel_w),
            traj=sc2(pl.traj, traj_k, sel_w),
            mom=sc2(pl.mom, mom_k, sel_w),
            times=sc2(pl.times, unflat(times_x), sel_w),
            xc=sc2(pl.xc, xc, sel_x),
            kc=sc2(pl.kc, kc, sel_x),
            tcx=sc2(pl.tcx, tcx, sel_x),
            dwcx=sc2(pl.dwcx, dwcx, sel_x),
            pcx=sc2(pl.pcx, pcx, sel_x),
            has_cross=sc2(pl.has_cross, cross_ok, sel_w),
            order=sc2(pl.order, count_now, sel_w),
        )

        # --- no crossing: final node (MainRunner.jl:200-207) ---
        no_cross = valid & ~has_cross
        r_end = jnp.linalg.norm(traj_k[:, :, -1, :], axis=-1)
        final_ok = no_cross & (r_end > sc.r_ns * 1.1)
        pl = pl._replace(
            is_final=sc2(pl.is_final, final_ok, jnp.where(no_cross, top_idx, DROP))
        )
        tot_prob = row(c.tot_prob) + jnp.sum(
            jnp.where(no_cross | rare_fail, w_node, 0.0), axis=1)
        count_main = row(c.count_main) + jnp.sum(no_cross, axis=1).astype(jnp.int32)
        dw_bad = valid & ((dw_node > -0.5) | (dw_node < -2.0))
        dw_anom = row(c.dw_anom) + jnp.sum(dw_bad, axis=1).astype(jnp.int32)

        # --- spawn children (MainRunner.jl:278-305) ---
        spawn = cross_ok
        mc_mode = count_now > tcfg.mc_nodes
        # MC draw keyed on (event key, per-event node index): invariant to
        # sharding and to how iterations batch the work
        subkey = jax.vmap(jax.random.fold_in)(keys_rep, flat(count_now))
        r_mc = unflat(jax.vmap(
            lambda kk: jax.random.uniform(kk, dtype=dtype))(subkey))
        convert_mc = r_mc < pcx

        new_species = ~is_ph
        # child A (always written when spawning): in MC mode the single drawn
        # child; in full-tree mode the converted child.
        a_species = jnp.where(mc_mode, jnp.where(convert_mc, new_species, is_ph),
                              new_species)
        a_prob = jnp.where(mc_mode, jnp.where(convert_mc, pcx, 1.0 - pcx), pcx)
        a_weight = jnp.where(mc_mode, w_node, pcx * w_node)
        a_prob_conv0 = jnp.where(
            mc_mode, jnp.where(convert_mc, pcx, prob_conv_parent), pcx)

        # per-node child slots: exclusive running sum of children within the
        # iteration, appended after the event's current allocation
        n_child = jnp.where(spawn, jnp.where(mc_mode, 1, 2), 0).astype(jnp.int32)
        base = row(c.n_alloc)[:, None] + jnp.cumsum(n_child, axis=1) - n_child
        slot_a = base
        slot_b = base + 1
        write_a = spawn & (slot_a < P)
        write_b = spawn & ~mc_mode & (slot_b < P)
        sa = jnp.where(write_a, slot_a, DROP)
        sb = jnp.where(write_b, slot_b, DROP)

        pl = pl._replace(
            pos=sc2(pl.pos, xc, sa),
            k=sc2(pl.k, kc, sa),
            t=sc2(pl.t, tcx, sa),
            dw=sc2(pl.dw, dwcx, sa),
            is_photon=sc2(pl.is_photon, a_species, sa),
            prob=sc2(pl.prob, a_prob, sa),
            weight=sc2(pl.weight, a_weight, sa),
            parent_weight=sc2(pl.parent_weight, w_node, sa),
            prob_conv=sc2(pl.prob_conv, pcx, sa),
            prob_conv0=sc2(pl.prob_conv0, a_prob_conv0, sa),
            status=sc2(pl.status, jnp.ones((Ew, K), jnp.int32), sa),
        )

        # child B (full-tree mode only): the surviving parent species
        pl = pl._replace(
            pos=sc2(pl.pos, xc, sb),
            k=sc2(pl.k, kc, sb),
            t=sc2(pl.t, tcx, sb),
            dw=sc2(pl.dw, dwcx, sb),
            is_photon=sc2(pl.is_photon, is_ph, sb),
            prob=sc2(pl.prob, 1.0 - pcx, sb),
            weight=sc2(pl.weight, (1.0 - pcx) * w_node, sb),
            parent_weight=sc2(pl.parent_weight, w_node, sb),
            prob_conv=sc2(pl.prob_conv, pcx, sb),
            prob_conv0=sc2(pl.prob_conv0, prob_conv_parent, sb),
            status=sc2(pl.status, jnp.ones((Ew, K), jnp.int32), sb),
        )
        n_alloc_add = write_a.astype(jnp.int32) + write_b.astype(jnp.int32)

        n_alloc = row(c.n_alloc) + jnp.sum(n_alloc_add, axis=1).astype(jnp.int32)

        count = count_w + jnp.sum(valid, axis=1).astype(jnp.int32)

        # --- cutoffs (MainRunner.jl:324-339), checked once per iteration ---
        info = row(c.info)
        done = done_w
        hit2 = active & (tot_prob >= 1.0 - tcfg.prob_cutoff)
        info = jnp.where(hit2 & ~done, 2, info)
        done = done | hit2
        hit3 = active & (count_main >= tcfg.num_cutoff)
        info = jnp.where(hit3 & ~done, 3, info)
        done = done | hit3
        hit4 = active & (count > tcfg.max_nodes)
        info = jnp.where(hit4 & ~done, 4, info)
        done = done | hit4
        done = done | ~has_pending
        done_it_w = row(c.done_it)
        done_it = jnp.where(done & (done_it_w == 0), c.it + 1, done_it_w)

        # --- window refill (streaming only): a finished event's lane takes
        # the next unstarted event (its pools row is already seeded), so the
        # window stays at full occupancy until the batch is exhausted ---
        aw_next, cursor_next = aw, c.cursor
        if streaming:
            freed = done
            rank = jnp.cumsum(freed.astype(jnp.int32)) - freed.astype(jnp.int32)
            navail = E - c.cursor
            take = freed & (rank < navail)
            aw_next = jnp.where(take, c.cursor + rank, aw).astype(jnp.int32)
            cursor_next = (c.cursor + jnp.minimum(
                jnp.sum(freed.astype(jnp.int32)), navail)).astype(jnp.int32)

        return Carry(pools=pl,
                     tot_prob=put(c.tot_prob, tot_prob),
                     count=put(c.count, count),
                     count_main=put(c.count_main, count_main),
                     info=put(c.info, info),
                     done=put(c.done, done),
                     n_alloc=put(c.n_alloc, n_alloc),
                     dw_anom=put(c.dw_anom, dw_anom),
                     it=c.it + 1,
                     done_it=put(c.done_it, done_it),
                     aw=aw_next, cursor=cursor_next)

    if streaming:
        # greedy-scheduling makespan bound: Ew window lanes, E jobs, each
        # job occupies its lane for <= max_nodes + 2 iterations (every
        # active window event processes >= 1 node per iteration)
        it_cap = (E // Ew + 2) * (tcfg.max_nodes + 2)

        def cond(c: Carry):
            return ((jnp.any(~c.done[c.aw]) | (c.cursor < E))
                    & (c.it <= it_cap))
    else:
        def cond(c: Carry):
            return jnp.any(~c.done) & (c.it <= tcfg.max_nodes + 1)

    out = lax.while_loop(cond, body, carry0)

    info = jnp.where(out.count > tcfg.mc_nodes, -jnp.abs(out.info), out.info)
    return TreeResult(pools=out.pools, count=out.count, count_main=out.count_main,
                      info=info, tot_prob=out.tot_prob, n_alloc=out.n_alloc,
                      dw_anomalies=out.dw_anom,
                      n_iters=jnp.broadcast_to(out.it, (E,)),
                      done_it=jnp.where(out.done_it > 0, out.done_it, out.it))


def max_finals(tcfg: TreeConfig) -> int:
    """Tight static bound on finals per event: count_main is checked against
    num_cutoff once per iteration and each iteration adds at most K-1 finals
    past the check (K = mc_nodes + 2 work-queue lanes), so
    finals <= num_cutoff - 1 + K = num_cutoff + mc_nodes + 1."""
    return int(min(2 * tcfg.max_nodes + 4, tcfg.num_cutoff + tcfg.mc_nodes + 1))


def compact_finals(pools: TreePools, F: int):
    """Device-side compaction of the final nodes into a dense [E, F, 14] pack.

    The driver's saveMode<=1 row assembly needs only the final nodes
    (MainRunner.jl:670-729) — a handful per event — but the pools hold
    P = 2*max_nodes + 4 slots, so shipping [E, P, 16] is ~10x more bytes
    than the finals themselves.  This gathers, per event, the first F final
    nodes in processing order (lax.top_k on negated order, a static-shape
    selection) and packs the row-assembly fields:

      [valid, is_photon, ferg, weight, prob, prob_conv, prob_conv0, t,
       fpos(3), fmom(3)]

    F must be >= max_finals(tcfg) or finals are silently dropped."""
    d = pools.pos.dtype
    E = pools.pos.shape[0]
    final = (pools.status == 2) & pools.is_final
    fkey = jnp.where(final, -pools.order.astype(d), -jnp.inf)
    top, idx = lax.top_k(fkey, F)              # ascending processing order
    valid = jnp.isfinite(top)
    eF = jnp.arange(E)[:, None]
    g = lambda a: a[eF, idx]
    one = lambda a: g(a).astype(d)[..., None]
    return jnp.concatenate([
        valid.astype(d)[..., None], one(pools.is_photon), one(pools.ferg),
        one(pools.weight), one(pools.prob), one(pools.prob_conv),
        one(pools.prob_conv0), one(pools.t), g(pools.fpos), g(pools.fmom),
    ], axis=-1)


def compact_finals_global(pools: TreePools, cap: int, out_dtype=None,
                          order_stride: int = 0):
    """Batch-GLOBAL compaction of the final nodes into one dense
    [cap+1, 14] pack: per row
      [event, is_photon, ferg, weight, prob, prob_conv, prob_conv0, t,
       fpos(3), fmom(3)]
    ordered by (event, processing order), with the total finals count in the
    trailer row.  The per-event pack (compact_finals) must size for the
    worst event (F = num_cutoff + mc_nodes + 1 slots each) while the actual
    population is ~2-3 finals/event — at production cutoffs the global pack
    ships ~25x fewer bytes to the host.  cap bounds the TOTAL finals per
    batch; the host detects overflow from the trailer count.

    out_dtype=float32 is safe for every packed field (energies ~1e-5,
    positions ~1e2 km, probabilities); the driver keeps it at the state
    dtype on the CPU/golden path."""
    d = out_dtype or pools.pos.dtype
    E, P = pools.pos.shape[:2]
    # (event, order)-ascending selection: e*S + order is unique and exact
    # in f32 below 2^24 as long as the stride S exceeds every order (the
    # pools have P = 2*max_nodes+4 > order by construction).
    S = max(int(order_stride), P)
    assert E * S < (1 << 24), "sort key exceeds f32 exact-integer range"
    final = (pools.status == 2) & pools.is_final
    gkey = jnp.where(
        final,
        -(jnp.arange(E)[:, None] * S + pools.order).astype(jnp.float32),
        -jnp.inf)
    # small batches can hold fewer pool slots than the requested cap — take
    # what exists and pad the pack
    k = min(cap, E * P)
    top, idx = lax.top_k(gkey.reshape(E * P), k)
    if k < cap:
        top = jnp.concatenate([top, jnp.full(cap - k, -jnp.inf, top.dtype)])
        idx = jnp.concatenate([idx, jnp.zeros(cap - k, idx.dtype)])
    valid = jnp.isfinite(top)
    e_idx = idx // P

    def g(a):
        return jnp.where(valid, a.reshape(E * P)[idx], 0).astype(d)[:, None]

    def g3(a):
        return jnp.where(valid[:, None], a.reshape(E * P, 3)[idx], 0).astype(d)

    rows = jnp.concatenate([
        jnp.where(valid, e_idx, 0).astype(d)[:, None],
        g(pools.is_photon), g(pools.ferg), g(pools.weight), g(pools.prob),
        g(pools.prob_conv), g(pools.prob_conv0), g(pools.t),
        g3(pools.fpos), g3(pools.fmom),
    ], axis=1)
    trailer = jnp.zeros((1, 14), d).at[0, 0].set(
        jnp.sum(final).astype(d))
    return jnp.concatenate([rows, trailer], axis=0)


def print_tree(result: TreeResult, event: int = 0):
    """Debug dump of one event's tree (printTree, MainRunner.jl:6-15)."""
    import numpy as np

    pl = result.pools
    status = np.asarray(pl.status[event])
    weights = np.asarray(pl.weight[event])
    species = np.asarray(pl.is_photon[event])
    total = 0.0
    print()
    for p in np.nonzero(status > 0)[0]:
        name = "photon" if species[p] else "axion"
        print(f"{name}  {weights[p]}")
        total += float(weights[p])
    print(f"Total weight: {total}")
    print()
