"""Chunked ray propagation with straggler compaction.

The lockstep pool integrator runs until the *slowest* ray finishes; step-count
distributions are heavy-tailed (p50 ~ 90, max ~ 2500), so a single monolithic
pool runs at a few percent lane utilization.  This wrapper runs the pool in
bounded chunks of loop iterations and, between chunks, compacts the still-
active rays into a smaller (power-of-two) pool on the host.  Early finishers
stop paying for stragglers; the straggler tail runs in a small cheap pool.

Pool sizes are powers of two, so at most log2(B) distinct shapes are compiled
(cached across calls).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from adiabatic_raytracer.config import NumericsConfig, Scene
from adiabatic_raytracer.ops.dispersion import k_norm_cart
from adiabatic_raytracer.ops.geometry import cart_to_sph, celerity_from_cart
from adiabatic_raytracer.ops.integrator import PoolState, integrate_pool
from adiabatic_raytracer.ops.propagate import (
    PropagateResult,
    _cast_tree,
    crossing_condition,
    finalize_propagate,
    make_rhs,
)


def _pow2_at_least(n: int, floor: int = 128) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


class CompactedPropagator:
    """Host-orchestrated chunked propagate() with straggler compaction."""

    def __init__(self, sc: Scene, cfg: NumericsConfig, *, species: str = "photon",
                 detect_events: bool = True, time0: float = 0.0,
                 chunk_iters: int = 256, min_pool: int = 128):
        self.sc = sc
        self.cfg = cfg
        self.species = species
        self.detect_events = detect_events
        self.chunk_iters = chunk_iters
        self.min_pool = min_pool
        mass_eff = sc.mass_ns_eff
        self.mass_eff = mass_eff
        self.rhs = make_rhs(sc, mass_eff, time0, species, compute_dtype=cfg.compute_dtype)
        if cfg.compute_dtype == "f32":
            sc_c = _cast_tree(sc, jnp.float32)
            mass_c = jnp.float32(mass_eff)

            def cond_fn(u, lnt, ray_args):
                return crossing_condition(u.astype(jnp.float32),
                                          lnt.astype(jnp.float32),
                                          ray_args["erg"], sc_c, mass_c).astype(u.dtype)
        else:

            def cond_fn(u, lnt, ray_args):
                return crossing_condition(u, lnt, ray_args["erg"], sc, mass_eff)

        self.cond_fn = cond_fn
        self._begin_cache: Dict[int, Any] = {}
        self._chunk_cache: Dict[int, Any] = {}
        self._finish = jax.jit(
            lambda res, erg, save_lnt: finalize_propagate(res, erg, self.sc,
                                                          self.mass_eff, save_lnt)
        )

    # ------------------------------------------------------------------
    def _aux(self, erg, is_photon, lnt1, save_lnt, x0_cart, maxc):
        return {"erg": erg, "is_photon": is_photon, "lnt1": lnt1,
                "save_lnt": save_lnt, "x0": x0_cart, "maxc": maxc}

    def _run_pool(self, state, aux, budget):
        return integrate_pool(
            self.rhs, self.cond_fn, state.u, state.lnt, aux["lnt1"],
            {"erg": aux["erg"], "is_photon": aux["is_photon"]}, self.cfg,
            save_lnt=aux["save_lnt"],
            kill_at_surface=aux["is_photon"],
            r_ns=self.sc.r_ns,
            x0_cart=aux["x0"],
            max_crossings=aux["maxc"],
            detect_events=self.detect_events,
            init_state=state,
            iter_budget=budget,
            return_state=True,
        )

    def _begin_fn(self, B):
        if B not in self._begin_cache:

            def begin(x0, k0, erg, delta_w, lnt0, lnt1, is_photon, maxc):
                k0n = k_norm_cart(x0, k0, 0.0, erg, self.sc, self.sc.mass_ns,
                                  is_photon=True, ax_fix=True)
                x_sph0 = cart_to_sph(x0)
                w0 = celerity_from_cart(x0, k0n, self.mass_eff) / erg[:, None]
                u0 = jnp.concatenate([x_sph0, w0, (erg * delta_w)[:, None]], axis=1)
                NS = self.cfg.n_save
                frac = jnp.linspace(0.0, 1.0, NS)
                save_lnt = lnt0[:, None] + (lnt1 - lnt0)[:, None] * frac[None, :]
                aux = self._aux(erg, is_photon, lnt1, save_lnt, x0, maxc)
                # iter_budget=0: build the initial PoolState without stepping
                _, state = integrate_pool(
                    self.rhs, self.cond_fn, u0, lnt0, lnt1,
                    {"erg": erg, "is_photon": is_photon}, self.cfg,
                    save_lnt=save_lnt, kill_at_surface=is_photon,
                    r_ns=self.sc.r_ns, x0_cart=x0, max_crossings=maxc,
                    detect_events=self.detect_events, iter_budget=0,
                    return_state=True,
                )
                return state, aux

            self._begin_cache[B] = jax.jit(begin)
        return self._begin_cache[B]

    def _chunk_fn(self, B):
        if B not in self._chunk_cache:
            self._chunk_cache[B] = jax.jit(
                lambda state, aux: self._run_pool(state, aux, self.chunk_iters))
        return self._chunk_cache[B]

    # ------------------------------------------------------------------
    def run(self, x0, k0, erg, delta_w, lnt0, lnt1, is_photon, max_crossings,
            max_chunks: int = 10_000) -> PropagateResult:
        B = int(x0.shape[0])
        state, aux = self._begin_fn(B)(x0, k0, erg, delta_w, lnt0, lnt1,
                                       is_photon, max_crossings)

        # host-side final buffers in original ray order
        final_state = jax.tree_util.tree_map(lambda a: np.array(a), state)
        final_aux = jax.tree_util.tree_map(np.asarray, aux)
        orig_idx = np.arange(B)
        valid = np.ones(B, bool)  # False for compaction-padding duplicates

        def flush(st):
            st_np = jax.tree_util.tree_map(np.asarray, st)
            for name, buf in final_state._asdict().items():
                buf[orig_idx[valid]] = getattr(st_np, name)[valid]
            return st_np

        chunks = 0
        while True:
            _, state = self._chunk_fn(int(state.u.shape[0]))(state, aux)
            chunks += 1
            done = np.asarray(state.done)
            if done.all() or chunks >= max_chunks:
                flush(state)
                break
            n_active = int((~done & valid).sum())
            target = _pow2_at_least(n_active, self.min_pool)
            if target < state.u.shape[0]:
                # flush finished rays to the final buffers, compact the rest
                st_np = flush(state)
                aux_np = jax.tree_util.tree_map(np.asarray, aux)
                keep = np.nonzero(~done & valid)[0]
                pad = np.concatenate(
                    [keep, np.full(target - len(keep), keep[0], np.int64)])
                orig_idx = orig_idx[pad]
                valid = np.zeros(target, bool)
                valid[: len(keep)] = True
                state = PoolState(**{
                    name: jnp.asarray(getattr(st_np, name)[pad])
                    for name in st_np._fields
                })
                # padding duplicates are marked done so they do not step
                state = state._replace(done=jnp.asarray(st_np.done[pad] | ~valid))
                aux = {k: jnp.asarray(v[pad]) for k, v in aux_np.items()}

        # rebuild a full-size PoolResult and finalize
        from adiabatic_raytracer.ops.integrator import PoolResult

        fs = final_state
        past_end = final_aux["save_lnt"] > fs.lnt[:, None]
        save_u = np.where(past_end[:, :, None], fs.u[:, None, :], fs.save_u)
        res = PoolResult(
            u=jnp.asarray(fs.u), lnt=jnp.asarray(fs.lnt),
            save_u=jnp.asarray(save_u),
            cross_u=jnp.asarray(fs.cross_u), cross_lnt=jnp.asarray(fs.cross_lnt),
            n_cross=jnp.asarray(fs.n_cross), cut_short=jnp.asarray(fs.cut_short),
            ns_hit=jnp.asarray(fs.ns_hit), maxed=jnp.asarray(fs.maxed),
            steps=jnp.asarray(fs.steps), stalled=jnp.asarray(fs.stalled),
        )
        return self._finish(res, jnp.asarray(final_aux["erg"]),
                            jnp.asarray(final_aux["save_lnt"]))
