"""Typed scene / numerics / tree configuration pytrees.

The reference carries state between layers in positional, untyped "Mvars"
lists with *different* layouts for photons and axions (MainRunner.jl:177-186,
RayTracer.jl:76,100).  Here everything is a typed, jit-friendly dataclass
pytree: physical parameters are traced leaves, discrete mode switches are
static metadata so XLA specializes and eliminates dead branches.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


def _pytree_dataclass(cls=None):
    """Register a frozen dataclass as a JAX pytree.

    Fields with ``metadata={"static": True}`` become aux data (hashable,
    trigger recompilation when changed); everything else is a traced leaf.
    """

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        data_fields = [f.name for f in dataclasses.fields(c) if not f.metadata.get("static")]
        meta_fields = [f.name for f in dataclasses.fields(c) if f.metadata.get("static")]
        jax.tree_util.register_dataclass(c, data_fields, meta_fields)
        return c

    return wrap if cls is None else wrap(cls)


def static_field(default: Any):
    return dataclasses.field(default=default, metadata={"static": True})


@_pytree_dataclass
class Scene:
    """Physical scene: neutron star + axion parameters.

    Mirrors the CLI-visible parameters of the reference
    (Gen_Samples.jl:137-174) plus the hard-coded "fixed parameters" block
    promoted to first-class config.

    Tombstoned fixed-block knobs (Gen_Samples.jl:158-161) — inert in the
    reference and therefore deliberately NOT carried as fields:
      * ``ωProp = "Simple"``  — only value ever passed; no other branch exists.
      * ``CLen_Scale = false`` — conversion-length rescale flag, always off.
      * ``cutT = 10000``       — legacy trajectory cut, unused by the tree path.
      * ``gammaF = [1.0, 1.0]``— threaded through every Mvars list
        (e.g. MainRunner.jl:177) but never read by any physics function.
    """

    mass_a: Any = 1e-5        # axion mass [eV]              (--MassA)
    ax_g: Any = 1e-12         # axion-photon coupling [1/GeV] (--Axg)
    theta_m: Any = 0.0        # misalignment angle [rad]      (--ThetaM)
    omega_pul: Any = 1.0      # NS rotation frequency [1/s]   (--rotW)
    b0: Any = 1e14            # surface B field [Gauss]       (--B0)
    r_ns: Any = 10.0          # NS radius [km]                (--rNS)
    mass_ns: Any = 1.0        # NS mass [Msun]                (--Mass_NS)
    bndry_lyr: Any = -1.0     # boundary-layer index; <=0 disables (--bndry_lyr)
    rho_dm: Any = 0.45        # local DM density [GeV/cm^3]
    v_ns: Any = (0.0, 0.0, 0.0)  # NS velocity [c]            (--vNS_*)
    vmean_ax: Any = 220.0     # asymptotic axion speed scale [km/s]
    # --- static mode switches (XLA-specialized) ---
    flat: bool = static_field(False)        # flat space vs Schwarzschild
    isotropic: bool = static_field(False)   # isotropic plasma dispersion
    melrose: bool = static_field(True)      # Melrose anisotropic form (production mode)

    @property
    def mass_ns_eff(self):
        """NS mass with the `flat` switch applied (RayTracer.jl:187-189)."""
        return 0.0 if self.flat else self.mass_ns


@_pytree_dataclass
class NumericsConfig:
    """Integrator / event-detection numerics.

    Tolerances follow the reference's contract: Vern6 with reltol=1e-7,
    abstol=ode_err (1e-6), dtmin=1e-13 force_dtmin, maxiters=1e5
    (RayTracer.jl:383-384, Gen_Samples.jl:163).
    """

    rtol: Any = 1e-7
    atol: Any = 1e-6          # "ode_err"
    ln_t_start: Any = -30.0   # log-time integration start (MainRunner.jl:411)
    dt_min: Any = 1e-13
    safety: Any = 0.9
    max_dt_factor: Any = 5.0
    min_dt_factor: Any = 0.2
    # Lund/Hairer predictive (PI) step controller stabilization (dopri5.f
    # "beta"): growth = safety * enorm^-(0.2 - 0.75*beta) * errold^beta with
    # errold = max(enorm, 1e-4) from the last ACCEPTED step, growth clamped
    # <= 1 after a rejection.  0 reproduces the plain I controller
    # bit-for-bit.  At loose tolerance (rtol 1e-6) beta=0.04 roughly halves
    # the step count and removes dt_min stall cuts; default 0 keeps the
    # golden rows and census pins bit-stable.
    pi_beta: Any = 0.0
    # --- static ---
    max_steps: int = static_field(100_000)
    n_save: int = static_field(3)           # "ntimes": saved trajectory points
    # Event-scan density per accepted step.  The reference's
    # ContinuousCallback scans 50 interpolation points (RayTracer.jl:357-358)
    # and the crossing census (bench_census.py) shows no lower density
    # matches: ~4.5% of production-backtrace crossings live in tangent
    # double-crossing pairs inside one scan sub-interval, and the missed
    # count is nearly FLAT in K below 50 — so 50 is the default, not a
    # smaller census-matched value (none exists).
    interp_points: int = static_field(50)
    bisect_iters: int = static_field(60)    # event root refinement iterations
    max_roots_per_step: int = static_field(3)
    max_crossings: int = static_field(16)   # crossing buffer capacity per ray
    # Stall detector: a ray that advances less than stall_min_progress in
    # log-time over stall_window attempted steps is grinding at dt_min (the
    # reference burns maxiters=1e5 steps on these before giving up,
    # RayTracer.jl:384,386-391); we cut it early and flag it.  In a lockstep
    # pool one grinding ray holds the whole batch hostage, so this is a
    # first-class performance control.  Set stall_window=0 to disable.
    stall_window: int = static_field(1024)
    stall_min_progress: Any = 1e-8
    # Propagation engine for the tree/backtrace propagations: "pool" (the
    # XLA pool integrator, ops/integrator.py) or "pool_compact" (pool with
    # the backtrace run through host-orchestrated straggler compaction,
    # ops/streaming.CompactedPropagator; single-device driver only).
    # runtime.engine_defaults picks the engine for a platform.
    engine: str = static_field("pool")
    # Work-queue launch width of the forward tree engine (ops/tree.py):
    # each iteration propagates only the W globally heaviest pending lanes
    # of the [E, K] lane grid (the grid is mostly inert — median pending per
    # event is ~1 — but a lockstep launch pays for every lane it carries).
    # 0 = auto: 2*E rounded up to 128, never below 128.  Set to a large
    # value to disable compaction (launch all E*K lanes).
    tree_queue_width: int = static_field(0)
    # Work-queue lanes per event per tree iteration.  0 = auto: 1 under the
    # streaming window (tree_window > 0), else mc_nodes + 2 (the bound on
    # simultaneously-pending nodes).  Cutoffs are checked once per
    # iteration, so a batch may overshoot num_cutoff/max_nodes by up to K-1
    # nodes vs the reference; K=1 is the reference's EXACT per-node cutoff
    # semantics (MainRunner.jl:324-339).  Under the window K=1 also keeps
    # the per-iteration glue and launch width smallest, while the window
    # keeps occupancy high without per-event width.
    tree_k: int = static_field(0)
    # Streaming active window of the forward tree engine (ops/tree.py):
    # pools hold ALL E events of the batch, but each iteration runs only an
    # N-wide window of not-yet-finished events; a finished event's window
    # lane refills IMMEDIATELY from the batch's unstarted events.  Motivation:
    # the per-batch tail — the median event finishes in 2 iterations while
    # the longest MC chain needs ~35, so most iterations of an unwindowed
    # batch run at a few percent occupancy.  Windowing keeps per-iteration
    # cost at the N-event level while amortizing the tail over the whole
    # batch.  Per-event results are BITWISE IDENTICAL to the unwindowed
    # engine (MC draws are keyed by (event key, node index); slot allocation
    # is per event) — only the iteration schedule changes.  0 = off
    # (window == E, per-batch engine).
    tree_window: int = static_field(0)
    # Device->host transfer budget for the finals pack: the driver ships the
    # batch's final nodes as ONE globally-compacted array sized
    # finals_cap_per_event * event_batch rows (tree.compact_finals_global).
    # The observed population is ~2-3 finals/event at production cutoffs;
    # raise this if a run aborts with a finals-capacity error.
    finals_cap_per_event: int = static_field(8)
    # Conversion-probability evaluation width per tree iteration: crossings
    # are a small fraction of launched lanes, so P is evaluated on the W2
    # first crossing lanes (index-packed) with a fallback to all lanes on
    # overflow.  0 = auto (tree_queue_width/4, never below 128).
    tree_prob_width: int = static_field(0)
    # Physics-evaluation dtype: "state" (follow the state dtype) or "f32"
    # (integration state and step arithmetic in the state dtype, fields and
    # Hamiltonians in f32 — endpoint error ~ sqrt(N_steps) * 1e-7, far below
    # the 1e-4 parity contract, BASELINE.md).
    compute_dtype: str = static_field("state")


@_pytree_dataclass
class TreeConfig:
    """Monte-Carlo tree engine parameters (Gen_Samples.jl:94-120)."""

    prob_cutoff: Any = 1e-10    # --probCutoff
    # --- static (control loop bounds / buffer sizes) ---
    num_cutoff: int = static_field(5)     # --numCutoff
    mc_nodes: int = static_field(5)       # --MCNodes
    max_nodes: int = static_field(50)     # --maxNodes
    n_max_sample: int = static_field(6)   # n_maxSample (fixed block, Gen_Samples.jl:174)
    # Conversion-surface sampling measure: True = flat disk measure
    # (find_samples_new, production); False = the legacy 1/r measure of
    # find_samples (RayTracer.jl:1656-1799).
    flat_sampling: bool = static_field(True)
    # Resonance-scan resolution of the reference's fixed block
    # (ntimes_ax, Gen_Samples.jl:169); the sampler's dense line grid plays
    # this role (sampler.default_n_grid matches the production Euler+
    # interp_points resolution when this is left at the default).
    ntimes_ax: int = static_field(50000)


def default_ln_t_end(scene: Scene):
    """Upper log-time bound: one rotation period (MainRunner.jl:412)."""
    return jnp.log(1.0 / scene.omega_pul)
