"""Device-mesh scale-out: shard_map over the event axis.

The reference scales by forking N independent processes and merging npy files
(runner_example.sh, combine_files).  Here the same data parallelism is a 1-D
mesh over the *event* axis: every device runs the identical sampler ->
backtrace -> forward-tree pipeline on its shard of events, and the spectrum
reduction is a psum over the device interconnect instead of a filesystem
merge.

Multi-host extension: initialize jax.distributed and build the mesh over all
global devices; nothing below changes (shard_map addresses logical devices).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from adiabatic_raytracer.config import NumericsConfig, Scene, TreeConfig
from adiabatic_raytracer.ops import tree
from adiabatic_raytracer.parallel.reduce import pulse_profile_from_pools

EVENT_AXIS = "ev"


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host initialization (the multi-host analogue of the reference's
    SLURM fan-out, runner_GR_tasks.sh): call once per host before building
    the mesh; afterwards `make_mesh()` spans all global devices and the
    shard_map pipeline is unchanged.

    With a coordinator address, a failed initialization raises.  Without
    one it is a no-op when JAX distributed is already initialized or the
    environment provides no cluster config."""
    try:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except (RuntimeError, ValueError):
        if coordinator is not None:
            raise
        # no coordinator: already initialized or single-process


def make_mesh(n_devices: Optional[int] = None, axis_name: str = EVENT_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def shard_over_events(mesh: Mesh, fn):
    """Wrap fn (all inputs/outputs event-major [E, ...]) in a shard_map over
    the event axis.  The production driver uses this to run its full
    kinematics -> backtrace -> forward-tree pipeline sharded (driver.run
    mesh_devices); RNG must already be carried per event for the result to
    be mesh-size-invariant."""
    ev = P(EVENT_AXIS)
    return jax.shard_map(fn, mesh=mesh, in_specs=ev, out_specs=ev,
                         check_vma=False)


def event_pipeline_sharded(mesh: Mesh, sc: Scene, cfg: NumericsConfig,
                           tcfg: TreeConfig, *, maxR, lnt_end, nbins: int = 50):
    """Build the jitted, sharded per-batch event pipeline.

    Returns fn(seeds[E], xpos[E,3], v_loc[E,3], erg_inf[E]) ->
    (k_init, sln_base, cos_w, backtrace result, tree result,
     (photon_hist, axion_hist) psum-reduced over the mesh).
    E must be divisible by the mesh size; seeds are per-event int32.

    sln_base and the histograms are in DEVICE-SAFE units: multiply by the
    host scalar driver.sln_scale(sc, maxR, tcfg) (~1e36-1e42, beyond the
    f32 range) for the reference's sln_prob / pps.
    """
    from adiabatic_raytracer.driver import _event_kinematics

    def local(seeds, xpos, v_loc, erg_inf):
        k_init, sln_prob, cos_w, _ = _event_kinematics(xpos, v_loc, erg_inf,
                                                       maxR, sc, tcfg)
        bt = tree.backtrace(xpos, k_init, erg_inf, sc, cfg, tcfg, lnt_end=lnt_end)
        # per-event keys from the *global* per-event seeds: the MC tree draws
        # are then invariant to the mesh size (1-device == 8-device rows)
        keys = jax.vmap(jax.random.PRNGKey)(seeds)
        tr = tree.forward_tree(keys, xpos, k_init,
                               erg_inf, sc, cfg, tcfg, lnt_end=lnt_end)
        h_ph, h_ax = pulse_profile_from_pools(tr.pools, bt.samp_back_weight,
                                              sln_prob, nbins=nbins)
        # spectrum reduction across devices — the on-device combine_files
        # equivalent
        h_ph = jax.lax.psum(h_ph, EVENT_AXIS)
        h_ax = jax.lax.psum(h_ax, EVENT_AXIS)
        return k_init, sln_prob, cos_w, bt, tr, (h_ph, h_ax)

    ev = P(EVENT_AXIS)
    rep = P()
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(ev, ev, ev, ev),
        out_specs=(ev, ev, ev, ev, ev, (rep, rep)),
        check_vma=False,
    )
    return jax.jit(fn)


def shard_inputs(mesh: Mesh, *arrays):
    """Place host arrays with the event axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P(EVENT_AXIS))
    return tuple(jax.device_put(a, sharding) for a in arrays)
