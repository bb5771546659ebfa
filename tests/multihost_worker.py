"""Worker process for the 2-process jax.distributed smoke test.

Usage: python multihost_worker.py <port> <nprocs> <pid> <out_json>
Each process owns ONE virtual CPU device; the global mesh spans both
processes over the host network (gloo).  Validates the multi-host path of
parallel/mesh.py: init_distributed -> make_mesh -> shard_over_events with a
psum reduction (the on-device combine_files equivalent).
"""

import json
import os
import sys

port, nprocs, pid, out_path = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                               sys.argv[4])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
os.environ.setdefault("JAX_ENABLE_X64", "true")

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from adiabatic_raytracer.parallel.mesh import (
    EVENT_AXIS, init_distributed, make_mesh, shard_over_events)

init_distributed(f"127.0.0.1:{port}", nprocs, pid)
assert jax.process_count() == nprocs, jax.process_count()
assert len(jax.devices()) == nprocs, jax.devices()
assert jax.local_device_count() == 1

mesh = make_mesh()
E = 8
vals = (np.arange(E, dtype=np.float64) + 1.0) ** 2
sh = NamedSharding(mesh, P(EVENT_AXIS))
garr = jax.make_array_from_callback((E,), sh, lambda idx: vals[idx])


def local(v):
    # local shard reduction + cross-host psum over the network
    tot = jax.lax.psum(jnp.sum(v), EVENT_AXIS)
    return jnp.broadcast_to(tot, v.shape)


out = jax.jit(shard_over_events(mesh, local))(garr)
local_vals = np.asarray(out.addressable_data(0))
result = {
    "pid": pid,
    "process_count": jax.process_count(),
    "global_devices": len(jax.devices()),
    "psum_total": float(local_vals[0]),
    "all_equal": bool(np.all(local_vals == local_vals[0])),
    "expected": float(vals.sum()),
}
with open(out_path, "w") as f:
    json.dump(result, f)
print("worker", pid, "ok", result["psum_total"])
