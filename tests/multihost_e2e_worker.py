"""Worker for the 2-process multi-host END-TO-END test: the full
runner_GR_tasks.sh workflow step — initialize jax.distributed, then run one
complete shard through the production CLI (driver.run -> npy shard).

Usage: python multihost_e2e_worker.py <port> <nprocs> <pid> <dir_tag>
"""

import os
import sys

port, nprocs, pid, dir_tag = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
os.environ.setdefault("JAX_ENABLE_X64", "true")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from adiabatic_raytracer.cli import main  # noqa: E402

# the CLI's multi-host flags (--coordinator/--nprocs/--procid) drive
# parallel.mesh.init_distributed exactly like a SLURM task would
rc = main(["--Nts", "4", "--seed", str(1769 + pid), "--ThetaM", "0.2",
           "--saveMode", "1", "--event_batch", "3", "--platform", "cpu",
           "--dir_tag", dir_tag, "--ftag", f"mh_{pid}",
           "--coordinator", f"127.0.0.1:{port}", "--nprocs", str(nprocs),
           "--procid", str(pid)])
assert rc == 0
assert jax.process_count() == nprocs
print("worker", pid, "shard done")
