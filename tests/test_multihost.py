"""Two-process jax.distributed smoke test (CPU, host network via gloo).

The multi-host analogue of the reference's SLURM fan-out
(runner_GR_tasks.sh:1-28): two OS processes, one virtual CPU device each,
form a global mesh through parallel.mesh.init_distributed and run a
shard_map + psum reduction.  Asserts the global mesh forms (2 processes,
2 global devices) and the psum'd total matches the single-process value.
"""

import json
import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh_psum(tmp_path):
    port = _free_port()
    nprocs = 2
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(HERE)] + env.get("PYTHONPATH", "").split(os.pathsep))
    procs = []
    outs = []
    for pid in range(nprocs):
        out = tmp_path / f"worker_{pid}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "multihost_worker.py"),
             str(port), str(nprocs), str(pid), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-2000:]
    for out in outs:
        res = json.loads(out.read_text())
        assert res["process_count"] == 2
        assert res["global_devices"] == 2
        assert res["all_equal"]
        assert res["psum_total"] == res["expected"]


def test_two_process_end_to_end_shards_and_combine(tmp_path):
    """The complete runner_GR_tasks.sh workflow (runner_GR_tasks.sh:22-28 +
    Gen_Samples.jl:195-239) over jax.distributed: two processes each run a
    full CLI shard (distinct ftag + seed), the shards are combined, and the
    merged npy is byte-identical to the same two shards run sequentially in
    ONE process without jax.distributed — multi-host initialization must not
    perturb the physics, and the file-merge semantics must compose."""
    import numpy as np

    from adiabatic_raytracer.cli import main as cli_main

    port = _free_port()
    nprocs = 2
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(HERE)] + env.get("PYTHONPATH", "").split(os.pathsep))
    # share the suite's persistent compile cache (the shard shapes match the
    # golden run's, so the workers' jits are warm)
    env.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.abspath(
        os.path.join(HERE, os.pardir, ".jax_cache")))
    d_mh = str(tmp_path / "mh")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "multihost_e2e_worker.py"),
         str(port), str(nprocs), str(pid), d_mh],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(nprocs)]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-2000:]

    # sequential single-process reference shards (same seeds/ftags)
    d_seq = str(tmp_path / "seq")
    for pid in range(nprocs):
        assert cli_main(["--Nts", "4", "--seed", str(1769 + pid), "--ThetaM",
                         "0.2", "--saveMode", "1", "--event_batch", "3",
                         "--platform", "cpu", "--dir_tag", d_seq,
                         "--ftag", f"mh_{pid}"]) == 0

    combine_args = ["--run_RT", "0", "--run_Combine", "1", "--side_runs", "2",
                    "--Nts", "4", "--ThetaM", "0.2", "--saveMode", "1",
                    "--platform", "cpu", "--ftag", "mh_", "--numCutoff", "5",
                    "--MCNodes", "5", "--maxNodes", "50"]
    assert cli_main(combine_args + ["--dir_tag", d_mh]) == 0
    assert cli_main(combine_args + ["--dir_tag", d_seq]) == 0

    merged_mh = [f for f in os.listdir(d_mh) if f.endswith(".npy")]
    merged_seq = [f for f in os.listdir(d_seq) if f.endswith(".npy")]
    assert merged_mh == merged_seq and len(merged_mh) == 1
    a = np.load(os.path.join(d_mh, merged_mh[0]))
    b = np.load(os.path.join(d_seq, merged_seq[0]))
    assert a.shape[0] >= 2 and a.shape[1] == 29
    np.testing.assert_array_equal(a, b)
    # shards were deleted by the combine (Gen_Samples.jl:235-237)
    assert not [f for f in os.listdir(os.path.join(d_mh, "npy"))
                if f.endswith(".npy")]
