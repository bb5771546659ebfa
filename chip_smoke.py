#!/usr/bin/env python
"""GPU smoke test: the production pipeline end to end on one card.

Phases (each one raises on failure; nothing is caught):

  golden      the fixed-seed CLI run `--Nts 4 --seed 1769 --ThetaM 0.2`
              against the pinned rows of tests/test_e2e.py (rtol 1e-6)
  oracle      photon endpoints and a backtrace crossing against the scipy
              DOP853 oracle of tests/test_oracle.py, integrated on the card
  production  the reference's production deployment (runner_example.sh:
              MassA 1e-5, B0 1e14, ThetaM 0.2, probCutoff 1e-10, numCutoff
              50, MCNodes 10, maxNodes 100; 6,000 events) through the CLI:
              row schema, finite weights, events/s with and without
              compilation, and the seconds spent compiling

With --multi it runs only the four-card phase: the production deployment,
cut to one 512-event batch, with --mesh 4, compared with the one-card rows
of the same seed; both runs share one process.  It needs four cards.

The card's name and power limit are printed first; the last line is one JSON
object {"ok": true, "device": {...}}.  With no GPU, or outside a checkout of
this repository, it exits non-zero and prints no result.

Usage:  python chip_smoke.py [--multi]
"""

import argparse
import glob
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

PRODUCTION = ["--MassA", "1e-5", "--B0", "1e14", "--ThetaM", "0.2",
              "--probCutoff", "1e-10", "--numCutoff", "50", "--MCNodes", "10",
              "--maxNodes", "100", "--seed", "1769"]
N_EVENTS = 6000
N_EVENTS_MULTI = 512    # one batch, 128 events on each of four cards


def _load_test_module(name):
    """Import tests/<name>.py by path (tests/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(dir_tag, ftag):
    return np.load(glob.glob(os.path.join(dir_tag, "npy", f"*_{ftag}.npy"))[0])


def _cli(args):
    from adiabatic_raytracer.cli import main

    assert main(args) == 0, args


def phase_golden(tmp):
    e2e = _load_test_module("test_e2e")
    d = os.path.join(tmp, "golden")
    _cli(["--Nts", "4", "--seed", "1769", "--ThetaM", "0.2", "--saveMode",
          "1", "--event_batch", "3", "--dir_tag", d, "--ftag", "gold"])
    rows = _rows(d, "gold")
    assert rows.shape == (6, 29), rows.shape
    pinned = np.asarray(e2e.GOLDEN_WEIGHTS)
    rel = np.abs(rows[:, 8] - pinned) / np.abs(pinned)
    print(f"golden: 6 rows, weight rel err max {rel.max():.3e} "
          f"(rtol 1e-6)", flush=True)
    np.testing.assert_allclose(rows[:, 8], pinned, rtol=1e-6)


def phase_oracle():
    import jax.numpy as jnp

    from adiabatic_raytracer.ops.geometry import sph_to_cart

    orc = _load_test_module("test_oracle")
    x0 = np.array([17.0, 4.0, 8.0])
    k0 = np.array([-0.8, 0.15, -0.5])
    lnt0, lnt1 = -30.0, float(np.log(1e-2))
    sol = orc._oracle(x0, k0, orc.SC, "photon", lnt0, lnt1)
    end = np.asarray(sph_to_cart(jnp.asarray(sol.y[:3, -1])))
    errs = {}
    for rt, at in ((1e-7, 1e-6), (1e-9, 1e-8)):
        res = orc._run_repo(x0, k0, orc.SC, "photon", lnt0, lnt1, rt, at)
        e = np.asarray(res.traj[0, -1, :])
        errs[rt] = float(np.max(np.abs(e - end) / np.linalg.norm(end)))
    # the limits of tests/test_oracle.py: the tolerance-limited endpoint
    # converges with rtol, well inside the 1e-4 contract at rtol 1e-9
    print(f"oracle: photon endpoint rel err {errs[1e-9]:.3e} at rtol 1e-9 "
          f"(limit 1e-5), {errs[1e-7]:.3e} at rtol 1e-7 (limit 5e-3)",
          flush=True)
    assert errs[1e-9] < 1e-5 and errs[1e-7] < 5e-3, errs
    orc.test_crossing_location_vs_scipy_event()
    orc.test_conversion_prob_pinned_values()
    print("oracle: backtrace crossing (rtol 1e-5) and pinned conversion "
          "probabilities (rtol 1e-8) agree", flush=True)


def _production(d, ftag, n_events, extra=()):
    """One CLI run of the production deployment.

    Returns (rows, wall s, compile s); compile s sums JAX's lowering and
    XLA compile durations inside the run (tracing, which nests, is left
    out)."""
    from jax import monitoring

    spent = {"s": 0.0}

    def on_event(name, secs, **_):
        if name in ("/jax/core/compile/jaxpr_to_mlir_module_duration",
                    "/jax/core/compile/backend_compile_duration"):
            spent["s"] += secs

    monitoring.register_event_duration_secs_listener(on_event)
    try:
        t0 = time.perf_counter()
        _cli(PRODUCTION + ["--Nts", str(n_events + 1), "--dir_tag", d,
                           "--ftag", ftag, *extra])
        wall = time.perf_counter() - t0
    finally:
        monitoring.unregister_event_duration_listener(on_event)
    return _rows(d, ftag), wall, spent["s"]


def _check_rows(rows, n_events):
    assert rows.ndim == 2 and rows.shape[1] == 13, rows.shape
    ev = rows[:, 0]
    assert ev.min() >= 1 and ev.max() <= n_events, (ev.min(), ev.max())
    assert np.all(np.isfinite(rows)), "non-finite values in the rows"
    assert np.all(rows[:, 8] >= 0) and np.any(rows[:, 8] > 0)


def phase_production(tmp):
    from adiabatic_raytracer import runtime

    auto = runtime.current_defaults()
    rows, wall, comp = _production(os.path.join(tmp, "prod"), "prod",
                                   N_EVENTS)
    _check_rows(rows, N_EVENTS)
    print(f"production: {N_EVENTS} events, {rows.shape[0]} rows, "
          f"{N_EVENTS / wall:.2f} events/s with compilation "
          f"({wall:.1f} s wall), {N_EVENTS / max(wall - comp, 1e-9):.2f} "
          f"events/s without ({comp:.1f} s compiling); engine "
          f"{auto['engine']}, batch {auto['event_batch']}", flush=True)


def phase_multi(tmp):
    import jax

    assert len(jax.devices()) >= 4, \
        f"--multi needs four cards, JAX sees {len(jax.devices())}"
    n = N_EVENTS_MULTI
    # the two runs are compile-bound and compile different programs, so they
    # run side by side in two threads (XLA compiles without the GIL); their
    # wall times therefore overlap and are not a speed comparison
    with ThreadPoolExecutor(2) as pool:
        f1 = pool.submit(_production, os.path.join(tmp, "one"), "one", n)
        f4 = pool.submit(_production, os.path.join(tmp, "four"), "four", n,
                         ("--mesh", "4"))
        (one, t1, _), (four, t4, _) = f1.result(), f4.result()
    _check_rows(one, n)
    assert one.shape == four.shape, (one.shape, four.shape)
    for col in (0, 1):  # event number, species: discrete structure
        np.testing.assert_array_equal(one[:, col], four[:, col])
    # continuous columns: the same per-event arithmetic in another batch
    # shape differs only by rounding (fusion and vector widths), which the
    # adaptive step control can amplify to ~1e-7
    rel = np.abs(one - four) / np.maximum(np.abs(one), 1e-300)
    print(f"multi: {n} events, {one.shape[0]} rows; --mesh 4 rows against "
          f"the one-card rows: max rel diff {rel.max():.3e} (limit 1e-6), "
          f"{int(np.sum(np.any(rel > 1e-6, axis=1)))} rows over it; "
          f"one card {t1:.1f} s, four cards {t4:.1f} s, run concurrently "
          f"(compile included)", flush=True)
    np.testing.assert_allclose(four, one, rtol=1e-6, atol=0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ROOT)
    from adiabatic_raytracer import runtime

    runtime.setup_compile_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    scratch = os.path.join(ROOT, "results")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=scratch) as tmp:
        if args.multi:
            phase_multi(tmp)
        else:
            phase_golden(tmp)
            phase_oracle()
            phase_production(tmp)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
