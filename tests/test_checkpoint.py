"""Checkpoint/resume: a killed run continues with the identical RNG stream
(SURVEY.md §5 failure-recovery rebuild note)."""

import glob
import os

import numpy as np

from adiabatic_raytracer.config import NumericsConfig, Scene, TreeConfig
from adiabatic_raytracer.driver import run

SC = Scene(theta_m=0.2)
CFG = NumericsConfig(interp_points=8, max_crossings=8)
TCFG = TreeConfig(num_cutoff=3, mc_nodes=2, max_nodes=8)


def test_resume_matches_uninterrupted(tmp_path):
    d1 = str(tmp_path / "full")
    d2 = str(tmp_path / "split")
    kw = dict(seed=77, save_mode=1, verbose=False, event_batch=2)

    full = run(SC, CFG, TCFG, 5, dir_tag=d1, **kw)

    # "killed" run: stop after the first batch, checkpoint in place
    part = run(SC, CFG, TCFG, 5, dir_tag=d2, checkpoint=True, max_batches=1,
               **kw)
    assert part is not None
    ck = glob.glob(os.path.join(d2, "npy", ".ckpt_*.json"))
    assert len(ck) == 1
    # no final npy yet
    assert not [p for p in glob.glob(os.path.join(d2, "npy", "*.npy"))
                if not os.path.basename(p).startswith(".")]

    resumed = run(SC, CFG, TCFG, 5, dir_tag=d2, checkpoint=True, resume=True,
                  **kw)
    np.testing.assert_array_equal(full[0], resumed[0])
    assert full[2].f_inx == resumed[2].f_inx
    assert full[2].events == resumed[2].events
    # checkpoint cleared on completion
    assert not glob.glob(os.path.join(d2, "npy", ".ckpt_*"))


def test_vns_decomposition():
    from adiabatic_raytracer.driver import vns_spherical

    mag, th, ph = vns_spherical((0.0, 0.0, 0.0))
    assert (mag, th, ph) == (0.0, 0.0, 0.0)
    mag, th, ph = vns_spherical((1.0, 1.0, 0.0))
    np.testing.assert_allclose(mag, np.sqrt(2))
    np.testing.assert_allclose(th, np.pi / 2)
    np.testing.assert_allclose(ph, np.pi / 4)
