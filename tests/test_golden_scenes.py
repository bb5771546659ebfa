"""Pinned rows over the reference's runner scenes on the f64 pool path.

Each scene is a fixed-seed CLI run (`--Nts 4 --seed 1769 --saveMode 1
--event_batch 3`) with the flags of one of the reference's runner scripts
(runner_tree.sh, runner_convergence.sh, runner_example.sh); the weights
(column 8) are pinned.  Re-pin deliberately if a semantics change is
intended."""

import glob
import os

import numpy as np
import pytest

from adiabatic_raytracer.cli import main

SCENES = {
    # runner_tree.sh: axion mass x coupling grid
    "tree_m2e-5": (["--MassA", "2e-5", "--Axg", "1e-12"],
                   [1.50029389e-02, 1.24401303e-04, 5.25157116e-02,
                    2.23779198e-02]),
    "tree_m2e-5_g1e-13": (["--MassA", "2e-5", "--Axg", "1e-13"],
                          [1.54517259e-04, 1.27599556e-08, 5.89445183e-04,
                           2.28372593e-04]),
    # runner_convergence.sh: coupling sweep and probCutoff sweep
    "coupling_1e-14": (["--Axg", "1e-14"],
                       [1.51224348e-07, 1.37658731e-06, 1.37259477e-06]),
    "prob_1e-11": (["--probCutoff", "1e-11"],
                   [1.49700414e-03, 1.34376923e-02, 1.35216402e-02]),
    # runner_example.sh: the production cutoffs
    "production": (["--ThetaM", "0.2", "--probCutoff", "1e-10",
                    "--numCutoff", "50", "--MCNodes", "10",
                    "--maxNodes", "100"],
                   [1.37646785e-03, 1.04814701e-02, 8.54149604e-05,
                    6.64345269e-05, 3.15848565e-07, 7.85425213e-04]),
    "coupling_3.16e-13": (["--Axg", "3.16e-13", "--ThetaM", "0.2"],
                          [1.43882423e-04, 1.07170018e-03, 8.66859476e-07,
                           6.76368554e-07, 3.19555378e-10, 7.86120270e-05]),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_runner_scene_pinned_rows(name, tmp_path):
    flags, weights = SCENES[name]
    d = str(tmp_path)
    assert main(["--Nts", "4", "--seed", "1769", "--saveMode", "1",
                 "--event_batch", "3", "--platform", "cpu", "--dir_tag", d,
                 "--ftag", "g"] + flags) == 0
    rows = np.load(glob.glob(os.path.join(d, "npy", "*_g.npy"))[0])
    assert rows.shape == (len(weights), 29)
    assert np.all(np.isfinite(rows))
    np.testing.assert_allclose(rows[:, 8], weights, rtol=1e-6)
