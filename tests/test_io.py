"""Filename encoding and shard-combine tests (vs Gen_Samples.jl:195-239,
MainRunner.jl:750-761)."""

import numpy as np

from adiabatic_raytracer.utils.format import julia_float_str, julia_str
from adiabatic_raytracer.utils.npyio import combine_files, save_npy, tree_filename


def test_julia_float_repr():
    # values checked against Julia's string(x)
    cases = {
        1e-5: "1.0e-5", 2e-5: "2.0e-5", 1e-12: "1.0e-12", 0.2: "0.2",
        1.0: "1.0", 1e14: "1.0e14", 10.0: "10.0", 0.0: "0.0",
        123456.0: "123456.0", 1234567.0: "1.234567e6", 0.45: "0.45",
        3.16e13: "3.16e13", 0.0001: "0.0001", 1e6: "1.0e6",
        999999.9: "999999.9", -0.5: "-0.5", 2.5e-5: "2.5e-5", 100.0: "100.0",
    }
    for x, want in cases.items():
        assert julia_float_str(x) == want, (x, julia_float_str(x), want)
    assert julia_str(100) == "100"


def test_tree_filename_matches_reference_encoding():
    name = tree_filename("results", 1e-5, 1e-12, 0.2, 1.0, 1e14, 100, 3, 5, 5,
                         50, "tag")
    assert name == ("results/npy/tree_MassAx_1.0e-5_AxionG_1.0e-12_ThetaM_0.2"
                    "_rotPulsar_1.0_B0_1.0e14_Ax_trajs_100_N_Times_3"
                    "_num_cutoff_5_MC_nodes_5_max_nodes_50_tag.npy")


def test_combine(tmp_path):
    d = str(tmp_path)
    rows = []
    for i in range(3):
        arr = np.full((2, 13), float(i + 1))
        arr[:, 0] = 1  # event numbers
        rows.append(arr)
        save_npy(tree_filename(d, 1e-5, 1e-12, 0.2, 1.0, 1e14, 10, 3, 5, 5, 50,
                               f"t{i}"), arr)
    out = combine_files(d, 1e-5, 1e-12, 0.2, 1.0, 1e14, 10, 3, 5, 5, 50, "t", 3)
    merged = np.load(out)
    assert merged.shape == (6, 13)
    # Julia semantics: column 8 (1-based) divided by Nruns
    np.testing.assert_allclose(merged[0, 7], 1.0 / 3)
    np.testing.assert_allclose(merged[4, 7], 3.0 / 3)
    # other columns untouched
    np.testing.assert_allclose(merged[4, 5], 3.0)
    # shards deleted
    import glob, os

    assert not glob.glob(os.path.join(d, "npy", "*.npy"))


def test_combine_renumber_and_missing(tmp_path):
    """Opt-in Combine_Files.py behaviors: compounding event renumbering
    (line 22) and glob-whatever-exists fault tolerance (lines 10-25)."""
    d = str(tmp_path)
    # shards 0, 1, 3 exist (shard 2 "died"); events numbered per-shard
    for i, n_ev in ((0, 2), (1, 3), (3, 2)):
        arr = np.full((n_ev, 13), 2.0)
        arr[:, 0] = np.arange(1, n_ev + 1)  # per-shard event ids 1..n
        save_npy(tree_filename(d, 1e-5, 1e-12, 0.2, 1.0, 1e14, 10, 3, 5, 5, 50,
                               f"t{i}"), arr)
    out = combine_files(d, 1e-5, 1e-12, 0.2, 1.0, 1e14, 10, 3, 5, 5, 50, "t",
                        4, renumber_events=True, allow_missing=True)
    merged = np.load(out)
    assert merged.shape == (7, 13)
    # compounding offsets: shard1 += 2 (last id of shard0), shard3 += 5
    np.testing.assert_allclose(merged[:, 0], [1, 2, 3, 4, 5, 6, 7])
    # sln_prob divided by the number of shards actually merged (nfiles=3)
    np.testing.assert_allclose(merged[:, 7], 2.0 / 3)
    # all-missing raises
    import pytest

    with pytest.raises(FileNotFoundError):
        combine_files(d, 1e-5, 1e-12, 0.2, 1.0, 1e14, 10, 3, 5, 5, 50, "t",
                      4, allow_missing=True)
