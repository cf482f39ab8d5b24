"""The pipeline layer's reference: leaf weights against the port's after
its reroot, and the merge's path with gappy columns cut."""
import os

import numpy as np
import pytest

from msabench import pipeline_ref
from msabench.simulate import simulate


def test_weights_by_hand():
    # rooted at the old root, 0: A 1 + 0.5/2, B 2 + 0.5/2, C 1 + 1/3,
    # D 1 + 1/2 + 1/3, E (zero length -> the least, 0.5) 0.5 + 1/2 + 1/3
    nwk = "((A:1,B:2):0.5,(C:1,(D:1,E:0):1):1);"
    nbr, lens, names = pipeline_ref.parse_tree(nwk)
    assert pipeline_ref.centres(nbr, names) == [0, 4]
    w = pipeline_ref.leaf_weights(nbr, lens, names, 0)
    raw = {"A": 1.25, "B": 2.25, "C": 4 / 3, "D": 11 / 6, "E": 4 / 3}
    assert all(np.isclose(w[k], v / 2.25) for k, v in raw.items())


@pytest.mark.parametrize("beta", [0.0, -1.2])
def test_weights_are_the_ports(tmp_path, beta):
    from twilight_tpu_torch.phylo.tree import Tree
    for k in range(6):
        _, _, nwk = simulate({"n": 80, "length": 10, "split_beta": beta,
                              "leaf_time": [1.0, 10.0]}, "n", f"w{k}", 0, 0)
        path = os.path.join(tmp_path, f"{k}.nwk")
        with open(path, "w") as f:
            f.write(nwk + "\n")
        t = Tree.from_subtree(Tree.from_newick_file(path).root, True)
        port = {n.identifier: n.weight for n in t.all_nodes.values()
                if n.is_leaf()}
        errs = [max(abs(ws[n] - port[n]) / port[n] for n in port)
                for ws in pipeline_ref.weight_sets(nwk)]
        assert min(errs) < 1e-5


def test_merge_path_cuts_gappy_columns():
    rows = {"r1": b"AC-GT", "r2": b"A--GT", "q1": b"-CAG-"}
    proj = pipeline_ref.merge_projection(rows, ["r1", "r2"], ["q1"])
    assert proj[0].tolist() == [2, 0, 1, 0, 2]
    keep_r = np.array([True, False, True, True])    # r's column 1 gappy
    keep_q = np.array([True, True, True])
    assert pipeline_ref.compact_path(proj, keep_r, keep_q) is None
    keep_r = np.array([False, True, True, True])
    assert pipeline_ref.compact_path(proj, keep_r, keep_q).tolist() == [
        0, 1, 0, 2]
    # a side whose columns are not its profile's
    assert pipeline_ref.compact_path(proj, keep_r[:3], keep_q) is None


def test_profile_and_gappy_columns():
    codes = np.array([[0, 5, 1], [0, 5, 5], [2, 5, 5]])
    prof = pipeline_ref.profile(codes, np.array([1.0, 0.5, 1.5]), 6)
    assert prof[:, 5].tolist() == [0, 3, 2] and prof[0, 0] == 1.5
    assert pipeline_ref.gappy_keep(prof, 3).tolist() == [True, False, True]
