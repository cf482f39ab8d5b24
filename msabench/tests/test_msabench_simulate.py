"""The frozen simulator repeats from a seed; a seed changes the letters,
not the tree or the sizes."""
import numpy as np

from msabench.simulate import simulate


def test_repeats_from_a_seed():
    a = simulate({"n": 30, "length": 200}, "n", "cell", 3, 2 ** 31 + 11)
    b = simulate({"n": 30, "length": 200}, "n", "cell", 3, 2 ** 31 + 11)
    assert a == b


def test_seed_changes_letters_not_the_tree():
    a = simulate({"n": 40, "length": 300}, "p", "cell", 0, 1)
    b = simulate({"n": 40, "length": 300}, "p", "cell", 0, 2)
    assert a[2] == b[2] and a[0] == b[0]
    assert a[1] != b[1]
    assert abs(np.mean([len(s) for s in a[1]])
               - np.mean([len(s) for s in b[1]])) < 15
    assert set("".join(a[1])) <= set("ACDEFGHIKLMNPQRSTVWY")


def test_index_changes_letters_not_the_tree():
    a = simulate({"n": 40, "length": 100}, "n", "cell", 0, 1)
    b = simulate({"n": 40, "length": 100}, "n", "cell", 1, 1)
    c = simulate({"n": 40, "length": 100}, "n", "other", 0, 1)
    assert a[2] == b[2] and a[1] != b[1]
    assert a[2] != c[2]


def test_beta_splitting_weights():
    from msabench.simulate import split_weights
    assert np.allclose(split_weights(9, 0.0), 1 / 8)    # uniform splits
    w = split_weights(50, -1.2)
    assert np.isclose(w.sum(), 1.0) and np.allclose(w, w[::-1])
    assert w[0] > w[24]     # lower beta: lopsided splits more likely


def test_generator_parameters_shape_the_set():
    g = {"n": 60, "length": 200, "split_beta": -1.2,
         "leaf_time": [1.0, 10.0], "indel_lengths": [1], "indel_rate": 0}
    names, seqs, nwk = simulate(g, "n", "cell", 0, 5)
    assert len(names) == 60 and {len(s) for s in seqs} == {200}
    # every leaf's branch is drawn from leaf_time
    lens = [float(x.split(":")[1]) for x in nwk.replace(")", ",").split(",")
            if x.startswith("S")]
    assert min(lens) >= 1.0 and max(lens) < 10.0
