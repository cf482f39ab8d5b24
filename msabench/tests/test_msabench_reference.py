"""The plain reference: its frozen oracle against the port's, its
lower-precision control, the tree and projection helpers."""
import numpy as np
import pytest

from msabench import reference, talco_ref


def _pairs(p, n):
    from twilight_tpu_torch.tools import talco_inputs as ti
    rng = np.random.default_rng(7)
    return [ti.make_pair(rng, p, False, int(rng.integers(80, 200)))
            for _ in range(n)]


@pytest.mark.parametrize("p", [6, 22])
def test_frozen_oracle_is_the_ports(p):
    from twilight_tpu_torch.config import Params
    from twilight_tpu_torch.ops import talco_np
    m = Params.make("n" if p == 6 else "p").scoring_matrix
    for prep, meta in _pairs(p, 3):
        fr, fq, _, _, _, go, ge = prep
        num = (meta[2], meta[3])
        want = talco_np.align_freq(
            talco_np.TalcoRunParams(m, -50, -5, -5, 5000), fr, fq, go, ge,
            num)
        got = talco_ref.align_freq(
            talco_ref.TalcoRunParams(m, -50, -5, -5, 5000), fr, fq, go, ge,
            num)
        assert got[1] == want[1] and np.array_equal(got[0], want[0])
        assert 0 < got[2] <= len(fr) * len(fq)


def test_scoring_matrices_are_the_ports():
    import json
    import os
    from conftest import HERE
    from twilight_tpu_torch.config import Params
    for name, t in (("nt_default", "n"), ("protein_blosum62", "p")):
        with open(os.path.join(HERE, "configs", name + ".json")) as f:
            sc = json.load(f)["scoring"]
        assert np.array_equal(reference.scoring_matrix(sc),
                              Params.make(t).scoring_matrix)


def test_bfloat16_control_departs():
    """The control departs from the float32 reference on profile pairs,
    whose fractional scores bfloat16 rounds."""
    sc = {"match": 18.0, "mismatch": -8.0, "transition": -4.0,
          "gap_open": -50.0, "gap_extend": -5.0}
    differ = 0
    for prep, meta in _pairs(6, 3):
        fr, fq, _, _, _, go, ge = prep
        job = {"kind": "freq", "fr": fr, "fq": fq, "go": go, "ge": ge,
               "num": (meta[2], meta[3]), "task": 1, "type": "n",
               "scoring": sc}
        f32 = reference.align_job(job)
        low = reference.align_job({**job, "bf16": True})
        differ += not np.array_equal(f32[0], low[0])
    assert differ >= 2
    assert talco_ref.to_bf16(np.float32(1.0 + 2 ** -9)) == np.float32(1.0)
    assert talco_ref.to_bf16(np.float32(1.0 + 3 * 2 ** -9)) == np.float32(
        1.0 + 2 ** -7)


def test_tree_neighbours_and_projection():
    nbr = reference.tree_neighbours("((A:1,B:1):1,(C:1,(D:1,E:1):1):1);")
    assert nbr["A"] == nbr["B"] and nbr["D"] == nbr["E"]
    assert nbr["C"] != nbr["D"] and nbr["A"] != nbr["C"]
    # a root of two children: its leaf child neighbours the other child
    nbr = reference.tree_neighbours("(A:1,(B:1,C:1):1);")
    assert nbr["A"] == nbr["B"] == nbr["C"]
    path = reference.projection(b"AC--GT-", b"A-T-G-C")
    assert path.tolist() == [0, 2, 1, 0, 2, 1]


def test_rows_wrong():
    inputs = {"a": b"ACGT", "b": b"AGT"}
    assert reference.rows_wrong({"a": b"ACGT", "b": b"A-GT"}, [], inputs) == 0
    assert reference.rows_wrong({"a": b"ACGT", "b": b"A-CT"}, [], inputs) == 1
    assert reference.rows_wrong({"a": b"ACGT", "b": b"AGT"}, [], inputs) == 2
    assert reference.rows_wrong({"a": b"ACGT"}, [], inputs) == 1
