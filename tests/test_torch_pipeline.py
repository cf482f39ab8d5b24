"""The port's own copies of the host pipeline (configuration, command line,
simulator, NumPy oracle, the progressive pipeline), each held to its
original in the JAX package on the same inputs, and the two command lines
held to each other end to end with --backend native (md5 of the output)."""
import dataclasses
import hashlib
import os
import re

import numpy as np
import pytest

from twilight_tpu import cli as tpu_cli
from twilight_tpu import config as tpu_config
from twilight_tpu.ops import talco_np as tpu_talco_np
from twilight_tpu.tools import simulate as tpu_simulate
from twilight_tpu_torch import cli, config
from twilight_tpu_torch.ops import talco_np
from twilight_tpu_torch.tools import simulate

from conftest import DATA, random_profile_pair

NT_MATRIX = "A C G T\n" + "\n".join(
    " ".join(str(v) for v in row) for row in
    [[9, -3, -1, -3], [-3, 9, -3, -1], [-1, -3, 9, -3], [-3, -1, -3, 9]])


def _aa_matrix():
    rng = np.random.default_rng(4)
    m = rng.integers(-6, 12, (20, 20))
    m = m + m.T
    return " ".join("ACDEFGHIKLMNPQRSTVWY") + "\n" + "\n".join(
        " ".join(str(v) for v in row) for row in m)


def _md5(path):
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


@pytest.mark.parametrize("type_,kw", [
    ("n", {}),
    ("p", {}),
    ("n", {"wildcard": True}),
    ("p", {"wildcard": True, "blosum": 80}),
    ("p", {"blosum": 45, "gap_open": -30, "gap_extend": -2, "gap_ends": -1,
           "xdrop_scale": 250.5}),
    ("n", {"match": 10, "mismatch": -3, "transition": -1, "gap_extend": 0}),
    ("n", {"matrix": NT_MATRIX}),
    ("n", {"matrix": NT_MATRIX, "wildcard": True}),
    ("p", {"matrix": _aa_matrix(), "wildcard": True}),
], ids=["nt", "protein", "nt-wildcard", "protein-wildcard-b80",
        "protein-gaps-b45", "nt-scores", "nt-matrix", "nt-matrix-wildcard",
        "protein-matrix-wildcard"])
def test_params_make_field_by_field(tmp_path, type_, kw):
    kw = dict(kw)
    if "matrix" in kw:
        path = tmp_path / "matrix.txt"
        path.write_text(kw.pop("matrix"))
        kw["matrix_file"] = str(path)
    want = tpu_config.Params.make(type_, **kw)
    got = config.Params.make(type_, **kw)
    names = [f.name for f in dataclasses.fields(want)]
    assert names == [f.name for f in dataclasses.fields(got)]
    for name in names:
        w, g = getattr(want, name), getattr(got, name)
        assert type(w) is type(g), name
        if isinstance(w, np.ndarray):
            assert w.dtype == g.dtype and w.shape == g.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w, name
    assert config.TalcoParams.from_params(got).xdrop \
        == tpu_config.TalcoParams.from_params(want).xdrop


def test_build_parser_dests_and_defaults():
    """Same flags, destinations, defaults, types and actions; only
    --backend's choices (cuda for tpu) and the help text may differ."""
    want = tpu_cli.build_parser()._actions
    got = cli.build_parser()._actions
    assert [a.dest for a in got] == [a.dest for a in want]
    for w, g in zip(want, got):
        assert (g.option_strings, g.default, g.type, g.nargs, g.required,
                g.const, type(g)) == (w.option_strings, w.default, w.type,
                                      w.nargs, w.required, w.const,
                                      type(w)), w.dest
        if w.dest != "backend":
            assert g.choices == w.choices, w.dest
    backend = {a.dest: a for a in got}["backend"]
    assert tuple(backend.choices) == cli.BACKENDS
    assert "cuda" in backend.choices and "tpu" not in backend.choices


@pytest.mark.parametrize("type_", ["n", "p"])
def test_simulate_byte_equal(tmp_path, type_):
    for seed in (1, 2, 3):
        argv = ["-n", "17", "-l", "150", "--seed", str(seed), "--type",
                type_]
        want, got = str(tmp_path / f"w{seed}"), str(tmp_path / f"g{seed}")
        assert tpu_simulate.main(argv + ["-o", want]) == 0
        assert simulate.main(argv + ["-o", got]) == 0
        for ext in (".fa", ".nwk"):
            with open(want + ext, "rb") as f:
                w = f.read()
            with open(got + ext, "rb") as f:
                assert f.read() == w, (seed, ext)


@pytest.mark.parametrize("lens,marker,gap_char", [
    ((40, 52), 1024, -5.0), ((300, 280), 1024, -5.0), ((700, 650), 64, 0.0),
    ((120, 20), 1024, 0.0)])
def test_talco_np_align_freq_equals_original(lens, marker, gap_char):
    rng = np.random.default_rng(sum(lens) + marker)
    param = config.Params.make("n")
    fr, fq = random_profile_pair(rng, *lens)
    go = (np.full(lens[0], -50.0, np.float32),
          np.full(lens[1], -50.0, np.float32))
    ge = (np.full(lens[0], -5.0, np.float32),
          np.full(lens[1], -5.0, np.float32))
    got = talco_np.align_freq(
        talco_np.TalcoRunParams(param.scoring_matrix, -50.0, -5.0, gap_char,
                                param.xdrop, marker=marker),
        fr, fq, go, ge, (1.0, 1.0))
    want = tpu_talco_np.align_freq(
        tpu_talco_np.TalcoRunParams(param.scoring_matrix, -50.0, -5.0,
                                    gap_char, param.xdrop, marker=marker),
        fr, fq, go, ge, (1.0, 1.0))
    assert got[1] == want[1]
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))


# ---------------------------------------------------------------------------
# end to end: python -m twilight_tpu_torch against python -m twilight_tpu,
# both --backend native, on small simulated sets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sim_set(tmp_path_factory):
    """240 simulated sequences of ~500 bases (seed 11)."""
    prefix = str(tmp_path_factory.mktemp("sim") / "sim240")
    assert simulate.main(["-n", "240", "-l", "500", "--seed", "11",
                          "-o", prefix]) == 0
    return ["-t", prefix + ".nwk", "-i", prefix + ".fa"]


def _renamed_set(d, tag, seed):
    """A simulated set of 40 sequences whose names carry `tag`."""
    prefix = os.path.join(d, tag)
    assert simulate.main(["-n", "40", "-l", "500", "--seed", str(seed),
                          "-o", prefix]) == 0
    for ext in (".fa", ".nwk"):
        with open(prefix + ext) as f:
            text = re.sub(r"\bS(\d+)\b", rf"{tag}_S\1", f.read())
        with open(prefix + ext, "w") as f:
            f.write(text)
    return prefix


def _merge_dir(tmp_path):
    """Three MSAs of disjoint sequence sets, written by the JAX CLI."""
    work, msas = tmp_path / "sets", tmp_path / "msas"
    work.mkdir()
    msas.mkdir()
    for i, tag in enumerate(("a", "b", "c")):
        prefix = _renamed_set(str(work), tag, 20 + i)
        assert tpu_cli.main(["-t", prefix + ".nwk", "-i", prefix + ".fa",
                             "-o", str(msas / f"{tag}.aln"), "--backend",
                             "native", "-C", "2"]) == 0
    return ["-f", str(msas)]


def _backbone(tmp_path, sim_set):
    """Placement inputs from sim_set: its first 200 sequences aligned by
    the JAX CLI on their pruned true tree, and the other 40 as queries."""
    from twilight_tpu.phylo.tree import Tree
    from twilight_tpu.seqio.fasta import iter_fasta

    seqs = {n: s for n, _, s in iter_fasta(sim_set[3])}
    names = list(seqs)
    bb_fa, q_fa = str(tmp_path / "bb.fa"), str(tmp_path / "q.fa")
    for path, part in ((bb_fa, names[:200]), (q_fa, names[200:])):
        with open(path, "w") as f:
            f.writelines(f">{n}\n{seqs[n]}\n" for n in part)
    bb_nwk, bb_aln = str(tmp_path / "bb.nwk"), str(tmp_path / "bb.aln")
    pruned = Tree.from_newick_file(sim_set[1]).prune(set(names[:200]))
    with open(bb_nwk, "w") as f:
        f.write(pruned.get_newick_string() + "\n")
    assert tpu_cli.main(["-t", bb_nwk, "-i", bb_fa, "-o", bb_aln,
                         "--backend", "native", "-C", "2"]) == 0
    return ["-a", bb_aln, "-i", q_fa]


@pytest.mark.parametrize("case", ["default", "rooted", "length_deviation",
                                  "divide_and_conquer", "merge", "protein",
                                  "place_without_tree", "place_with_tree"])
def test_cli_native_md5_equals_jax_cli(tmp_path, sim_set, case):
    if case == "merge":
        argv = _merge_dir(tmp_path)
    elif case == "place_without_tree":
        argv = _backbone(tmp_path, sim_set)
    elif case == "place_with_tree":
        # the full true tree holds the backbone's leaves and the queries'
        argv = _backbone(tmp_path, sim_set) + ["-t", sim_set[1]]
    elif case == "protein":
        argv = ["-t", f"{DATA}/prot_16.nwk", "-i", f"{DATA}/prot_16.fa",
                "--type", "p"]
    else:
        argv = sim_set + {"default": [], "rooted": ["--rooted"],
                          "length_deviation": ["--length-deviation", "0.02"],
                          "divide_and_conquer": ["-m", "60"]}[case]
    outs = {}
    for tag, entry in (("jax", tpu_cli.main), ("port", cli.main)):
        extra = []
        if case in ("divide_and_conquer", "merge", "place_without_tree"):
            extra = ["-d", str(tmp_path / f"temp_{tag}")]
        outs[tag] = str(tmp_path / f"{tag}.aln")
        assert entry(argv + extra + ["-o", outs[tag], "--backend", "native",
                                     "-C", "2"]) == 0, tag
    assert _md5(outs["port"]) == _md5(outs["jax"])
    if case == "protein":
        assert _md5(outs["port"]) == "8174145594cfcd5404008e233e10ea30"
