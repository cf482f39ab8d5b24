"""The port's guide-tree estimation (twilight_tpu_torch.trees) held to the
JAX package's (twilight_tpu.trees) on the same inputs, made from a numpy
seed: k-mer profiles, distances and trees bit for bit on the host; the
card route's plain version (`pair_counts_on` on a CPU device) against
NumPy; the route each product takes (the Gram product never leaves the
host); and the external tree-tool adapters against mock binaries (the
same argv, the same Newick)."""
import os
import re
import stat

import numpy as np
import pytest
import torch

from twilight_tpu.trees import estimate as tpu_estimate
from twilight_tpu.trees import external as tpu_external
from twilight_tpu.trees import nj as tpu_nj
from twilight_tpu.workflow import placement as tpu_placement
from twilight_tpu_torch.trees import estimate, external, nj
from twilight_tpu_torch.workflow import placement

CUDA = torch.device("cuda")     # never reached: the card functions are stubbed


def _seqs(rng, n, length, alphabet, odd=b"-N"):
    """n related sequences over `alphabet` with some gaps and ambiguity
    bytes, lengths varying by up to 10%."""
    letters = np.frombuffer(alphabet, dtype=np.uint8)
    base = rng.integers(0, len(letters), length)
    out = []
    for _ in range(n):
        s = base.copy()
        mut = rng.random(length) < 0.1
        s[mut] = rng.integers(0, len(letters), int(mut.sum()))
        s = letters[s]
        bad = rng.random(length) < 0.01
        s[bad] = np.frombuffer(odd, dtype=np.uint8)[
            rng.integers(0, len(odd), int(bad.sum()))]
        cut = int(rng.integers(0, length // 10 + 1))
        out.append(s[cut:].tobytes().decode())
    return out


def _aligned_rows(rng, n, cols, alphabet=b"ACGT"):
    """n rows of `cols` aligned columns: related letters, runs of gaps,
    gappy columns and an occasional N."""
    letters = np.frombuffer(alphabet, dtype=np.uint8)
    base = rng.integers(0, len(letters), cols)
    mat = np.empty((n, cols), dtype=np.uint8)
    for i in range(n):
        s = base.copy()
        mut = rng.random(cols) < 0.15
        s[mut] = rng.integers(0, len(letters), int(mut.sum()))
        mat[i] = letters[s]
        for _ in range(3):
            a = int(rng.integers(0, cols))
            mat[i, a:a + int(rng.integers(1, 20))] = ord("-")
    mat[:, rng.random(cols) < 0.05] = ord("-")       # gappy columns
    mat[rng.random((n, cols)) < 0.002] = ord("N")
    mat[:, 7] = ord(".")
    return [r.tobytes().decode() for r in mat]


@pytest.mark.parametrize("type_", ["nt", "protein"])
def test_kmer_profiles_bit_equal(type_):
    rng = np.random.default_rng(1)
    alphabet = b"ACGT" if type_ == "nt" else b"ACDEFGHIKLMNPQRSTVWY"
    seqs = _seqs(rng, 40, 300, alphabet, b"-N" if type_ == "nt" else b"-X*")
    seqs += ["ACG", "NNNNNNNNNNNN", "acgtnacgtacgtacgt"]
    got = estimate.kmer_profiles(seqs)
    want = tpu_estimate.kmer_profiles(seqs)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n", [60, 300])
def test_pairwise_distances_bit_equal_on_the_host(n):
    rng = np.random.default_rng(2)
    prof = tpu_estimate.kmer_profiles(_seqs(rng, n, 400, b"ACGT"))
    got = estimate.pairwise_distances(prof)
    want = tpu_estimate.pairwise_distances(prof)
    assert got.dtype == np.float64
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n", [200, 300], ids=["loop-200", "blas-300"])
def test_msa_distances_bit_equal(n):
    rng = np.random.default_rng(3)
    rows = _aligned_rows(rng, n, 500)
    got = estimate.msa_distances(rows)
    want = tpu_estimate.msa_distances(rows)
    assert got.tobytes() == want.tobytes()


def test_msa_distances_subsample_columns_bit_equal():
    """Past max_cols the columns are subsampled the same way."""
    rng = np.random.default_rng(4)
    rows = _aligned_rows(rng, 260, 900)
    got = estimate.msa_distances(rows, max_cols=256)
    want = tpu_estimate.msa_distances(rows, max_cols=256)
    assert got.tobytes() == want.tobytes()


def _additive():
    d = np.array([[0, 5, 7, 8], [5, 0, 8, 9], [7, 8, 0, 9], [8, 9, 9, 0]],
                 dtype=float)
    return d, ["A", "B", "C", "D"]


def _random_metric():
    rng = np.random.default_rng(5)
    pts = rng.random((30, 6))
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    return d, [f"s{i}" for i in range(30)]


@pytest.mark.parametrize("make", [_additive, _random_metric],
                         ids=["additive", "random-metric"])
def test_neighbor_joining_newick_equal(make):
    d, names = make()
    got = nj.neighbor_joining(d, names)
    assert got == tpu_nj.neighbor_joining(d, names)
    if make is _additive:
        assert "(A:2.000000,B:3.000000)" in got


@pytest.mark.parametrize("aligned", [False, True],
                         ids=["kmer", "msa"])
def test_build_guide_tree_parttree_equal(aligned):
    """300 rows with nj_cap=50 recurse through PartTree."""
    rng = np.random.default_rng(6)
    seqs = (_aligned_rows(rng, 300, 400) if aligned
            else _seqs(rng, 300, 400, b"ACGT"))
    names = [f"S{i}" for i in range(300)]
    steps = []
    got = estimate.build_guide_tree(names, seqs, aligned=aligned, nj_cap=50,
                                    steps=steps)
    assert got == tpu_estimate.build_guide_tree(names, seqs, aligned=aligned,
                                                nj_cap=50)
    want_steps = (["msa distances", "nj"] if aligned
                  else ["kmer", "gram", "nj"])
    assert [s for s, _ in steps] == want_steps


# ---------------------------------------------------------------------------
# the card route's products, as their plain versions on a CPU device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blocks", [False, True],
                         ids=["one-product", "row-blocks"])
def test_host_gram(monkeypatch, blocks):
    """The Gram product on the host: one product, bit-equal to the JAX
    package's below its 20 s cut-off; above it (the cut-off lowered here)
    rows in blocks of max(512, n/8), each block one host product."""
    rng = np.random.default_rng(8)
    x = rng.random((1100, 64), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    if blocks:
        monkeypatch.setattr(estimate, "_HOST_ROW_BLOCK_EST_S", 0.0)
        want = np.concatenate([x[i0:i0 + 512] @ x.T
                               for i0 in range(0, 1100, 512)])
    else:
        want = tpu_estimate._gram(x)
    got = estimate._gram(x)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("letters,block", [(None, False), (b"ACGT", False),
                                           (None, True)],
                         ids=["msa-letters", "placement-acgt", "row-blocks"])
def test_pair_counts_on_exact(monkeypatch, letters, block):
    rng = np.random.default_rng(9)
    a = np.frombuffer("".join(_aligned_rows(rng, 40, 120)).encode(),
                      dtype=np.uint8).reshape(40, 120)
    b = np.frombuffer("".join(_aligned_rows(rng, 23, 120)).encode(),
                      dtype=np.uint8).reshape(23, 120)
    if letters is None:
        letters = [int(v) for v in np.unique(np.concatenate([a, b]))
                   if v not in (ord("-"), ord("."))]
    if block:
        monkeypatch.setattr(estimate, "OUT_BLOCK_BYTES", 2 * 4 * 23 * 3)
    match, valid = estimate.pair_counts_on(a, b, letters,
                                           torch.device("cpu"))
    codes = np.frombuffer(bytes(letters), dtype=np.uint8)
    oh_a = (a[:, :, None] == codes).astype(np.float64)
    oh_b = (b[:, :, None] == codes).astype(np.float64)
    want_m = np.einsum("icl,jcl->ij", oh_a, oh_b)
    want_v = oh_a.sum(2) @ oh_b.sum(2).T
    assert match.dtype == valid.dtype == np.float32
    assert np.array_equal(match, want_m) and np.array_equal(valid, want_v)
    m2, v2 = estimate.pair_counts_on(a, None, letters, torch.device("cpu"))
    assert np.array_equal(m2, np.einsum("icl,jcl->ij", oh_a, oh_a))


def test_ieee_f32_scope_restores_the_setting():
    prev = torch.backends.cuda.matmul.fp32_precision
    with estimate.ieee_f32():
        assert torch.backends.cuda.matmul.fp32_precision == "ieee"
        assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.fp32_precision == prev


# ---------------------------------------------------------------------------
# routes: which products go to the card function
# ---------------------------------------------------------------------------

def _run_product(product, device):
    rng = np.random.default_rng(10)
    if product == "gram":
        seqs = _seqs(rng, 40, 300, b"ACGT")
        names = [f"S{i}" for i in range(40)]
        return (estimate.build_guide_tree(names, seqs, device=device),
                tpu_estimate.build_guide_tree(names, seqs))
    if product == "msa":
        rows = _aligned_rows(rng, 260, 200)
        return (estimate.msa_distances(rows, device=device),
                tpu_estimate.msa_distances(rows))
    mat = np.frombuffer("".join(_aligned_rows(rng, 30, 200)).encode(),
                        dtype=np.uint8).reshape(30, 200)
    names = [f"S{i}" for i in range(30)]
    args = (names[:8], mat[:8], names[8:], mat[8:])
    return (placement.nearest_backbone_leaves(*args, device=device),
            tpu_placement.nearest_backbone_leaves(*args))


@pytest.mark.parametrize("product", ["gram", "msa", "placement"])
@pytest.mark.parametrize("route", ["cuda-below-gate", "native-above-gate",
                                   "cuda-above-gate"])
def test_product_routes(monkeypatch, product, route):
    """A CUDA device below the gate and no device (native, cpu, numpy) at
    any size keep a count product on the host; a CUDA device above the
    gate sends it to the card function (stubbed here by its plain
    version). The Gram product stays on the host at every gate, so the
    k-mer tree is the JAX package's bit for bit (a card call would fail:
    this host has no CUDA device)."""
    calls = []

    def stub(real):
        def card(*args):
            calls.append(args[-1])
            return real(*args[:-1], torch.device("cpu"))
        return card

    monkeypatch.setattr(estimate, "pair_counts_on",
                        stub(estimate.pair_counts_on))
    gate = 1e9 if route == "cuda-below-gate" else 0.0
    monkeypatch.setattr(estimate, "CARD_MIN_EST_S", gate)
    device = None if route == "native-above-gate" else CUDA
    got, want = _run_product(product, device)
    assert calls == ([CUDA] if route == "cuda-above-gate"
                     and product != "gram" else [])
    if product in ("gram", "placement"):
        assert got == want
    else:
        assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# external tree tools: mock binaries record their argv and write a tree
# ---------------------------------------------------------------------------

NAMES = ["sA", "sB", "sC", "sD"]
ROWS = ["AC-GT", "AC-GA", "AT-GT", "GC-GT"]    # column 3 all gaps
MOCKS = {
    "fasttree": ("fasttree", 'echo "(sA:1,sB:1,sC:1,sD:1);"\n'),
    "rapidnj": ("rapidnj", 'while [ $# -gt 0 ]; do\n'
                '  case "$1" in -x) OUT="$2"; shift;; esac\n  shift\ndone\n'
                'echo "(sA:1,sB:1,(sC:1,sD:1):1);" > "$OUT"\n'),
    "iqtree": ("iqtree2", 'while [ $# -gt 0 ]; do\n'
               '  case "$1" in -s) IN="$2"; shift;; esac\n  shift\ndone\n'
               'echo "(sA:1,sB:1,sC:1,sD:1);" > "$IN.treefile"\n'),
    "raxml": ("raxmlHPC", 'while [ $# -gt 0 ]; do\n'
              '  case "$1" in -w) WD="$2"; shift;; -n) NM="$2"; shift;; '
              'esac\n  shift\ndone\n'
              'echo "(sA:1,sB:1,sC:1,sD:1);" > "$WD/RAxML_bestTree.$NM"\n'),
    "mafft": ("mafft", 'IN="$(eval echo \\${$#})"\n'
              'printf "((\\n1_sA\\n,\\n2_sB\\n),(\\n3_sC\\n,\\n4_sD\\n));"'
              ' > "$IN.tree"\n'),
    "parttree": ("mafft", 'IN="$(eval echo \\${$#})"\n'
                 'printf "(1,(2,\\n3),4\\n);" > "$IN.tree"\n'),
    "mashtree": ("mashtree", 'while [ $# -gt 0 ]; do\n'
                 '  case "$1" in --outtree) OUT="$2"; shift;; esac\n'
                 '  shift\ndone\n'
                 'echo "(sA:1,sB:1,(sC:1,sD:1):1);" > "$OUT"\n'),
    "dipper": ("dipper", 'while [ $# -gt 0 ]; do\n'
               '  case "$1" in -O) OUT="$2"; shift;; esac\n  shift\ndone\n'
               'echo "(sA:1,sB:1,(sC:1,sD:1):1);" > "$OUT"\n'),
}


def _mock(tmp_path, monkeypatch, tool):
    exe_name, body = MOCKS[tool]
    log = tmp_path / "argv.log"
    exe = tmp_path / exe_name
    exe.write_text('#!/bin/sh\necho "$@" >> ' + str(log) + '\n'
                   'for a in "$@"; do case "$a" in *.fa) cat "$a" >> '
                   + str(log) + ';; esac; done\n' + body)
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(tmp_path) + os.pathsep + "/usr/bin:/bin")
    return log


def _read_log(log):
    text = log.read_text()
    log.unlink()
    # the adapters' temporary directories differ from run to run
    return re.sub(r"/[^ \n]*/twtree_[^/ \n]+", "<tmp>", text)


@pytest.mark.parametrize("tool", sorted(MOCKS))
def test_external_adapter_same_argv_and_newick(tmp_path, monkeypatch, tool):
    log = _mock(tmp_path, monkeypatch, tool)
    found = external.find_tool(tool)
    assert found == tpu_external.find_tool(tool) and found is not None
    aligned = tool not in ("mafft", "parttree", "mashtree")
    got = external.run_external_tree(tool, found[1], NAMES, ROWS, "n",
                                     aligned=aligned)
    got_log = _read_log(log)
    want = tpu_external.run_external_tree(tool, found[1], NAMES, ROWS, "n",
                                          aligned=aligned)
    assert got == want
    assert got_log == _read_log(log)
    assert "<tmp>" in got_log


@pytest.mark.parametrize("aligned", [False, True], ids=["raw", "msa"])
def test_guide_tree_auto_same_choice(tmp_path, monkeypatch, aligned):
    """dipper serves raw and aligned input (`-i r` / `-i m`); with no tool
    on PATH both packages fall back to the built-in estimator."""
    log = _mock(tmp_path, monkeypatch, "dipper")
    got = external.guide_tree_auto(NAMES, ROWS, aligned=aligned)
    got_log = _read_log(log)
    assert got == tpu_external.guide_tree_auto(NAMES, ROWS, aligned=aligned)
    assert got_log == _read_log(log)
    assert f"-i {'m' if aligned else 'r'}" in got_log
    monkeypatch.setenv("PATH", "/nonexistent")
    rows = ["ACGTACGTAA", "ACGTACGTAT", "ACGAACGTAA", "TCGTACCTAA"]
    assert (external.guide_tree_auto(NAMES, rows, aligned=aligned)
            == tpu_external.guide_tree_auto(NAMES, rows, aligned=aligned))


def test_guide_tree_auto_refusals_and_mask(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    for kw in ({"aligned": True, "tool": "rapidnj"},
               {"aligned": False, "tool": "fasttree"}):
        with pytest.raises(RuntimeError) as got:
            external.guide_tree_auto(["a", "b"], ["AC", "AG"], **kw)
        with pytest.raises(RuntimeError) as want:
            tpu_external.guide_tree_auto(["a", "b"], ["AC", "AG"], **kw)
        assert str(got.value) == str(want.value)
    rows = ["A-C-", "A---", "G-C-"]
    assert external.mask_gappy_columns(rows) == ["AC", "A-", "GC"]
    assert (external.mask_gappy_columns(rows, 0.5)
            == tpu_external.mask_gappy_columns(rows, 0.5))
