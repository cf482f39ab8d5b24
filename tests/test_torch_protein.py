"""The port's protein path at the shapes protein users run, held to the JAX
package (twilight_tpu) on the same inputs:

- (a) protein divide-and-conquer (`simulate --type p -n 300 -l 120 --seed
  3`, `--rooted -m 100`): the port's kernel plain version forced
  (--backend cpu, every pair on the device, no stealing) and its
  --backend native, each byte-equal to the JAX CLI's --backend native;
- (d) a protein root merge with a side above 10000 sequences (a clade of
  10001 short simulated proteins joined at the root to a clade of 2):
  byte-equal to the JAX CLI, the merge seen with gap_char 0 through a
  wrapped hook;
- (e) the protein count products: `pair_counts_on` on a CPU device (the
  card route's plain version) at n = 300 with the 20 amino-acid letters,
  equal to `host_msa_counts` and to a count by comparison, and
  `msa_distances` through that route bit-equal to the JAX package's host
  and device functions;
- (f) the protein workflow (300 sequences, two iterations): md5-equal to
  `twilight_tpu.workflow` with --backend native, with the same trees, also
  with the count product on the card route (its plain version);
- (g) `split_launches` at p = 22 (24 rows a side) on prot20k-like widths:
  levels of thousands of short pairs and long sides past 2048 columns,
  every launch within both byte budgets;
- `Params.make("p", ...)` with each -b and with -x files against
  `twilight_tpu.config`'s, array for array.

prot_16 through the command line with -b 45/80 and -x files (cases b and
c) is tests/test_torch_protein_matrices.py.

Tolerance: exact everywhere (FASTA bytes, counts, bit-equal distances,
scoring arrays)."""
import hashlib
import os

import numpy as np
import pytest
import torch

from twilight_tpu import cli as tpu_cli
from twilight_tpu import config as tpu_config
from twilight_tpu.trees import estimate as tpu_estimate
from twilight_tpu.workflow import run_iterative as tpu_run_iterative
from twilight_tpu_torch import cli
from twilight_tpu_torch.config import Params, write_matrix_file
from twilight_tpu_torch.ops import device_kernel as dk
from twilight_tpu_torch.ops import ladder, talco_cuda
from twilight_tpu_torch.tools import simulate
from twilight_tpu_torch.trees import estimate
from twilight_tpu_torch.workflow import iterative, run_iterative

from chip_smoke import AA20, XCHANGED_ORDER, changed_blosum62
from test_torch_scale import _check_launches, _long_prepared

torch.set_num_threads(1)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def prot300(tmp_path_factory):
    """simulate --type p -n 300 -l 120 --seed 3 and its JAX CLI output
    with --rooted -m 100 --backend native."""
    d = tmp_path_factory.mktemp("prot300")
    prefix = str(d / "p300")
    assert simulate.main(["--type", "p", "-n", "300", "-l", "120",
                          "--seed", "3", "-o", prefix]) == 0
    argv = ["-t", prefix + ".nwk", "-i", prefix + ".fa", "--type", "p",
            "--rooted", "-m", "100"]
    want = str(d / "jax.aln")
    assert tpu_cli.main(argv + ["--backend", "native", "-d",
                                str(d / "jax_tmp"), "-o", want]) == 0
    return {"dir": d, "prefix": prefix, "argv": argv, "want": _read(want)}


@pytest.mark.parametrize("backend", ["cpu-forced", "native"])
def test_protein_divide_and_conquer_matches_jax_cli(prot300, tmp_path,
                                                    monkeypatch, backend):
    out = str(tmp_path / "port.aln")
    argv = prot300["argv"] + ["-d", str(tmp_path / "tmp"), "-o", out]
    if backend == "native":
        rc, kernel = cli.run(argv + ["--backend", "native"])
        assert rc == 0 and kernel is None
    else:
        monkeypatch.setenv("TWILIGHT_FORCE_DEVICE", "1")
        monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")
        rc, kernel = cli.run(argv + ["--backend", "cpu"])
        assert rc == 0
        st = kernel.stats
        # every pair of the subtrees and the meta-tree merge on the device
        # (the plain version): leaf launches and freq launches both
        assert st["pairs_on_device"] == st["pairs"] - st["zero_length"] > 0
        assert st["host_stolen"] == st["task0_errors"] == 0
        assert 0 < st["leaf_launches"] < sum(st["launches_by_device"])
        assert talco_cuda.talco_align.launches == 0   # no kernel on the CPU
    got = _read(out)
    assert got.count(b">") == 300 and got == prot300["want"]


def _big_protein_clade(d):
    """10001 simulated 30-residue proteins (their true tree) joined at the
    root to a clade of 2 mutated copies of two of them."""
    prefix = os.path.join(d, "bigp")
    assert simulate.main(["--type", "p", "-n", "10001", "-l", "30",
                          "--seed", "4", "-o", prefix]) == 0
    with open(prefix + ".nwk") as f:
        tree = f.read().strip().rstrip(";")
    with open(prefix + ".fa") as f:
        fasta = f.read().rstrip("\n")
    seqs = [ln for ln in fasta.split("\n") if not ln.startswith(">")]
    rng = np.random.default_rng(4)
    extra = []
    for k in range(2):
        s = bytearray(seqs[k].encode())
        for j in rng.choice(len(s), 4, replace=False):
            s[j] = AA20.encode()[rng.integers(20)]
        extra.append(f">X{k + 1}\n{s.decode()}")
    with open(prefix + "2.fa", "w") as f:
        f.write(fasta + "\n" + "\n".join(extra) + "\n")
    with open(prefix + "2.nwk", "w") as f:
        f.write(f"({tree}:0.1,(X1:0.1,X2:0.1):0.1);\n")
    return ["-t", prefix + "2.nwk", "-i", prefix + "2.fa", "--type", "p",
            "--rooted", "--backend", "native"]


def test_protein_root_merge_above_10000_matches_jax_cli(tmp_path,
                                                        monkeypatch):
    argv = _big_protein_clade(str(tmp_path))
    seen = []
    real = ladder.run_talco_with_retries

    def hook(*args):
        # (freq_ref, freq_qry, gap_op, gap_ex, num, lens, param,
        # zero_gap_char, task, option)
        seen.append((args[4], args[7], args[0].shape[1]))
        return real(*args)

    monkeypatch.setattr(ladder, "run_talco_with_retries", hook)
    out = str(tmp_path / "port.aln")
    assert cli.main(argv + ["-o", out]) == 0
    big = [s for s in seen if max(s[0]) > 10000]
    assert big and all(gz for _, gz, _ in big), big
    assert any(sorted(num) == [2.0, 10001.0] for num, _, _ in big), big
    # protein profiles: 22 columns a side
    assert {p for _, _, p in seen} == {22}
    want = str(tmp_path / "jax.aln")
    assert tpu_cli.main(argv + ["-o", want]) == 0
    got = _read(out)
    assert got.count(b">") == 10003 and got == _read(want)


@pytest.fixture(scope="module")
def protein_rows(prot300):
    """The 300 aligned rows of (a)'s output: protein letters, gaps."""
    rows = []
    for block in prot300["want"].decode().split(">")[1:]:
        rows.append("".join(block.split("\n")[1:]))
    return rows


def test_protein_pair_counts_exact(protein_rows):
    mat, is_gap = estimate.msa_columns(protein_rows)
    letters = estimate.msa_letters(mat)
    assert len(protein_rows) == 300 and bytes(letters) == AA20.encode()
    match, valid = estimate.pair_counts_on(mat, None, letters,
                                           torch.device("cpu"))
    hm, hv = estimate.host_msa_counts(mat, is_gap, letters)
    assert match.dtype == valid.dtype == np.float32
    assert match.tobytes() == hm.tobytes() and valid.tobytes() == hv.tobytes()
    ok = ~is_gap
    want_v = (ok[:, None, :] & ok[None, :, :]).sum(2)
    want_m = ((mat[:, None, :] == mat[None, :, :])
              & ok[:, None, :] & ok[None, :, :]).sum(2)
    assert np.array_equal(match, want_m) and np.array_equal(valid, want_v)


@pytest.mark.parametrize("route", ["card-plain", "host"])
def test_protein_msa_distances_bit_equal_to_jax(protein_rows, monkeypatch,
                                                route):
    if route == "card-plain":
        calls = []
        real = estimate.pair_counts_on

        def counting(*a):
            calls.append(a[3])
            return real(*a)

        monkeypatch.setattr(estimate, "pair_counts_on", counting)
        monkeypatch.setattr(estimate, "on_card", lambda dev, est: True)
        got = estimate.msa_distances(protein_rows,
                                     device=torch.device("cpu"))
        assert calls == [torch.device("cpu")]
    else:
        got = estimate.msa_distances(protein_rows)
    want = tpu_estimate.msa_distances(protein_rows)
    assert got.dtype == want.dtype == np.float64
    assert got.tobytes() == want.tobytes()
    # the JAX package's device counts (einsums of bf16 one-hots, f32
    # accumulation), run on the CPU past its platform check
    mat, is_gap = estimate.msa_columns(protein_rows)

    class _Dev:
        platform = "tpu"

    import jax
    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev()])
    dev = tpu_estimate._msa_distances_device(mat, is_gap)
    assert dev.tobytes() == got.tobytes()


def _md5_text(path):
    with open(path) as f:
        return hashlib.md5(f.read().strip().encode()).hexdigest()


@pytest.mark.parametrize("route", ["native", "card-products"])
def test_protein_workflow_md5_equals_jax(prot300, tmp_path, monkeypatch,
                                         route):
    seqs = prot300["prefix"] + ".fa"
    calls = []
    if route == "card-products":
        # a CUDA device for the tree estimation, every gate at 0, the
        # count product by its plain version on the CPU
        real = estimate.pair_counts_on

        def card(a, b, letters, device):
            calls.append((device, len(letters)))
            return real(a, b, letters, torch.device("cpu"))

        monkeypatch.setattr(estimate, "pair_counts_on", card)
        monkeypatch.setattr(estimate, "CARD_MIN_EST_S", 0.0)
        monkeypatch.setattr(iterative, "resolve", lambda backend: (
            "native", torch.device("cuda")))
    outs = {}
    for tag, fn in (("jax", tpu_run_iterative), ("port", run_iterative)):
        outs[tag] = str(tmp_path / f"{tag}.aln")
        fn(seqs, outs[tag], iterations=2, temp_dir=str(tmp_path / tag),
           type_="p", backend="native", keep_temp=True)
    if route == "card-products":
        assert calls == [(torch.device("cuda"), 20)]
    for name in ("iter0.nwk", "iter1.nwk"):
        assert (_md5_text(tmp_path / "port" / name)
                == _md5_text(tmp_path / "jax" / name)), name
    assert _read(outs["port"]) == _read(outs["jax"])


@pytest.mark.parametrize("widths", ["levels", "long"])
def test_split_launches_at_prot20k_widths(widths):
    """A protein launch stages 24 rows a side (p8_of(22)): 3x a nucleotide
    launch's bytes. At padlen 2048 a pair stages 2 x 24 x 2048 x 4 B =
    393 KB, so the 64 MB budget holds 170 pairs and the batch of 128
    binds; past 2048 columns (the subtrees' tops, up to prot20k's 5289
    columns) the staging budget binds first."""
    rng = np.random.default_rng(22)
    rows = talco_cuda.p8_of(22)
    assert rows == 24
    if widths == "levels":
        prepared = _long_prepared(rng, 3000, 60, 2049)
    else:
        prepared = _long_prepared(rng, 400, 2049, 5289)
        prepared[0] = (None,) * 4 + ((5289, 5201),) + (None,) * 2
    idxs = sorted(range(len(prepared)), key=lambda i: -sum(prepared[i][4]))
    flen = [4096] * len(prepared)
    out = dk.split_launches(idxs, prepared, flen, rows, 4, 128)
    assert _check_launches(out, idxs, prepared, flen, rows, 4, 128,
                           dk.STAGING_BUDGET, dk.SCRATCH_BUDGET) == 0
    if widths == "levels":
        assert {p for _, p in out} == {dk.SHORT_PADLEN}
        assert [len(c) for c, _ in out] == [128] * 23 + [3000 - 23 * 128]
    else:
        assert out[0][1] == dk.launch_padlen(5289) == 5376
        # 64 MB over 2 x 24 x 5376 x 4 B
        assert len(out[0][0]) == dk.STAGING_BUDGET // (2 * 24 * 5376 * 4)
        assert all(2 * len(c) * rows * p * 4 <= dk.STAGING_BUDGET
                   for c, p in out)


def _matrix_args(kind, d):
    """Params.make keyword arguments of a -b value or a -x file."""
    if kind.startswith("b"):
        return {"blosum": int(kind[1:])}
    path = os.path.join(d, kind + ".x")
    if kind == "x62":
        write_matrix_file(path, "p", Params.make("p").scoring_matrix, AA20)
    else:
        write_matrix_file(path, "p", changed_blosum62(), XCHANGED_ORDER)
    return {"matrix_file": path}


@pytest.mark.parametrize("wildcard", [False, True])
@pytest.mark.parametrize("kind", ["b45", "b62", "b80", "x62", "xchanged"])
def test_params_make_equals_jax(tmp_path, kind, wildcard):
    kw = _matrix_args(kind, str(tmp_path))
    got = Params.make("p", wildcard=wildcard, **kw)
    want = tpu_config.Params.make("p", wildcard=wildcard, **kw)
    for f in ("gap_open", "gap_extend", "gap_boundary", "xdrop",
              "matrix_size"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.scoring_matrix.dtype == want.scoring_matrix.dtype
    assert got.scoring_matrix.tobytes() == want.scoring_matrix.tobytes()
    if kind == "x62":
        # BLOSUM62 written out as -b 62 scores it reads back as -b 62,
        # the wildcard row (the diagonal's mean) too
        b62 = Params.make("p", wildcard=wildcard).scoring_matrix
        assert got.scoring_matrix.tobytes() == b62.tobytes()
