"""The port at the counts and widths of sim40k `-m 20000`: profile sides
of more than 10000 sequences, 13-20k-column freq pairs, and a CLI run
whose root merge has a side above 10000.

- The kernel's plain version (talco_cuda on CPU tensors, packed by the
  port's packer) against the port's oracle and the JAX package's, bit for
  bit, on freq pairs whose sides stand for 10000-22135 sequences: products
  and ref_num * qry_num pass 2^24 and round in f32, and gap_char is 0
  above 10000.
- The port's packer against the JAX packer at those counts, and the
  smoke's host references (talco_inputs.host_check) taking the packer's
  gap_char there.
- split_launches on size-sorted 13-20k-column freq pairs: every launch
  within both byte budgets, a pair over a budget alone in its launch, and
  int64 scratch offsets past 2^31.
- One CLI run, the port against the JAX CLI (both --backend native), on
  a clade of 10001 simulated leaves joined at the root to a clade of 2:
  the same FASTA bytes, and the root merge seen with a side above 10000
  (gap_char 0) through a wrapped hook.

Tolerance: exact everywhere (paths, tails, packed arrays, FASTA bytes)."""
import os

import numpy as np
import pytest
import torch

from twilight_tpu import cli as tpu_cli
from twilight_tpu.ops import talco_np as jax_talco_np
from twilight_tpu_torch import cli
from twilight_tpu_torch.config import Params
from twilight_tpu_torch.ops import device_kernel as dk
from twilight_tpu_torch.ops import ladder, talco_cuda, talco_np
from twilight_tpu_torch.tools import simulate
from twilight_tpu_torch.tools import talco_inputs as ti

from test_torch_device_kernel import _jax_batcher, _jax_order

torch.set_num_threads(1)

# sides' counts: the gap_char boundary and sim40k's meta-tree merges
COUNTS = [(10000, 10001), (10001, 10000), (17865, 22135), (22135, 17865)]


def _gap_char(task, rnum, qnum, param):
    """gap_char as the reference sets it (alignment-cpu.cpp): 0 at tasks
    1/2 and for a side above 10000 sequences, else gap_extend."""
    if task in (1, 2) or rnum > 10000 or qnum > 10000:
        return np.float32(0.0)
    return np.float32(param.gap_extend)


@pytest.mark.parametrize("p", [6, 22])
@pytest.mark.parametrize("task", [0, 3])
@pytest.mark.parametrize("counts", COUNTS)
def test_plain_version_matches_oracles_at_large_counts(p, task, counts):
    rng = np.random.default_rng(p * 100 + task * 10 + counts[0] % 7)
    param = Params.make("n" if p == 6 else "p")
    length = 110 if p == 6 else 60
    prepared, metas = zip(*[ti.make_pair(rng, p, False, length,
                                         counts=counts) for _ in range(2)])
    for meta in metas:
        assert meta[2] * meta[3] > 1 << 24
        # 17865 * 22135 = 395441775 is odd and past 2^24, so den rounds in
        # f32; 10000 * 10001 = 2^4 * 6250625 does not
        den = np.float32(meta[2]) * np.float32(meta[3])
        assert (float(den) != meta[2] * meta[3]) == (min(counts) > 10001)
    flen, xdrop = [4096, 4096], [5000, 5000]
    st = dk.pack_batch([0, 1], list(prepared), list(metas), task, 256, p,
                       param, flen, xdrop)
    gap_char = _gap_char(task, *counts, param)
    np.testing.assert_array_equal(st.floats.numpy()[2], [gap_char] * 2)
    paths, tail = ti.launch(torch, st, p, talco_cuda.MARKER, "cpu")
    for i, (prep, meta) in enumerate(zip(prepared, metas)):
        fr, fq, _, _, lens, go, ge = prep
        want = []
        for oracle in (talco_np, jax_talco_np):
            tp = oracle.TalcoRunParams(param.scoring_matrix, param.gap_open,
                                       param.gap_extend, gap_char, xdrop[i],
                                       flen=flen[i], marker=talco_cuda.MARKER)
            want.append(oracle.align_freq(tp, fr, fq, go, ge,
                                          (meta[2], meta[3])))
        (path, err), (jpath, jerr) = want
        assert err == jerr == 0 and np.array_equal(path, jpath)
        assert tail[i, 1] == 0
        np.testing.assert_array_equal(paths[i, :tail[i, 0]], path)


@pytest.mark.parametrize("p,task", [(6, 0), (6, 1), (6, 3), (22, 0)])
def test_pack_batch_equals_jax_packer_at_large_counts(p, task):
    rng = np.random.default_rng(70 + p + task)
    param = Params.make("n" if p == 6 else "p")
    counts = COUNTS + [(10000, 10000), (10499, 11636)]
    prepared, metas = zip(*[ti.make_pair(rng, p, False, 80 + 10 * k,
                                         counts=c)
                            for k, c in enumerate(counts)])
    chunk = [5, 2, 0, 4, 1, 3]
    flen = [4096, 100, 4096, 512, 4096, 4096]
    xdrop = [5000, 5000, 10000, 5000, 5000, 5000]
    jax = _jax_batcher("n" if p == 6 else "p")
    want = jax._pack_batch(chunk, prepared, metas, task, 512, 512,
                           len(chunk), flen, xdrop, off=0, tot=512)
    st = dk.pack_batch(chunk, list(prepared), list(metas), task, 512, p,
                       param, flen, xdrop)
    for g, w in zip(_jax_order(st), want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # gap_char 0 exactly where a side passes 10000 (or at tasks 1/2)
    np.testing.assert_array_equal(
        st.floats.numpy()[2],
        [_gap_char(task, *counts[i], param) for i in chunk])


def test_host_references_take_gap_char_0_above_10000():
    """The smoke's host references (talco_inputs.host_check) give the
    oracle and the plain version of a pair with a side above 10000
    sequences gap_char 0, as the packer gives the kernel: on this pair
    (found by search) gap_extend would give another path."""
    rng = np.random.default_rng(27)
    prep, meta = ti.make_pair(rng, 22, False, 80, related=False,
                              gap_rate=0.1, counts=(10001, 17865))
    fr, fq, _, _, _, go, ge = prep
    param = Params.make("p")
    paths = {}
    for gap_char in (0.0, param.gap_extend):
        tp = talco_np.TalcoRunParams(param.scoring_matrix, param.gap_open,
                                     param.gap_extend, gap_char, 5000)
        paths[gap_char] = talco_np.align_freq(tp, fr, fq, go, ge,
                                              (meta[2], meta[3]))[0]
    assert not np.array_equal(paths[0.0], paths[param.gap_extend])
    job = {"p": 22, "leaf": False, "marker": talco_cuda.MARKER, "task": 0,
           "prep": prep, "meta": meta, "flen": 4096, "xdrop": 5000,
           "plain": True}
    gold, err, plain, plain_tail = ti.host_check(job)
    assert err == plain_tail[1] == 0
    np.testing.assert_array_equal(gold, paths[0.0])
    np.testing.assert_array_equal(plain, paths[0.0])


def _long_prepared(rng, n, lo, hi):
    """Prepared tuples of n freq pairs whose sides have lo-hi columns
    (split_launches reads only the lengths)."""
    return [(None,) * 4 + ((int(rng.integers(lo, hi)),
                            int(rng.integers(lo, hi))),) + (None,) * 2
            for _ in range(n)]


def _check_launches(out, idxs, prepared, flen, rows, esz, batch, staging,
                    scratch):
    """Each pair once, in order; each launch within the pair count and both
    budgets unless it holds one pair; padlen fits every side."""
    assert [i for chunk, _ in out for i in chunk] == idxs
    singles = 0
    for chunk, padlen in out:
        need = sum(talco_cuda.pair_scratch_bytes(*prepared[i][4], flen[i])
                   for i in chunk)
        stage = 2 * len(chunk) * rows * padlen * esz
        assert padlen == dk.launch_padlen(
            max(max(prepared[i][4]) for i in chunk))
        if len(chunk) == 1:
            singles += stage > staging or need > scratch
            continue
        assert len(chunk) <= batch and stage <= staging and need <= scratch
    return singles


@pytest.mark.parametrize("p", [6, 22])
def test_split_launches_at_sim40k_widths(p):
    """13-20.6k-column freq pairs (sim40k's subtrees and whole MSA) at the
    batcher's budgets: the 64 MB staging caps a launch (an nt pair at
    padlen 20736 stages 2 x 8 x 20736 x 4 B = 1.33 MB), never the pair
    count."""
    rng = np.random.default_rng(p)
    prepared = _long_prepared(rng, 300, 13000, 20000)
    prepared[0] = (None,) * 4 + ((20587, 20100),) + (None,) * 2
    idxs = sorted(range(300), key=lambda i: -sum(prepared[i][4]))
    flen = [4096] * 300
    rows = talco_cuda.p8_of(p)
    out = dk.split_launches(idxs, prepared, flen, rows, 4, 128)
    assert _check_launches(out, idxs, prepared, flen, rows, 4, 128,
                           dk.STAGING_BUDGET, dk.SCRATCH_BUDGET) == 0
    assert out[0][1] == dk.launch_padlen(20587) == 20736
    assert len(out[0][0]) == (50 if p == 6 else 16)
    assert max(len(c) for c, _ in out) < 128


def test_split_launches_pair_over_a_budget_alone():
    """A pair whose scratch alone passes the budget (a ladder width of
    32768) and one whose staging alone does each get a launch of their
    own; the 13-20k-column pairs around them fill launches within both
    budgets."""
    rng = np.random.default_rng(3)
    prepared = _long_prepared(rng, 40, 13000, 20000)
    # staging alone past a budget of ten 20224-column pairs
    prepared[0] = (None,) * 4 + ((210000, 205000),) + (None,) * 2
    idxs = sorted(range(40), key=lambda i: -sum(prepared[i][4]))
    flen = [4096] * 40
    wide = idxs[7]
    flen[wide] = talco_cuda.MAX_WINDOW
    scratch = talco_cuda.pair_scratch_bytes(*prepared[wide][4],
                                            flen[wide]) - 1
    staging = 10 * 2 * 8 * dk.launch_padlen(20000) * 4
    # four 4096-wide pairs fit the scratch budget (4.35 MB each)
    assert scratch // talco_cuda.pair_scratch_bytes(20000, 20000, 4096) == 4
    out = dk.split_launches(idxs, prepared, flen, 8, 4, 128,
                            staging_budget=staging, scratch_budget=scratch)
    assert ([0], dk.launch_padlen(210000)) in out
    assert ([wide], dk.launch_padlen(max(prepared[wide][4]))) in out
    assert _check_launches(out, idxs, prepared, flen, 8, 4, 128, staging,
                           scratch) == 2
    assert max(len(c) for c, _ in out) == 4


def test_scratch_offsets_past_int32():
    """128 pairs of 20587 columns at the widest ladder width need 2.8 GB of
    scratch: the
    offsets are int64 and exact (the scratch budget then splits such a
    level into launches of at most 2 GB)."""
    rl = ql = np.full(128, 20587, np.int32)
    fl = np.full(128, talco_cuda.MAX_WINDOW, np.int32)
    offs = talco_cuda.scratch_offsets(rl, ql, fl)
    one = talco_cuda.pair_scratch_bytes(20587, 20587, talco_cuda.MAX_WINDOW)
    assert offs.dtype == np.int64 and offs[-1] == 128 * one > 1 << 31
    np.testing.assert_array_equal(np.diff(offs), one)
    prepared = [(None,) * 4 + ((20587, 20587),) + (None,) * 2] * 128
    # leaf rows, so that the scratch budget and not the staging binds
    out = dk.split_launches(list(range(128)), prepared, list(fl), 1, 1, 128)
    per = dk.SCRATCH_BUDGET // one
    assert [len(c) for c, _ in out] == [per] * (128 // per) + (
        [128 % per] if 128 % per else [])


def _big_clade_set(d):
    """10001 simulated 40-column leaves (their true tree) joined at the
    root to a clade of 2 mutated copies of two of them."""
    prefix = os.path.join(d, "big")
    assert simulate.main(["-n", "10001", "-l", "40", "--seed", "4", "-o",
                          prefix]) == 0
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
            s[j] = b"ACGT"[rng.integers(4)]
        extra.append(f">X{k + 1}\n{s.decode()}")
    with open(prefix + "2.fa", "w") as f:
        f.write(fasta + "\n" + "\n".join(extra) + "\n")
    with open(prefix + "2.nwk", "w") as f:
        f.write(f"({tree}:0.1,(X1:0.1,X2:0.1):0.1);\n")
    return ["-t", prefix + "2.nwk", "-i", prefix + "2.fa", "--rooted",
            "--backend", "native"]


def test_root_merge_above_10000_matches_jax_cli(tmp_path, monkeypatch):
    argv = _big_clade_set(str(tmp_path))
    seen = []
    real = ladder.run_talco_with_retries

    def hook(*args):
        # (freq_ref, freq_qry, gap_op, gap_ex, num, lens, param,
        # zero_gap_char, task, option)
        seen.append((args[4], args[7], args[8]))
        return real(*args)

    monkeypatch.setattr(ladder, "run_talco_with_retries", hook)
    out = str(tmp_path / "port.aln")
    assert cli.main(argv + ["-o", out]) == 0
    big = [s for s in seen if max(s[0]) > 10000]
    assert big and all(gz for _, gz, _ in big), big
    assert any(sorted(num) == [2.0, 10001.0] for num, _, _ in big), big
    want = str(tmp_path / "jax.aln")
    assert tpu_cli.main(argv + ["-o", want]) == 0
    with open(out, "rb") as a, open(want, "rb") as b:
        got, ref = a.read(), b.read()
    assert got.count(b">") == 10003 and got == ref
