"""Parity of the port's TALCO-XDrop kernel module
(twilight_tpu_torch/ops/talco_cuda.py) with the JAX package.

The plain PyTorch version, reached through the wrapper on CPU tensors, must
give bit-identical alignment paths and error codes (tolerance: exact) to
the NumPy oracle talco_np.align_freq, to the XLA batch kernel
talco_jax.get_batch_kernel, and to the grouped Pallas kernel
talco_pallas_g8 in interpret mode. The CUDA kernel itself runs only on a
GPU, where chip_smoke.py holds it to the oracle and to this plain version
(the tests import jax, which the GPU machine does not have).
"""
import numpy as np
import pytest
import torch

from twilight_tpu.config import Params
from twilight_tpu.ops import talco_jax, talco_np, talco_pallas, talco_pallas_g8
from twilight_tpu_torch.ops import talco_cuda

from conftest import random_profile_pair

torch.set_num_threads(1)

GO, GE = -50.0, -5.0
PADLEN = 256


def nuc_matrix():
    """The 6x6 nucleotide matrix of tests/test_talco_kernel.py."""
    m = np.zeros((6, 6), dtype=np.float32)
    for i in range(5):
        for j in range(5):
            m[i, j] = 18.0 if i == j else (-4.0 if abs(i - j) == 2 else -8.0)
    m[4, :] = m[:, 4] = 0.0
    return m


def matrix_of(p):
    return nuc_matrix() if p == 6 else Params.make("p").scoring_matrix


def make_cases(rng, p, leaf, n, maxlen=160):
    """n pairs: related one-hot pairs, 2-sequence weighted profiles (freq),
    an unrelated pair with a tight X-drop (error 1) and a pair with a
    narrow ladder width (error 2). Entries: (fr, fq, num, flen, xdrop)."""
    cases = []
    for t in range(n):
        r = int(rng.integers(30, maxlen))
        q = max(25, r + int(rng.integers(-30, 30)))
        fr, fq = random_profile_pair(rng, r, q, p=p)
        num, flen, xdrop = 1.0, 4096, 5000
        if not leaf and t % 4 == 1:
            fr2, fq2 = random_profile_pair(rng, r, q, p=p)
            fr, fq, num = fr + fr2, fq + fq2, 2.0
        if t == n - 2:
            fq = np.zeros_like(fq)
            fq[np.arange(q), rng.integers(0, 4, q)] = 1.0
            xdrop = 40
        if t == n - 1:
            flen = 8
        cases.append((fr, fq, num, flen, xdrop))
    return cases


def gap_rows(rl, ql):
    return ((np.full(rl, GO, np.float32), np.full(ql, GO, np.float32)),
            (np.full(rl, GE, np.float32), np.full(ql, GE, np.float32)))


def pack(cases, p, leaf, gap_char, marker, padlen=PADLEN):
    """The kernel's batch layout (talco_cuda module doc), on CPU."""
    b = len(cases)
    p8 = talco_cuda.p8_of(p)
    ints = torch.zeros((4, b), dtype=torch.int32)
    floats = torch.zeros((5, b), dtype=torch.float32)
    if leaf:
        ref = torch.full((b, 1, padlen), p - 2, dtype=torch.int8)
        qry = torch.full((b, 1, padlen), p - 2, dtype=torch.int8)
    else:
        ref = torch.zeros((b, p8, padlen))
        qry = torch.zeros((b, p8, padlen))
    for i, (fr, fq, num, flen, xdrop) in enumerate(cases):
        rl, ql = len(fr), len(fq)
        ints[:, i] = torch.tensor([rl, ql, flen, xdrop])
        floats[:, i] = torch.tensor([num, num, gap_char, GO, GE])
        if leaf:
            ref[i, 0, padlen - rl:] = torch.from_numpy(
                fr.argmax(1)[::-1].astype(np.int8).copy())
            qry[i, 0, :ql] = torch.from_numpy(fq.argmax(1).astype(np.int8))
        else:
            ref[i, :p, padlen - rl:] = torch.from_numpy(fr[::-1].T.copy())
            qry[i, :p, :ql] = torch.from_numpy(fq.T.copy())
            ref[i, p8 - 2, padlen - rl:] = GO
            ref[i, p8 - 1, padlen - rl:] = GE
            qry[i, p8 - 2, :ql] = GO
            qry[i, p8 - 1, :ql] = GE
    offs = torch.from_numpy(talco_cuda.scratch_offsets(
        ints[0].tolist(), ints[1].tolist(), ints[2].tolist(), marker))
    return ints, floats, offs, ref, qry


def run_port(cases, p, leaf, gap_char, marker):
    ints, floats, offs, ref, qry = pack(cases, p, leaf, gap_char, marker)
    paths, tail = talco_cuda.talco_align(
        ints, floats, offs, ref, qry, torch.from_numpy(matrix_of(p)), p=p,
        marker=marker, scratch_bytes=int(offs[-1]))
    return paths.numpy(), tail.numpy()


def oracle(case, p, gap_char, marker):
    fr, fq, num, flen, xdrop = case
    go, ge = gap_rows(len(fr), len(fq))
    tp = talco_np.TalcoRunParams(matrix_of(p), GO, GE, gap_char, xdrop,
                                 flen=flen, marker=marker)
    return talco_np.align_freq(tp, fr, fq, go, ge, (num, num))


@pytest.mark.parametrize("p,leaf,marker,gap_char", [
    (6, False, 1024, GE), (6, False, 64, 0.0), (6, True, 1024, GE),
    (6, True, 64, GE), (22, False, 1024, GE), (22, False, 64, GE),
    (22, True, 1024, GE), (22, True, 64, GE)])
def test_plain_version_matches_oracle(p, leaf, marker, gap_char):
    """Nucleotide and protein, freq and leaf, weighted profiles,
    gap_char 0, multi-tile (marker 64) and errors 1 and 2: exact."""
    rng = np.random.default_rng(1000 * p + 10 * leaf + (marker == 64))
    cases = make_cases(rng, p, leaf, 6)
    paths, tail = run_port(cases, p, leaf, gap_char, marker)
    errs = set()
    for i, case in enumerate(cases):
        gold, gerr = oracle(case, p, gap_char, marker)
        ln, e = int(tail[i, 0]), int(tail[i, 1])
        errs.add(e)
        assert e == gerr, f"pair {i}: err {e} vs oracle {gerr}"
        if gerr == 0:
            assert ln == len(gold)
            np.testing.assert_array_equal(paths[i, :ln], gold)
        assert tail[i, 3] > 0      # diagonals computed
    assert {1, 2} <= errs, f"error codes exercised: {errs}"


def test_plain_version_matches_talco_jax():
    """The XLA batch kernel (talco_jax.get_batch_kernel) on the CPU."""
    rng = np.random.default_rng(7)
    cases = make_cases(rng, 6, False, 6, maxlen=200)
    m = nuc_matrix()
    flen_w = PADLEN
    kern = talco_jax.get_batch_kernel(PADLEN, flen_w, 6, 1024, m.tobytes(), 6)
    b = len(cases)
    tot = flen_w + PADLEN + flen_w
    rr = np.zeros((b, tot, 6), np.float32)
    qq = np.zeros((b, tot, 6), np.float32)
    gor, goq, ger, geq = (np.zeros((b, tot), np.float32) for _ in range(4))
    rl = np.zeros(b, np.int32)
    ql = np.zeros(b, np.int32)
    for i, (fr, fq, _, _, _) in enumerate(cases):
        go, ge = gap_rows(len(fr), len(fq))
        rr[i], qq[i], gor[i], goq[i], ger[i], geq[i] = talco_jax.pack_pair(
            fr, fq, go, ge, PADLEN, flen_w)
        rl[i], ql[i] = len(fr), len(fq)
    nums = np.array([c[2] for c in cases], np.float32)
    out, lens, errs = kern(
        rr, qq, gor, goq, ger, geq, rl, ql, nums, nums,
        np.array([c[3] for c in cases], np.int32),
        np.array([c[4] for c in cases], np.int32),
        np.full(b, GE, np.float32), np.float32(GO), np.float32(GE))
    out, lens, errs = np.asarray(out), np.asarray(lens), np.asarray(errs)
    paths, tail = run_port(cases, 6, False, GE, 1024)
    for i in range(b):
        assert int(tail[i, 1]) == int(errs[i]), f"pair {i}"
        if errs[i] == 0:
            assert int(tail[i, 0]) == int(lens[i])
            np.testing.assert_array_equal(paths[i, :lens[i]],
                                          out[i, :lens[i]])


@pytest.mark.parametrize("leaf", [False, True])
def test_plain_version_matches_pallas_g8_interpret(leaf):
    """Batch 8 through the grouped Pallas kernel in interpret mode at the
    main path's bucket (padlen 2048, window 512); pairs the TPU kernel
    sends back with its window error 6 are not compared."""
    rng = np.random.default_rng(11 + leaf)
    param = Params.make("n")
    mat = param.scoring_matrix.astype(np.float32)
    padlen, b = 2048, 8
    cases = [c[:3] + (4096, 5000) for c in make_cases(rng, 6, leaf, b)]
    kern, _, off, tot = talco_pallas_g8.get_pallas_kernel_g8(
        padlen, 512, 6, 1024, mat.tobytes(), param.matrix_size, b,
        leaf=leaf, interpret=True, grp=8)
    rl = np.array([len(c[0]) for c in cases], np.int32)
    ql = np.array([len(c[1]) for c in cases], np.int32)
    if leaf:
        ref_b = np.full((b, 1, tot), 4, np.int8)
        qry_b = np.full((b, 1, tot), 4, np.int8)
    else:
        ref_b = np.zeros((b, 8, tot), np.float32)
        qry_b = np.zeros((b, 8, tot), np.float32)
    for i, (fr, fq, _, _, _) in enumerate(cases):
        if leaf:
            ref_b[i, 0, off + padlen - rl[i]:off + padlen] = \
                fr.argmax(1)[::-1]
            qry_b[i, 0, off:off + ql[i]] = fq.argmax(1)
        else:
            go, ge = gap_rows(rl[i], ql[i])
            talco_pallas.pack_pair_into(ref_b[i], qry_b[i], fr, fq, go, ge,
                                        padlen, off)
    nums = np.array([c[2] for c in cases], np.float32)
    res = kern(rl, ql, nums, nums, np.full(b, 4096, np.int32),
               np.full(b, 5000, np.int32), np.full(b, GE, np.float32),
               np.full(b, GO, np.float32), np.full(b, GE, np.float32),
               ref_b, qry_b)
    g_out, g_tail = np.asarray(res[0]), np.asarray(res[1])

    ints, floats, offs, ref, qry = pack(cases, 6, leaf, GE, 1024,
                                        padlen=padlen)
    paths, tail = talco_cuda.talco_align(
        ints, floats, offs, ref, qry, torch.from_numpy(mat), p=6,
        scratch_bytes=int(offs[-1]))
    compared = 0
    for i in range(b):
        if g_tail[i, 1] == 6:
            continue
        compared += 1
        assert int(tail[i, 1]) == int(g_tail[i, 1]), f"pair {i}"
        n = int(g_tail[i, 0])
        assert int(tail[i, 0]) == n
        np.testing.assert_array_equal(paths[i, :n].numpy(), g_out[i, :n])
    assert compared >= b // 2


def test_plain_version_matches_pallas_g8_hbm_in_interpret():
    """K4: the grouped Pallas kernel's long-sequence variant (padlen above
    2048: profiles in HBM, anchor-window staging) in interpret mode, batch
    8 at launch padlen 4096, against the plain version at the same padlen
    (the port's long route); error-6 pairs are not compared."""
    rng = np.random.default_rng(23)
    param = Params.make("n")
    mat = param.scoring_matrix.astype(np.float32)
    padlen, b, marker = 4096, 8, 64
    cases = [c[:3] + (4096, 5000)
             for c in make_cases(rng, 6, False, b, maxlen=120)]
    cases[-1] = cases[-1][:3] + (8, 5000)      # a binding ladder width
    kern, _, off, tot = talco_pallas_g8.get_pallas_kernel_g8(
        padlen, 128, 6, marker, mat.tobytes(), param.matrix_size, b,
        interpret=True, grp=8)
    assert (off, tot) == (0, padlen)
    rl = np.array([len(c[0]) for c in cases], np.int32)
    ql = np.array([len(c[1]) for c in cases], np.int32)
    ref_b = np.zeros((b, 8, tot), np.float32)
    qry_b = np.zeros((b, 8, tot), np.float32)
    for i, (fr, fq, _, _, _) in enumerate(cases):
        go, ge = gap_rows(rl[i], ql[i])
        talco_pallas.pack_pair_into(ref_b[i], qry_b[i], fr, fq, go, ge,
                                    padlen, off)
    nums = np.array([c[2] for c in cases], np.float32)
    res = kern(rl, ql, nums, nums,
               np.array([c[3] for c in cases], np.int32),
               np.array([c[4] for c in cases], np.int32),
               np.full(b, GE, np.float32), np.full(b, GO, np.float32),
               np.full(b, GE, np.float32), ref_b, qry_b)
    g_out, g_tail = np.asarray(res[0]), np.asarray(res[1])

    ints, floats, offs, ref, qry = pack(cases, 6, False, GE, marker,
                                        padlen=padlen)
    np.testing.assert_array_equal(ref.numpy(), ref_b)
    paths, tail = talco_cuda.talco_align(
        ints, floats, offs, ref, qry, torch.from_numpy(mat), p=6,
        marker=marker, scratch_bytes=int(offs[-1]))
    compared, errs = 0, set()
    for i in range(b):
        if g_tail[i, 1] == 6:
            continue
        compared += 1
        errs.add(int(g_tail[i, 1]))
        assert tail[i, :2].tolist() == g_tail[i, :2].tolist(), f"pair {i}"
        n = int(g_tail[i, 0])
        np.testing.assert_array_equal(paths[i, :n].numpy(), g_out[i, :n])
    assert compared >= b // 2
    assert 0 in errs


def test_plain_version_matches_pallas_single_pair_interpret():
    """K5: the single-pair Pallas kernel (talco_pallas.get_pallas_kernel,
    the route of ladder widths above the grouped kernel's cap) in
    interpret mode, against the plain version. The ladder width binds on
    some pairs, so error 2 is compared too; error-6 pairs (band past the
    TPU kernel's static window) are not compared."""
    rng = np.random.default_rng(31)
    m = nuc_matrix()
    padlen, flen_w, marker = 256, 128, 1024
    cases = make_cases(rng, 6, False, 4, maxlen=120)
    kern, maxaln = talco_pallas.get_pallas_kernel(
        padlen, flen_w, 6, marker, m.tobytes(), 6, len(cases),
        interpret=True)
    b = len(cases)
    tot = flen_w + padlen + flen_w + 128
    ref_b = np.zeros((b, 8, tot), np.float32)
    qry_b = np.zeros((b, 8, tot), np.float32)
    rl = np.array([len(c[0]) for c in cases], np.int32)
    ql = np.array([len(c[1]) for c in cases], np.int32)
    for i, (fr, fq, _, _, _) in enumerate(cases):
        go, ge = gap_rows(rl[i], ql[i])
        talco_pallas.pack_pair_into(ref_b[i], qry_b[i], fr, fq, go, ge,
                                    padlen, flen_w)
    nums = np.array([c[2] for c in cases], np.float32)
    (out,) = kern(rl, ql, nums, nums,
                  np.array([c[3] for c in cases], np.int32),
                  np.array([c[4] for c in cases], np.int32),
                  np.full(b, GE, np.float32), np.full(b, GO, np.float32),
                  np.full(b, GE, np.float32), ref_b, qry_b)
    out = np.asarray(out)[:, 0]
    paths, tail = run_port(cases, 6, False, GE, marker)
    compared, errs = 0, set()
    for i in range(b):
        n, e = int(out[i, maxaln - 128]), int(out[i, maxaln - 127])
        if e == 6:
            continue
        compared += 1
        errs.add(e)
        assert int(tail[i, 1]) == e, f"pair {i}"
        if e == 0:      # (on an error the TPU kernel leaves a partial len)
            assert int(tail[i, 0]) == n
            np.testing.assert_array_equal(paths[i, :n], out[i, :n])
    assert compared >= b // 2
    assert 2 in errs and 0 in errs, errs


def test_wrapper_rejects_bad_inputs():
    rng = np.random.default_rng(3)
    cases = make_cases(rng, 6, False, 2)
    ints, floats, offs, ref, qry = pack(cases, 6, False, GE, 1024)
    mat = torch.from_numpy(nuc_matrix())
    kw = dict(p=6, scratch_bytes=int(offs[-1]))
    with pytest.raises(ValueError):
        talco_cuda.talco_align(ints.long(), floats, offs, ref, qry, mat, **kw)
    with pytest.raises(ValueError):
        talco_cuda.talco_align(ints, floats, offs, ref[:, :6], qry[:, :6],
                               mat, **kw)
    with pytest.raises(ValueError):
        talco_cuda.talco_align(ints, floats, offs, ref.transpose(1, 2),
                               qry.transpose(1, 2), mat, **kw)
    meta = [t.to("meta") for t in (ints, floats, offs, ref, qry, mat)]
    with pytest.raises(ValueError, match="unsupported device"):
        talco_cuda.talco_align(*meta, **kw)
    empty = torch.zeros((2, 8, 0))
    with pytest.raises(ValueError, match="padlen"):
        talco_cuda.talco_align(ints, floats, offs, empty, empty, mat, **kw)
    # any padlen is accepted; a pair longer than the launch's padlen gets
    # the layout check's error, as the kernel gives it, and the other
    # pairs of the launch are unaffected
    _, want = talco_cuda.talco_align(ints, floats, offs, ref, qry, mat, **kw)
    long_ints = ints.clone()
    long_ints[0, 0] = PADLEN + 1
    _, tail = talco_cuda.talco_align(long_ints, floats, offs, ref, qry, mat,
                                     **kw)
    assert tail[0].tolist() == [0, talco_cuda.ERR_LAYOUT, 0, 0]
    assert tail[1].tolist() == want[1].tolist()
    assert talco_cuda.talco_align.launches == 0   # no kernel on the CPU


def test_scratch_layout():
    """Per-pair scratch from the tile-width bound min(flen, ref, qry)."""
    offs = talco_cuda.scratch_offsets([1200, 30], [1100, 40], [4096, 8])
    w0 = 1100
    need0 = 56 * w0 + 1025 * w0 + 1200 + 1100 + 8
    assert offs[1] == (need0 + 255) // 256 * 256
    assert offs[2] - offs[1] == (56 * 8 + 1025 * 8 + 70 + 8 + 255) \
        // 256 * 256
