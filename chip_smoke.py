#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (twilight_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: the nvcc build of the TALCO-XDrop kernel, timed;
3. kernel parity (`parity`): 212 seeded profile pairs (nucleotide and
   protein, freq and leaf routes, weighted profiles with gap rows,
   gap_char 0, marker 1024 and 64, lengths 30-2048, unrelated pairs giving
   errors 1 and 2) through the CUDA kernel, held byte-for-byte against
   the NumPy oracle (talco_np.align_freq) and against the kernel's plain
   PyTorch version on CPU tensors;
4. long parity (`long_parity`, the route of the TPU's K4, and of K5 above
   padlen 32768): 68 pairs of 2049-6000 columns, 5 of 25-31 kb and 6 of
   40-70 kb (padlen past 65536), nt and protein, freq and leaf, in
   launches cut and padded as the batcher cuts them, held byte for byte
   against the native host kernel (bit-equal to the oracle by the repo's
   own tests), those up to 3000 columns also against the plain version;
5. wide parity (`wide`, the work of the TPU's K5): 16 pairs whose X-drop
   band outgrows ladder width 4096 (error 2) and fits at 8192 or 16384,
   held to the native host kernel at both widths; the wide launch is
   timed, and the plain version timed on one wide pair;
6. kernel time at the main path's shapes (`time`, batch 128, padlen
   2048): nt freq, nt leaf and protein freq, ms/pair with H2D + kernel +
   D2H and resident, beside the plain version's time on CUDA tensors for
   2 of the pairs;
7. long time (`long_time`): nt freq and nt leaf at 29-30 kb, protein freq
   at 2.9-3 kb, each at the launch size the batcher picks, with DP
   Gcells/s, and the plain version's time for one ~3000-column pair;
8. end to end through the port's entry point (`e2e`;
   `twilight_tpu_torch.cli`, which `python -m twilight_tpu_torch` runs)
   with --backend cuda, the device forced and no host stealing: prot_16
   and sim2k (2000 x 1 kb simulated, --rooted) must give their golden
   md5s with every non-empty pair resolved on the device; sim2k also runs
   on the native host kernel for the wall-time comparison, forced with
   host stealing on, and as a user runs it by default (not forced: the
   level-size gate picks host or device per level, and host threads
   steal), each with the same md5 and its launch count printed. Forced
   device runs of sim2k with --length-deviation 0.02 (706 sequences
   realigned at task 1, where errors 1/2 take the retry ladder) and of 8
   divergent 2 kb sequences (wide X-drop bands) must give the pinned md5
   and the native host kernel's md5;
9. long end to end (`long_e2e`), device forced, each md5-equal to
   --backend native in the same process: 20 x 30 kb nt (the sars_20
   shape, pinned md5) and 12 x 3 kb protein (pinned md5), every
   non-empty pair on the device in long launches; and the 30 kb set with
   one sequence replaced by an unrelated 5 kb one (--length-deviation
   0.1), whose deferred realignment climbs the retry ladder into wide
   launches.

The last two lines are a JSON object with the kernels' figures (K1/K2,
K4, K5) and the result line {"ok": true, "device": {...}}. Without a CUDA
device, or without the rest of the repository beside it, it exits
non-zero.
"""
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

GOLDEN_SIM2K = "624c589fc0fab056e15b3b88047eddf6"
GOLDEN_PROT16 = "8174145594cfcd5404008e233e10ea30"
# sim2k --rooted --length-deviation 0.02 (tests/test_deferred_realign.py)
GOLDEN_SIM2K_DEFER = "224c800d696d24cac399a1630747c39a"
GO, GE = -50.0, -5.0          # the CLI's default gap scores
GOLDEN_S20 = "36d57b4abdd43021ec64b58c40be48be"   # simulate -n 20 -l 30000
GOLDEN_P12 = "f800c5b151b27b3e47881b1865b46a18"   # --type p -n 12 -l 3000
KERNEL_SOURCE = "twilight_tpu_torch/ops/csrc/talco_xdrop.cu"
REPLACES = "twilight_tpu/ops/talco_pallas_g8.py:1672"
REPLACES_LONG = "twilight_tpu/ops/talco_pallas_g8.py:1556"   # hbm_in
REPLACES_WIDE = "twilight_tpu/ops/talco_pallas.py:579"
PLAIN_SUBSET = 2              # pairs timed through the plain version
PLAIN_MAX_COLS = 3000         # long pairs also held to the plain version
LONG_PLAIN_PAIRS = 12         # at most this many of them
WIDE_XDROP = 60000            # bands of 4300-5200-column pairs past 4096


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# synthetic pairs, shaped like what the pipeline hands the batcher
# ---------------------------------------------------------------------------

def _letters(p):
    """ASCII letter of each code (the inverse of the letter table)."""
    from twilight_tpu_torch.ops.device_kernel import letter_lut
    lut = letter_lut("n" if p == 6 else "p")
    out = {}
    for ch in range(65, 91):
        out.setdefault(int(lut[ch]), ch)
    return out


def _evolve(rng, anc, nlet, mutate, indel):
    """A descendant of the ancestral letters: each is dropped, kept, or
    kept after an inserted random letter, and kept letters mutate."""
    import numpy as np
    n = len(anc)
    r = rng.random(n)
    keep = r >= indel / 2
    ins = keep & (r < indel)
    vals = np.where(rng.random(n) < mutate, rng.integers(0, nlet, n), anc)
    both = np.stack([rng.integers(0, nlet, n), vals], 1).ravel()
    seq = both[np.stack([ins, keep], 1).ravel()]
    return seq if len(seq) else anc[:1]


def _profile(rng, base, k, p, gap_rate):
    """Profile of k sequences derived column-wise from base (substitutions
    and gaps in the gap row P-1): [len, P] f32 with row sums k."""
    import numpy as np
    n = len(base)
    freq = np.zeros((n, p), np.float32)
    for s in range(k):
        codes = np.asarray(base).copy()
        if s:
            mut = rng.random(n) < 0.08
            codes[mut] = rng.integers(0, p - 2, int(mut.sum()))
            codes[rng.random(n) < gap_rate] = p - 1
        np.add.at(freq, (np.arange(n), codes), np.float32(1.0))
    return freq


def make_pair(rng, p, leaf, length, related=True, gap_rate=0.05,
              cap=2048):
    """(prepared tuple, meta) for one pair of sides at most `cap` long:
    freq route profiles with position-specific gap scores, or leaf route
    letters."""
    import numpy as np
    nlet = p - 2                       # letters without the ambiguity code
    anc = rng.integers(0, nlet, length)
    if related:
        rseq = _evolve(rng, anc, nlet, 0.12, 0.04)
        qseq = _evolve(rng, anc, nlet, 0.12, 0.04)
    else:
        rseq = list(anc)
        qseq = list(rng.integers(0, nlet, max(30, length
                                                + int(rng.integers(-20, 20)))))
    rseq, qseq = rseq[:cap], qseq[:cap]
    rl, ql = len(rseq), len(qseq)
    if leaf:
        let = _letters(p)
        table = np.zeros(max(let) + 1, np.uint8)
        table[list(let)] = list(let.values())
        cons = (table[np.asarray(rseq, np.int64)],
                table[np.asarray(qseq, np.int64)])
        return (None, None, cons, ([], []), (rl, ql), None, None), \
            (rl, ql, 1, 1)
    kr, kq = int(rng.integers(1, 5)), int(rng.integers(1, 5))
    fr = _profile(rng, rseq, kr, p, gap_rate)
    fq = _profile(rng, qseq, kq, p, gap_rate)

    def psgp(freq, k, base):
        gap = freq[:, p - 1] / np.float32(k)
        return (base * (np.float32(1.0) - np.float32(0.5) * gap)).astype(
            np.float32)
    go = (psgp(fr, kr, np.float32(GO)), psgp(fq, kq, np.float32(GO)))
    ge = (psgp(fr, kr, np.float32(GE)), psgp(fq, kq, np.float32(GE)))
    return ((fr, fq, (None, None), ([], []), (rl, ql), go, ge),
            (rl, ql, kr, kq))


def pack(chunk, prepared, metas, task, p, leaf, param, flen, xdrop, marker,
         pin=False, padlen=2048):
    from twilight_tpu_torch.ops import device_kernel as dk
    if leaf:
        return dk.pack_batch_leaf(chunk, prepared, metas, padlen, p, param,
                                  flen, xdrop, marker=marker, pin=pin)
    return dk.pack_batch(chunk, prepared, metas, task, padlen, p, param,
                         flen, xdrop, marker=marker, pin=pin)


def host_check(job):
    """Host reference of one pair (runs in a worker): the NumPy oracle, or
    the native host kernel when job["native"]; and the plain version on
    CPU tensors at the launch's padlen unless job["plain"] is false."""
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from twilight_tpu.ops import talco_host
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.ops.device_kernel import Params
    p, leaf, marker, task = job["p"], job["leaf"], job["marker"], job["task"]
    prep, meta = job["prep"], job["meta"]
    param = Params.make("n" if p == 6 else "p")
    rl, ql = prep[4]
    if leaf:
        from twilight_tpu_torch.ops.device_kernel import letter_lut
        lut = letter_lut("n" if p == 6 else "p")
        fr = np.zeros((rl, p), np.float32)
        fq = np.zeros((ql, p), np.float32)
        fr[np.arange(rl), lut[prep[2][0]]] = 1.0
        fq[np.arange(ql), lut[prep[2][1]]] = 1.0
        go = (np.full(rl, GO, np.float32), np.full(ql, GO, np.float32))
        ge = (np.full(rl, GE, np.float32), np.full(ql, GE, np.float32))
        gap_char = GE
    else:
        fr, fq, _, _, _, go, ge = prep
        gap_char = 0.0 if task in (1, 2) else GE
    tp = talco_cuda.talco_np.TalcoRunParams(
        param.scoring_matrix, GO, GE, gap_char, job["xdrop"],
        flen=job["flen"], marker=marker)
    engine = (talco_host.align_freq if job.get("native")
              else talco_cuda.talco_np.align_freq)
    gold, gerr = engine(tp, fr, fq, go, ge, (meta[2], meta[3]))
    if not job.get("plain", True):
        return gold, int(gerr), None, None
    st = pack([0], [prep], [meta], task, p, leaf, param, [job["flen"]],
              [job["xdrop"]], marker, padlen=job.get("padlen", 2048))
    mat = torch.from_numpy(param.scoring_matrix.astype(np.float32))
    paths, tail = talco_cuda.talco_align(
        st.ints, st.floats, st.offs, st.ref, st.qry, mat, p=p,
        marker=marker, scratch_bytes=int(st.offs[-1]))
    n = int(tail[0, 0])
    return gold, int(gerr), paths[0, :n].numpy().copy(), tail[0].numpy()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_parity(torch, mp_pool, workers):
    import numpy as np
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.ops.device_kernel import Params
    rng = np.random.default_rng(20261016)
    # (p, leaf, marker, task, pairs, max length)
    groups = [(6, False, 1024, 0, 30, 2048), (6, False, 1024, 1, 14, 2048),
              (6, False, 64, 0, 12, 600), (6, True, 1024, 0, 40, 2048),
              (6, True, 64, 0, 12, 600), (22, False, 1024, 0, 30, 2048),
              (22, False, 1024, 1, 10, 1200), (22, False, 64, 0, 12, 600),
              (22, True, 1024, 0, 40, 2048), (22, True, 64, 0, 12, 600)]
    launches0 = talco_cuda.talco_align.launches
    jobs, kern = [], []
    for p, leaf, marker, task, n, maxlen in groups:
        param = Params.make("n" if p == 6 else "p")
        prepared, metas, flen, xdrop = [], [], [], []
        for t in range(n):
            length = int(np.exp(rng.uniform(np.log(30), np.log(maxlen))))
            kind = t % 10
            prep, meta = make_pair(rng, p, leaf, length,
                                   related=kind not in (3, 7))
            prepared.append(prep)
            metas.append(meta)
            # unrelated pairs with a tight X-drop collapse the band (error
            # 1); a narrow ladder width overflows it (error 2)
            xdrop.append(int(rng.integers(60, 200)) if kind == 3 else 5000)
            flen.append(int(rng.integers(4, 24)) if kind == 7 else 4096)
        st = pack(list(range(n)), prepared, metas, task, p, leaf, param,
                  flen, xdrop, marker)
        paths, tail = _launch_cuda(torch, st, p, marker)
        for i in range(n):
            jobs.append({"p": p, "leaf": leaf, "marker": marker,
                         "task": task, "prep": prepared[i], "meta": metas[i],
                         "flen": flen[i], "xdrop": xdrop[i], "plain": True})
            kern.append((paths[i, :tail[i, 0]].copy(), tail[i].copy(),
                         (p, leaf, marker, task)))
    launched = talco_cuda.talco_align.launches - launches0
    check(launched == len(groups),
          f"parity: launch counter advanced {launched}, expected "
          f"{len(groups)}")
    t0 = time.time()
    bad, max_err, errs, _ = _hold(kern, _host_refs(mp_pool, jobs), "parity")
    print(f"[parity] {len(jobs)} pairs in {len(groups)} launches; error "
          f"codes {dict(sorted(errs.items()))}; oracle + plain version on "
          f"{workers} CPU workers in {time.time() - t0:.1f} s; "
          f"mismatches {bad}; max |kernel - oracle or plain| {max_err} "
          "(tolerance 0: "
          "paths byte-equal, tails equal)", flush=True)
    check(bad == 0, f"parity: {bad} of {len(jobs)} pairs differ")
    check(len(jobs) >= 200, "parity: fewer than 200 pairs")
    check(errs.get(1, 0) > 0 and errs.get(2, 0) > 0,
          "parity: errors 1 and 2 were not both exercised")
    return max_err


def phase_time(torch):
    """Kernel time at the main path's shapes."""
    import numpy as np
    from twilight_tpu_torch.ops.device_kernel import Params
    rng = np.random.default_rng(7)
    shapes = [("nt freq", 6, False, 900, 1200), ("nt leaf", 6, True, 900,
                                                 1200),
              ("protein freq", 22, False, 250, 450)]
    out = {}
    for name, p, leaf, lo, hi in shapes:
        param = Params.make("n" if p == 6 else "p")
        b = 128
        prepared, metas = zip(*[make_pair(rng, p, leaf,
                                          int(rng.integers(lo, hi)))
                                for _ in range(b)])
        flen = [4096] * b
        xdrop = [5000] * b
        st = pack(list(range(b)), prepared, metas, 0, p, leaf, param, flen,
                  xdrop, 1024, pin=True)
        prod, resid, paths, tail = _launch_times(torch, st, p, b, 2048, 5)
        check((tail[:, 1] == 0).all(),
              f"time/{name}: kernel errors {np.unique(tail[:, 1])}")
        # the plain version on CUDA tensors, for the first pairs
        sub = pack(list(range(PLAIN_SUBSET)), prepared, metas, 0, p, leaf,
                   param, flen, xdrop, 1024)
        plain_ms = _plain_ms(torch, sub, p, paths, tail, f"time/{name}")
        cells = int(tail[:, 2].astype(np.int64).sum())
        diags = int(tail[:, 3].astype(np.int64).sum())
        res = {"ms_per_pair_h2d_kernel_d2h": prod / b,
               "ms_per_pair_resident": resid / b,
               "ms_per_launch_resident": resid,
               "plain_ms_per_pair": plain_ms,
               "plain_subset_pairs": PLAIN_SUBSET,
               "dp_cells": cells, "diagonals": diags,
               "gcells_per_s_resident": cells / (resid * 1e6),
               "h2d_bytes": int(st.buf.numel())}
        out[name] = res
        print(f"[time] {name} batch {b} padlen 2048: "
              + json.dumps(res), flush=True)
    return out


def _launch_cuda(torch, st, p, marker=1024):
    """One launch of a packed batch on the card: (paths, tail) as numpy."""
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.ops.device_kernel import Params
    dev = st.views(st.buf.to("cuda"))
    mat = torch.from_numpy(
        Params.make("n" if p == 6 else "p").scoring_matrix).cuda()
    paths, tail = talco_cuda.talco_align(
        dev[1], dev[2], dev[0], dev[3], dev[4], mat, p=p, marker=marker,
        scratch_bytes=int(st.offs[-1]))
    torch.cuda.synchronize()
    return paths.cpu().numpy(), tail.cpu().numpy()


def _host_refs(mp_pool, jobs):
    """host_check over the jobs, the plain-version ones (slowest) first."""
    order = sorted(range(len(jobs)), key=lambda j: not jobs[j]["plain"])
    out = [None] * len(jobs)
    for j, r in zip(order, mp_pool.map(host_check, [jobs[j] for j in order],
                                       chunksize=1)):
        out[j] = r
    return out


def _hold(kern, refs, label):
    """Holds each kernel result (path, tail, key) to its host reference:
    the error code and the path, and, where the plain version ran, the
    whole tail and the path. Returns (mismatches, max |kernel - ref|,
    error counts, pairs held to the plain version)."""
    import numpy as np
    bad, max_err, errs, nplain = 0, 0, {}, 0

    def diff(a, b):
        if len(a) != len(b):
            return 2
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        return int(d.max()) if d.size else 0

    for (kp, kt, key), (gold, gerr, pp, pt) in zip(kern, refs):
        e = int(kt[1])
        errs[e] = errs.get(e, 0) + 1
        ok = e == gerr and (e != 0 or np.array_equal(kp, gold))
        if e == 0 and gerr == 0:
            max_err = max(max_err, diff(kp, gold))
        if pt is not None:
            nplain += 1
            ok = ok and np.array_equal(kt, pt) and (
                e != 0 or np.array_equal(kp, pp))
            max_err = max(max_err, diff(kp, pp), int(np.abs(
                kt.astype(np.int64) - pt.astype(np.int64)).max()))
        if not ok:
            bad += 1
            print(f"[{label}] MISMATCH {key}: kernel tail {kt.tolist()}, "
                  f"host err {gerr} len {len(gold)}, plain tail "
                  f"{None if pt is None else pt.tolist()}", flush=True)
    return bad, max_err, errs, nplain


def _long_pair(rng, p, leaf, lo, hi, related=True):
    """A pair whose longer side is above the 2048 bucket."""
    import numpy as np
    while True:
        length = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        prep, meta = make_pair(rng, p, leaf, length, related=related,
                               cap=hi)
        if max(prep[4]) > 2048:
            return prep, meta


def phase_long_parity(torch, mp_pool, workers):
    """The long route (the TPU's K4, and K5 above padlen 32768): pairs of
    2049-6000 columns, of 25-31 kb and of 40-70 kb (launch padlen past
    65536), nt and protein, freq and leaf, in launches cut and padded as
    the batcher cuts them, held byte for byte against the native host
    kernel, and those up to PLAIN_MAX_COLS columns also against the plain
    version."""
    import numpy as np
    from twilight_tpu_torch.ops import device_kernel as dk
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.ops.device_kernel import Params
    rng = np.random.default_rng(20261017)
    # (p, leaf, task, pairs, min length, max length)
    groups = [(6, False, 0, 20, 2100, 6000), (6, False, 1, 8, 2100, 6000),
              (6, True, 0, 20, 2100, 6000), (22, False, 0, 12, 2100, 6000),
              (22, True, 0, 8, 2100, 6000), (6, False, 0, 2, 25000, 31000),
              (6, True, 0, 2, 25000, 31000), (22, False, 0, 1, 25000, 31000),
              (6, False, 0, 2, 66000, 70000), (6, True, 0, 2, 66000, 70000),
              (6, False, 1, 1, 40000, 45000), (22, False, 0, 1, 40000, 45000)]
    launches0 = talco_cuda.talco_align.launches
    jobs, kern, padlens = [], [], []
    plain_left = LONG_PLAIN_PAIRS
    t0 = time.time()
    for p, leaf, task, n, lo, hi in groups:
        param = Params.make("n" if p == 6 else "p")
        prepared, metas, flen, xdrop = [], [], [], []
        for t in range(n):
            kind = t % 10
            # unrelated pairs with a tight X-drop collapse the band (error
            # 1); a narrow ladder width overflows it (error 2)
            prep, meta = _long_pair(rng, p, leaf, lo, hi,
                                    related=kind != 3)
            prepared.append(prep)
            metas.append(meta)
            xdrop.append(int(rng.integers(60, 200)) if kind == 3 else 5000)
            flen.append(int(rng.integers(4, 24)) if kind == 7 else 4096)
        idxs = sorted(range(n), key=lambda i: -sum(prepared[i][4]))
        rows, esz = (1, 1) if leaf else (talco_cuda.p8_of(p), 4)
        for chunk, padlen in dk.split_launches(idxs, prepared, flen, rows,
                                               esz, 128):
            st = pack(chunk, prepared, metas, task, p, leaf, param, flen,
                      xdrop, 1024, padlen=padlen)
            paths, tail = _launch_cuda(torch, st, p)
            padlens.append(padlen)
            for bi, i in enumerate(chunk):
                plain = (max(prepared[i][4]) <= PLAIN_MAX_COLS
                         and plain_left > 0)
                plain_left -= plain
                jobs.append({"p": p, "leaf": leaf, "marker": 1024,
                             "task": task, "prep": prepared[i],
                             "meta": metas[i], "flen": flen[i],
                             "xdrop": xdrop[i], "native": True,
                             "plain": plain, "padlen": padlen})
                kern.append((paths[bi, :tail[bi, 0]].copy(), tail[bi].copy(),
                             (p, leaf, task, prepared[i][4])))
    launched = talco_cuda.talco_align.launches - launches0
    t_dev = time.time() - t0
    check(launched == len(padlens),
          f"long parity: launch counter advanced {launched}, expected "
          f"{len(padlens)}")
    t0 = time.time()
    refs = _host_refs(mp_pool, jobs)
    bad, max_err, errs, nplain = _hold(kern, refs, "long parity")
    lens = [j["prep"][4] for j in jobs]
    n_mid = sum(1 for ln in lens if 2048 < max(ln) <= 6200)
    n_big = sum(1 for ln in lens if 24000 <= max(ln) <= 32000)
    n_huge = sum(1 for ln in lens if max(ln) >= 39000)
    print(f"[long parity] {len(jobs)} pairs ({n_mid} of 2049-6000 columns, "
          f"{n_big} of 25-31 kb, {n_huge} of 40-70 kb) in {len(padlens)} "
          f"launches at padlen "
          f"{min(padlens)}-{max(padlens)} ({t_dev:.1f} s with packing); "
          f"error codes {dict(sorted(errs.items()))}; native host kernel "
          f"on all, plain version on {nplain}, {workers} CPU workers in "
          f"{time.time() - t0:.1f} s; mismatches {bad}; max |kernel - "
          "host| "
          f"{max_err} (tolerance 0: paths byte-equal, tails equal)",
          flush=True)
    check(bad == 0, f"long parity: {bad} of {len(jobs)} pairs differ")
    check(n_mid >= 64 and n_big >= 4 and n_huge >= 4,
          f"long parity: {n_mid} mid, {n_big} 25-31 kb and {n_huge} "
          "40-70 kb pairs")
    check(max(padlens) > 65536, f"long parity: no launch past padlen 65536 "
          f"(largest {max(padlens)})")
    check(nplain >= 8, f"long parity: only {nplain} pairs held to the "
          "plain version")
    check(errs.get(1, 0) > 0 and errs.get(2, 0) > 0,
          "long parity: errors 1 and 2 were not both exercised")
    return max_err


def _timed(torch, fn, reps):
    """Mean ms of fn over reps launches after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def _launch_times(torch, st, p, b, padlen, reps):
    """(production ms, resident ms, host paths, host tail) of one batch:
    production is H2D + kernel + D2H as the batcher issues them, resident
    the kernel alone on inputs already on the card."""
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.ops.device_kernel import Params, out_views
    mat = torch.from_numpy(
        Params.make("n" if p == 6 else "p").scoring_matrix).cuda()
    scratch = int(st.offs[-1])
    nbytes = b * 2 * padlen + b * 16
    host_out = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    obuf = torch.empty(nbytes, dtype=torch.uint8, device="cuda")

    def production():
        dev = st.views(st.buf.to("cuda", non_blocking=True))
        talco_cuda.talco_align(
            dev[1], dev[2], dev[0], dev[3], dev[4], mat, p=p,
            scratch_bytes=scratch, out=out_views(obuf, b, padlen))
        host_out.copy_(obuf, non_blocking=True)

    resident = st.views(st.buf.to("cuda"))

    def kernel_only():
        talco_cuda.talco_align(
            resident[1], resident[2], resident[0], resident[3],
            resident[4], mat, p=p, scratch_bytes=scratch,
            out=out_views(obuf, b, padlen))

    prod = _timed(torch, production, reps)
    res = _timed(torch, kernel_only, reps)
    production()
    torch.cuda.synchronize()
    paths, tail = out_views(host_out, b, padlen)
    return prod, res, paths.numpy().copy(), tail.numpy().copy()


def _plain_ms(torch, st, p, want_paths, want_tail, label):
    """The plain version's time per pair for the pairs packed in st, on
    CUDA tensors, each held to the kernel's result for it (rows of
    want_paths, want_tail)."""
    import numpy as np
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.ops.device_kernel import Params
    mat = torch.from_numpy(
        Params.make("n" if p == 6 else "p").scoring_matrix).cuda()
    sd = st.views(st.buf.to("cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pp, pt = talco_cuda.talco_align_reference(sd[1], sd[2], sd[3], sd[4],
                                              mat, p=p)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(pt)
    pp, pt = pp.cpu().numpy(), pt.cpu().numpy()
    for i in range(len(pt)):
        n = int(want_tail[i, 0])
        check(np.array_equal(pt[i], want_tail[i])
              and np.array_equal(pp[i, :n], want_paths[i, :n]),
              f"{label}: kernel != plain version on pair {i}")
    return ms


def phase_wide_parity(torch, mp_pool, workers):
    """The wide route (the work of the TPU's K5): pairs of 4300-5200
    columns at a raised X-drop, whose band outgrows the starting ladder
    width 4096 (error 2) and fits at 8192 or 16384. Each runs at both
    widths, held to the native host kernel at the same width; the wide
    launch of the nt pairs is timed, and the plain version's time is
    taken on one of them."""
    import numpy as np
    from twilight_tpu_torch.ops import device_kernel as dk
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.ops.device_kernel import Params
    rng = np.random.default_rng(20261018)
    # (p, task, related pairs, unrelated pairs)
    groups = [(6, 0, 4, 3), (6, 1, 3, 0), (22, 0, 3, 0), (22, 1, 0, 3)]
    launches0 = talco_cuda.talco_align.launches
    nlaunch = 0
    jobs, kern = [], []
    timing = None
    for p, task, n_rel, n_unrel in groups:
        param = Params.make("n" if p == 6 else "p")
        n = n_rel + n_unrel
        prepared, metas = zip(*[
            make_pair(rng, p, False, int(rng.integers(4300, 5200)),
                      related=t < n_rel, cap=6000) for t in range(n)])
        xdrop = [WIDE_XDROP] * n
        wide = [8192 if t % 2 else 16384 for t in range(n)]
        idxs = sorted(range(n), key=lambda i: -sum(prepared[i][4]))
        for flen in ([4096] * n, wide):
            for chunk, padlen in dk.split_launches(
                    idxs, prepared, flen, talco_cuda.p8_of(p), 4, 128):
                st = pack(chunk, prepared, metas, task, p, False, param,
                          flen, xdrop, 1024, pin=True, padlen=padlen)
                paths, tail = _launch_cuda(torch, st, p)
                nlaunch += 1
                for bi, i in enumerate(chunk):
                    jobs.append({"p": p, "leaf": False, "marker": 1024,
                                 "task": task, "prep": prepared[i],
                                 "meta": metas[i], "flen": flen[i],
                                 "xdrop": xdrop[i], "native": True,
                                 "plain": False})
                    kern.append((paths[bi, :tail[bi, 0]].copy(),
                                 tail[bi].copy(),
                                 (p, task, flen[i], prepared[i][4])))
                if flen is wide and (p, task) == (6, 0):
                    timing = (st, chunk, padlen, paths, tail, prepared,
                              metas, param, flen, xdrop)
    check(talco_cuda.talco_align.launches - launches0 == nlaunch,
          "wide parity: launch counter mismatch")
    t0 = time.time()
    refs = _host_refs(mp_pool, jobs)
    bad, max_err, errs, _ = _hold(kern, refs, "wide parity")
    narrow = [int(kt[1]) for _, kt, key in kern if key[2] == 4096]
    widened = [int(kt[1]) for _, kt, key in kern if key[2] > 4096]
    widths = sorted({key[2] for _, _, key in kern if key[2] > 4096})
    print(f"[wide parity] {len(widened)} pairs at ladder width 4096 "
          f"(errors {sorted(set(narrow))}) and at {widths} (errors "
          f"{sorted(set(widened))}) in {nlaunch} launches; native host "
          f"kernel on {workers} CPU workers in {time.time() - t0:.1f} s; "
          f"mismatches {bad}; max |kernel - host| {max_err} (tolerance 0)",
          flush=True)
    check(bad == 0, f"wide parity: {bad} of {len(jobs)} runs differ")
    check(len(widened) >= 16 and set(narrow) == {2} and set(widened) == {0},
          "wide parity: not every pair gave error 2 at 4096 and a path at "
          "the wide width")

    st, chunk, padlen, paths, tail, prepared, metas, param, flen, xdrop = \
        timing
    b = len(chunk)
    prod, res, _, ttail = _launch_times(torch, st, 6, b, padlen, 2)
    check(np.array_equal(ttail, tail), "wide time: results changed")
    cells = int(tail[:, 2].astype(np.int64).sum())
    # the plain version on the pair with the fewest diagonals
    k = min(range(b), key=lambda k: int(tail[k, 3]))
    one = pack([chunk[k]], prepared, metas, 0, 6, False, param, flen, xdrop,
               1024, padlen=padlen)
    plain_ms = _plain_ms(torch, one, 6, paths[k:k + 1], tail[k:k + 1],
                         "wide time")
    out = {"pairs": b, "padlen": padlen, "xdrop": WIDE_XDROP,
           "widths": [flen[i] for i in chunk],
           "ms_per_pair_h2d_kernel_d2h": prod / b,
           "ms_per_pair_resident": res / b, "ms_per_launch_resident": res,
           "dp_cells": cells, "gcells_per_s_resident": cells / (res * 1e6),
           "plain_ms_per_pair": plain_ms,
           "plain_shape": f"nt freq {prepared[chunk[k]][4][0]} x "
                          f"{prepared[chunk[k]][4][1]}, width "
                          f"{flen[chunk[k]]}, {int(tail[k, 3])} diagonals, "
                          f"{int(tail[k, 2])} cells"}
    print("[wide time] nt freq: " + json.dumps(out), flush=True)
    return max_err, out


def phase_long_time(torch):
    """Kernel time on the long route at the launch size the batcher picks:
    nt freq and nt leaf at 29-30 kb, protein freq at 2.9-3 kb; and the
    plain version's time on CUDA tensors for one ~3000-column nt freq
    pair (a 30 kb pair through it takes minutes)."""
    import numpy as np
    from twilight_tpu_torch.ops import device_kernel as dk
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.ops.device_kernel import Params
    rng = np.random.default_rng(8)
    shapes = [("nt freq", 6, False, 29000, 30000),
              ("nt leaf", 6, True, 29000, 30000),
              ("protein freq", 22, False, 2900, 3000)]
    out = {}
    for name, p, leaf, lo, hi in shapes:
        param = Params.make("n" if p == 6 else "p")
        rows, esz = (1, 1) if leaf else (talco_cuda.p8_of(p), 4)
        # pairs for one launch: the batcher's cut of 128 such pairs
        # (the budgets bind first on the long freq route)
        b = len(dk.split_launches(
            list(range(128)), [(None,) * 4 + ((hi, hi),)] * 128,
            [4096] * 128, rows, esz, 128)[0][0])
        prepared, metas = zip(*[make_pair(rng, p, leaf,
                                          int(rng.integers(lo, hi)), cap=hi)
                                for _ in range(b)])
        flen, xdrop = [4096] * b, [5000] * b
        idxs = sorted(range(b), key=lambda i: -sum(prepared[i][4]))
        (chunk, padlen), = dk.split_launches(idxs, prepared, flen, rows,
                                             esz, 128)
        st = pack(chunk, prepared, metas, 0, p, leaf, param, flen, xdrop,
                  1024, pin=True, padlen=padlen)
        prod, res, paths, tail = _launch_times(torch, st, p, b, padlen, 3)
        check((tail[:, 1] == 0).all(),
              f"long time/{name}: kernel errors {np.unique(tail[:, 1])}")
        cells = int(tail[:, 2].astype(np.int64).sum())
        diags = int(tail[:, 3].astype(np.int64).sum())
        res_ = {"pairs": b, "padlen": padlen,
                "ms_per_pair_h2d_kernel_d2h": prod / b,
                "ms_per_pair_resident": res / b,
                "ms_per_launch_resident": res,
                "ms_per_launch_h2d_kernel_d2h": prod,
                "dp_cells": cells, "diagonals": diags,
                "max_diagonals_per_pair": int(tail[:, 3].max()),
                "gcells_per_s_resident": cells / (res * 1e6),
                "h2d_bytes": int(st.buf.numel())}
        out[name] = res_
        print(f"[long time] {name}: " + json.dumps(res_), flush=True)
    # the plain version for one ~3000-column nt freq pair (long route)
    param = Params.make("n")
    prep, meta = _long_pair(rng, 6, False, 3000, 3001)
    padlen = dk.launch_padlen(max(prep[4]))
    st = pack([0], [prep], [meta], 0, 6, False, param, [4096], [5000], 1024,
              padlen=padlen)
    paths, tail = _launch_cuda(torch, st, 6)
    check(tail[0, 1] == 0, "long time/plain: kernel error")
    plain_ms = _plain_ms(torch, st, 6, paths, tail, "long time/plain")
    out["plain"] = {"ms_per_pair": plain_ms,
                    "shape": f"nt freq {prep[4][0]} x {prep[4][1]}, padlen "
                             f"{padlen}, {int(tail[0, 3])} diagonals, "
                             f"{int(tail[0, 2])} cells"}
    print("[long time] plain version on CUDA tensors: "
          + json.dumps(out["plain"]), flush=True)
    return out


def _md5(path):
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def e2e_run(torch, runs, td, label, argv, golden, device=True, force=True,
            steal=False, task0_errors=0):
    """One run of the port's entry point, held to md5 `golden` (None: no
    pinned value). `force` sends every level's DP to the device
    (TWILIGHT_FORCE_DEVICE; else the level-size gate picks host or device
    per level), and unless `steal` no host thread steals a pair
    (TWILIGHT_NO_STEAL). A forced run must resolve every non-empty pair
    on the device, bar those stolen and exactly `task0_errors` pairs that
    the reference defers at task 0 (the device's error is their answer).
    The launch count is zeroed just before the run and read just after."""
    from twilight_tpu_torch import cli
    from twilight_tpu_torch.ops import talco_cuda
    out = os.path.join(td, label + ".aln")
    os.environ.pop("TWILIGHT_FORCE_DEVICE", None)
    os.environ.pop("TWILIGHT_NO_STEAL", None)
    if force:
        os.environ["TWILIGHT_FORCE_DEVICE"] = "1"
    if not steal:
        os.environ["TWILIGHT_NO_STEAL"] = "1"
    talco_cuda.talco_align.launches = 0
    t0 = time.time()
    rc, kernel = cli.run(argv + ["-o", out])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = talco_cuda.talco_align.launches
    check(rc == 0, f"e2e/{label}: exit code {rc}")
    md5 = _md5(out)
    rec = {"wall_s": wall, "md5": md5, "launches": launches}
    if device:
        rec.update(kernel.stats)
    runs[label] = rec
    print(f"[e2e] {label}: " + json.dumps(rec), flush=True)
    check(golden is None or md5 == golden,
          f"e2e/{label}: md5 {md5} != {golden}")
    if device:
        st = kernel.stats
        check(launches == st["launches"],
              f"e2e/{label}: {launches} kernel launches, the batcher "
              f"counted {st['launches']}")
    if device and force:
        check(launches > 0, f"e2e/{label}: the kernel never launched")
        check(st["task0_errors"] == task0_errors,
              f"e2e/{label}: {st['task0_errors']} task-0 errors, expected "
              f"{task0_errors}")
        check(steal or st["host_stolen"] == 0,
              f"e2e/{label}: {st['host_stolen']} pairs stolen with "
              "TWILIGHT_NO_STEAL set")
        check(st["pairs_on_device"] + task0_errors + st["host_stolen"]
              == st["pairs"] - st["zero_length"],
              f"e2e/{label}: {st['pairs_on_device']} of "
              f"{st['pairs'] - st['zero_length']} non-empty pairs resolved "
              f"on the device ({st['host_stolen']} stolen, {task0_errors} "
              "deferred at task 0)")
    return rec


def simulate(td, name, *args):
    prefix = os.path.join(td, name)
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "twilight_tpu.tools.simulate",
                        *args, "-o", prefix], cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    check(r.returncode == 0, f"simulate failed: {r.stderr[-500:]}")
    print(f"[e2e] {name} generated in {time.time() - t0:.1f} s", flush=True)
    return ["-t", prefix + ".nwk", "-i", prefix + ".fa"]


def phase_e2e(torch, td):
    runs = {}

    def run(*a, **k):
        return e2e_run(torch, runs, td, *a, **k)

    prot = os.path.join(REPO, "tests", "data", "prot_16")
    run("prot_16", ["--backend", "cuda", "-t", prot + ".nwk", "-i",
                    prot + ".fa", "--type", "p"], GOLDEN_PROT16)
    sim = simulate(td, "sim2k", "-n", "2000", "-l", "1000", "--seed", "0") \
        + ["--rooted"]
    run("sim2k_cuda", ["--backend", "cuda"] + sim, GOLDEN_SIM2K)
    run("sim2k_native", ["--backend", "native"] + sim, GOLDEN_SIM2K,
        device=False)
    # host threads steal pairs from the tail while the launches are in
    # flight (both engines give the same bits)
    run("sim2k_cuda_steal", ["--backend", "cuda"] + sim, GOLDEN_SIM2K,
        steal=True)
    # the default --backend cuda run: the level-size gate picks host or
    # device per level, and host threads steal
    run("sim2k_cuda_hybrid", ["--backend", "cuda"] + sim, GOLDEN_SIM2K,
        force=False, steal=True)
    # 706 deferred sequences realigned one pair per level at task 1,
    # where errors 1/2 take the retry ladder
    run("sim2k_defer_cuda", ["--backend", "cuda", "--length-deviation",
                             "0.02"] + sim, GOLDEN_SIM2K_DEFER)
    # divergent 2 kb sequences: X-drop bands far wider than the TPU
    # kernel's starting window
    div = simulate(td, "div8", "-n", "8", "-l", "2000", "-m", "0.25",
                   "--seed", "13")
    want = run("div8_native", ["--backend", "native"] + div, None,
               device=False)["md5"]
    run("div8_cuda", ["--backend", "cuda"] + div, want)
    return runs


def _with_unrelated(argv, td, name, index, length, seed):
    """The simulated set of argv with sequence `index` replaced by an
    unrelated random sequence of `length` letters (same tree)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    src = argv[argv.index("-i") + 1]
    recs, cur = [], None
    with open(src) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                cur = [line, []]
                recs.append(cur)
            elif line:
                cur[1].append(line)
    recs[index][1] = ["".join(np.array(list("ACGT"))[
        rng.integers(0, 4, length)])]
    dst = os.path.join(td, name + ".fa")
    with open(dst, "w") as f:
        for head, body in recs:
            f.write(head + "\n" + "".join(body) + "\n")
    return ["-t", argv[argv.index("-t") + 1], "-i", dst]


def phase_long_e2e(torch, td):
    """Long genomes and proteins through the entry point with the device
    forced, each md5-equal to --backend native in this process: 20 x 30 kb
    nt (the sars_20 shape; pinned md5), 12 x 3 kb protein (pinned md5),
    and the 30 kb set with one sequence replaced by an unrelated 5 kb one
    and --length-deviation 0.1, so that its deferred realignment at task
    1 climbs the retry ladder past width 4096 (wide launches)."""
    runs = {}

    def run(*a, **k):
        return e2e_run(torch, runs, td, *a, **k)

    s20 = simulate(td, "s20", "-n", "20", "-l", "30000", "--seed", "5")
    p12 = simulate(td, "p12", "--type", "p", "-n", "12", "-l", "3000",
                   "--seed", "5") + ["--type", "p"]
    w20 = _with_unrelated(s20, td, "w20", 7, 5000, 11) \
        + ["--length-deviation", "0.1"]
    # w20's unrelated sequence is deferred at task 0: one device error
    for label, argv, golden, task0 in (("s20", s20, GOLDEN_S20, 0),
                                       ("p12", p12, GOLDEN_P12, 0),
                                       ("w20", w20, None, 1)):
        cuda = run(label + "_cuda", ["--backend", "cuda"] + argv, golden,
                   task0_errors=task0)
        native = run(label + "_native", ["--backend", "native"] + argv,
                     golden, device=False)
        check(cuda["md5"] == native["md5"],
              f"e2e/{label}: cuda md5 {cuda['md5']} != native "
              f"{native['md5']}")
        check(cuda["host_wide"] == 0, f"e2e/{label}: host_wide > 0")
        if label == "w20":
            check(cuda["wide_launches"] > 0 and cuda["ladder_relaunches"] > 0,
                  "e2e/w20: no wide launch on the ladder")
        else:
            check(cuda["long_launches"] > 0, f"e2e/{label}: no long launch")
    return runs


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "twilight_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (the "
              "twilight_tpu_torch package is not beside this script)",
              file=sys.stderr)
        return 2
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    from twilight_tpu_torch.ops import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    # the card's name and power limit, as nvidia-smi gives them
    print(smi_line, flush=True)
    print(f"[device] torch: {kind}, {count} device(s), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.time()
    build.load()
    print(f"[build] nvcc {build.build_seconds or 0.0:.2f} s, load "
          f"{time.time() - t0:.2f} s, flags {' '.join(build.NVCC_FLAGS)}",
          flush=True)

    # the native host kernel is the long phases' reference: build it once
    # here, before any worker or pool thread asks for it
    from twilight_tpu.ops import talco_host
    check(talco_host.get_lib() is not None,
          "the native host kernel (twilight_tpu/native/talco.cpp) did not "
          "build")

    workers = max(1, min(8, os.cpu_count() or 1))
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")
                             ) as pool:
        parity_err = phase_parity(torch, pool, workers)
        long_err = phase_long_parity(torch, pool, workers)
        wide_err, wide = phase_wide_parity(torch, pool, workers)
    timing = phase_time(torch)
    long_time = phase_long_time(torch)
    with tempfile.TemporaryDirectory() as td:
        runs = phase_e2e(torch, td)
        long_runs = phase_long_e2e(torch, td)

    nt = timing["nt freq"]
    for label in ("sim2k", "s20", "p12", "w20"):
        r = runs if label == "sim2k" else long_runs
        print(f"[summary] {label} cuda {r[label + '_cuda']['wall_s']:.3f} s "
              f"vs native {r[label + '_native']['wall_s']:.3f} s on "
              f"{os.cpu_count()} cores; card {smi_line}", flush=True)
    # --backend cuda as a user runs it by default: how many launches the
    # level-size gate let through
    for label in ("sim2k_cuda_hybrid", "sim2k_cuda_steal"):
        print(f"[summary] {label} {runs[label]['wall_s']:.3f} s, "
              f"{runs[label]['launches']} launches, "
              f"{runs[label]['host_stolen']} pairs stolen, vs native "
              f"{runs['sim2k_native']['wall_s']:.3f} s", flush=True)
    print(json.dumps({"kernels": [
        {"name": "talco_xdrop (K1/K2: freq and leaf, padlen 2048)",
         "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
         "launches": runs["sim2k_cuda"]["launches"],
         "max_abs_err": parity_err,
         "ms": nt["ms_per_pair_resident"],
         "plain_ms": nt["plain_ms_per_pair"]},
        {"name": "talco_xdrop (K4: long route, padlen above 2048)",
         "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES_LONG,
         "launches": long_runs["s20_cuda"]["long_launches"],
         "max_abs_err": long_err,
         "ms": long_time["nt freq"]["ms_per_pair_resident"],
         "plain_ms": long_time["plain"]["ms_per_pair"]},
        {"name": "talco_xdrop (K5: wide route, ladder width above 4096)",
         "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES_WIDE,
         "launches": long_runs["w20_cuda"]["wide_launches"],
         "max_abs_err": wide_err,
         "ms": wide["ms_per_pair_resident"],
         "plain_ms": wide["plain_ms_per_pair"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
