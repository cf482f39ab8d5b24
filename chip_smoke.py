#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (twilight_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: the nvcc build of the TALCO-XDrop kernel, timed;
3. kernel parity: 212 seeded profile pairs (nucleotide and protein, freq
   and leaf routes, weighted profiles with gap rows, gap_char 0, marker
   1024 and 64, lengths 30-2048, unrelated pairs giving errors 1 and 2)
   through the CUDA kernel, held byte-for-byte against the NumPy oracle
   (talco_np.align_freq) and against the kernel's plain PyTorch version on
   CPU tensors;
4. kernel time at the main path's shapes (batch 128, padlen 2048): nt freq,
   nt leaf and protein freq, ms/pair with H2D + kernel + D2H and resident,
   beside the plain version's time on CUDA tensors for 2 of the pairs;
5. end to end through the port's entry point (`twilight_tpu_torch.cli`,
   which `python -m twilight_tpu_torch` runs) with --backend cuda, the
   device forced and no host stealing: prot_16 and sim2k (2000 x 1 kb
   simulated, --rooted) must give their golden md5s with every non-empty
   pair resolved on the device; sim2k also runs on the native host kernel
   for the wall-time comparison, and once more with --backend cuda
   unforced (host stealing on), which must give the same md5. Forced
   device runs of sim2k with --length-deviation 0.02 (706 sequences
   realigned at task 1, where errors 1/2 take the retry ladder) and of
   8 divergent 2 kb sequences (wide X-drop bands) must give the pinned
   md5 and the native host kernel's md5.

The last two lines are a JSON object with the kernel's figures and the
result line {"ok": true, "device": {...}}. Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero.
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
KERNEL_SOURCE = "twilight_tpu_torch/ops/csrc/talco_xdrop.cu"
REPLACES = "twilight_tpu/ops/talco_pallas_g8.py:1672"
PLAIN_SUBSET = 2              # pairs timed through the plain version


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
    seq = []
    for c in anc:
        r = rng.random()
        if r < indel / 2:
            continue
        if r < indel:
            seq.append(int(rng.integers(0, nlet)))
        seq.append(int(rng.integers(0, nlet)) if rng.random() < mutate
                   else int(c))
    return seq or [int(anc[0])]


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


def make_pair(rng, p, leaf, length, related=True, gap_rate=0.05):
    """(prepared tuple, meta) for one pair: freq route profiles with
    position-specific gap scores, or leaf route letters."""
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
    rseq, qseq = rseq[:2048], qseq[:2048]
    rl, ql = len(rseq), len(qseq)
    if leaf:
        let = _letters(p)
        cons = (np.array([let[c] for c in rseq], np.uint8),
                np.array([let[c] for c in qseq], np.uint8))
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
         pin=False):
    from twilight_tpu_torch.ops import device_kernel as dk
    if leaf:
        return dk.pack_batch_leaf(chunk, prepared, metas, 2048, p, param,
                                  flen, xdrop, marker=marker, pin=pin)
    return dk.pack_batch(chunk, prepared, metas, task, 2048, p, param, flen,
                         xdrop, marker=marker, pin=pin)


def host_check(job):
    """Oracle and plain-version result of one pair (runs in a worker)."""
    import numpy as np
    import torch
    torch.set_num_threads(1)
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
    gold, gerr = talco_cuda.talco_np.align_freq(tp, fr, fq, go, ge,
                                                (meta[2], meta[3]))
    st = pack([0], [prep], [meta], task, p, leaf, param, [job["flen"]],
              [job["xdrop"]], marker)
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
        dev = st.views(st.buf.to("cuda"))
        mat = torch.from_numpy(param.scoring_matrix).cuda()
        paths, tail = talco_cuda.talco_align(
            dev[1], dev[2], dev[0], dev[3], dev[4], mat, p=p, marker=marker,
            scratch_bytes=int(st.offs[-1]))
        torch.cuda.synchronize()
        paths, tail = paths.cpu().numpy(), tail.cpu().numpy()
        for i in range(n):
            jobs.append({"p": p, "leaf": leaf, "marker": marker,
                         "task": task, "prep": prepared[i], "meta": metas[i],
                         "flen": flen[i], "xdrop": xdrop[i]})
            kern.append((paths[i, :tail[i, 0]].copy(), tail[i].copy(),
                         (p, leaf, marker, task)))
    launched = talco_cuda.talco_align.launches - launches0
    check(launched == len(groups),
          f"parity: launch counter advanced {launched}, expected "
          f"{len(groups)}")
    t0 = time.time()
    ref = list(mp_pool.map(host_check, jobs, chunksize=1))
    errs = {}
    max_err = 0
    bad = 0
    for (kp, kt, key), (gold, gerr, pp, pt) in zip(kern, ref):
        e = int(kt[1])
        errs[e] = errs.get(e, 0) + 1
        ok = (e == gerr == int(pt[1]) and np.array_equal(kt, pt)
              and (e != 0 or (np.array_equal(kp, gold)
                              and np.array_equal(kp, pp))))
        if len(kp) == len(pp):
            d = np.abs(kp.astype(np.int32) - pp.astype(np.int32))
            max_err = max(max_err, int(d.max()) if d.size else 0)
        else:
            max_err = max(max_err, 2)
        max_err = max(max_err, int(np.abs(kt.astype(np.int64)
                                          - pt.astype(np.int64)).max()))
        if not ok:
            bad += 1
            print(f"[parity] MISMATCH {key}: kernel tail {kt.tolist()} "
                  f"oracle err {gerr} len {len(gold)}, plain tail "
                  f"{pt.tolist()}", flush=True)
    print(f"[parity] {len(jobs)} pairs in {len(groups)} launches; error "
          f"codes {dict(sorted(errs.items()))}; oracle + plain version on "
          f"{workers} CPU workers in {time.time() - t0:.1f} s; "
          f"mismatches {bad}; max |kernel - plain| {max_err} (tolerance 0: "
          "paths byte-equal, tails equal)", flush=True)
    check(bad == 0, f"parity: {bad} of {len(jobs)} pairs differ")
    check(len(jobs) >= 200, "parity: fewer than 200 pairs")
    check(errs.get(1, 0) > 0 and errs.get(2, 0) > 0,
          "parity: errors 1 and 2 were not both exercised")
    return max_err


def phase_time(torch):
    """Kernel time at the main path's shapes."""
    import numpy as np
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.ops.device_kernel import Params, out_views
    rng = np.random.default_rng(7)
    shapes = [("nt freq", 6, False, 900, 1200), ("nt leaf", 6, True, 900,
                                                 1200),
              ("protein freq", 22, False, 250, 450)]
    out = {}
    max_err = 0
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
        mat = torch.from_numpy(param.scoring_matrix).cuda()
        scratch = int(st.offs[-1])
        nbytes = b * 2 * 2048 + b * 16
        host_out = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        obuf = torch.empty(nbytes, dtype=torch.uint8, device="cuda")

        def production():
            dev = st.views(st.buf.to("cuda", non_blocking=True))
            talco_cuda.talco_align(
                dev[1], dev[2], dev[0], dev[3], dev[4], mat, p=p,
                scratch_bytes=scratch, out=out_views(obuf, b, 2048))
            host_out.copy_(obuf, non_blocking=True)

        resident = st.views(st.buf.to("cuda"))

        def kernel_only():
            talco_cuda.talco_align(
                resident[1], resident[2], resident[0], resident[3],
                resident[4], mat, p=p, scratch_bytes=scratch,
                out=out_views(obuf, b, 2048))

        times = {}
        for label, fn in (("production", production),
                          ("resident", kernel_only)):
            fn()                                  # warm-up
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            reps = 5
            e0.record()
            for _ in range(reps):
                fn()
            e1.record()
            e1.synchronize()
            times[label] = e0.elapsed_time(e1) / reps
        paths, tail = out_views(host_out, b, 2048)
        production()
        torch.cuda.synchronize()
        paths, tail = paths.numpy().copy(), tail.numpy().copy()
        check((tail[:, 1] == 0).all(),
              f"time/{name}: kernel errors {np.unique(tail[:, 1])}")
        # the plain version on CUDA tensors, for the first pairs
        sub = pack(list(range(PLAIN_SUBSET)), prepared, metas, 0, p, leaf,
                   param, flen, xdrop, 1024)
        sd = sub.views(sub.buf.to("cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pp, pt = talco_cuda.talco_align_reference(sd[1], sd[2], sd[3], sd[4],
                                                  mat, p=p)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3 / PLAIN_SUBSET
        pp, pt = pp.cpu().numpy(), pt.cpu().numpy()
        for i in range(PLAIN_SUBSET):
            n = int(tail[i, 0])
            check(np.array_equal(tail[i], pt[i])
                  and np.array_equal(paths[i, :n], pp[i, :n]),
                  f"time/{name}: kernel != plain version on pair {i}")
            max_err = max(max_err, int(np.abs(
                paths[i, :n].astype(np.int32) - pp[i, :n]).max()))
        cells = int(tail[:, 2].astype(np.int64).sum())
        diags = int(tail[:, 3].astype(np.int64).sum())
        res = {"ms_per_pair_h2d_kernel_d2h": times["production"] / b,
               "ms_per_pair_resident": times["resident"] / b,
               "ms_per_launch_resident": times["resident"],
               "plain_ms_per_pair": plain_ms,
               "plain_subset_pairs": PLAIN_SUBSET,
               "dp_cells": cells, "diagonals": diags,
               "gcells_per_s_resident": cells / (times["resident"] * 1e6),
               "h2d_bytes": int(st.buf.numel())}
        out[name] = res
        print(f"[time] {name} batch {b} padlen 2048: "
              + json.dumps(res), flush=True)
    return out, max_err


def _md5(path):
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def phase_e2e(torch, td):
    from twilight_tpu_torch import cli
    from twilight_tpu_torch.ops import talco_cuda
    forced = {"TWILIGHT_FORCE_DEVICE": "1", "TWILIGHT_NO_STEAL": "1"}
    runs = {}

    def run(label, argv, golden, device=True, force=True):
        """One run of the entry point, held to md5 `golden` (None: no
        pinned value); force pins every pair's DP to the device, else the
        level-size rule and host stealing apply."""
        out = os.path.join(td, label + ".aln")
        for k, v in forced.items():
            if force:
                os.environ[k] = v
            else:
                os.environ.pop(k, None)
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
        if device and force:
            st = kernel.stats
            check(launches > 0, f"e2e/{label}: the kernel never launched")
            check(st["pairs_on_device"] == st["pairs"] - st["zero_length"],
                  f"e2e/{label}: {st['pairs_on_device']} of "
                  f"{st['pairs'] - st['zero_length']} non-empty pairs "
                  "resolved on the device")
        return rec

    def simulate(name, *args):
        prefix = os.path.join(td, name)
        t0 = time.time()
        r = subprocess.run([sys.executable, "-m",
                            "twilight_tpu.tools.simulate", *args, "-o",
                            prefix], cwd=REPO, capture_output=True,
                           text=True, timeout=600)
        check(r.returncode == 0, f"simulate failed: {r.stderr[-500:]}")
        print(f"[e2e] {name} generated in {time.time() - t0:.1f} s",
              flush=True)
        return ["-t", prefix + ".nwk", "-i", prefix + ".fa"]

    prot = os.path.join(REPO, "tests", "data", "prot_16")
    run("prot_16", ["--backend", "cuda", "-t", prot + ".nwk", "-i",
                    prot + ".fa", "--type", "p"], GOLDEN_PROT16)
    sim = simulate("sim2k", "-n", "2000", "-l", "1000", "--seed", "0") \
        + ["--rooted"]
    run("sim2k_cuda", ["--backend", "cuda"] + sim, GOLDEN_SIM2K)
    run("sim2k_native", ["--backend", "native"] + sim, GOLDEN_SIM2K,
        device=False)
    # the default --backend cuda run: host threads steal pairs while the
    # launches are in flight
    run("sim2k_cuda_hybrid", ["--backend", "cuda"] + sim, GOLDEN_SIM2K,
        force=False)
    # 706 deferred sequences realigned one pair per level at task 1,
    # where errors 1/2 take the retry ladder
    run("sim2k_defer_cuda", ["--backend", "cuda", "--length-deviation",
                             "0.02"] + sim, GOLDEN_SIM2K_DEFER)
    # divergent 2 kb sequences: X-drop bands far wider than the TPU
    # kernel's starting window
    div = simulate("div8", "-n", "8", "-l", "2000", "-m", "0.25", "--seed",
                   "13")
    want = run("div8_native", ["--backend", "native"] + div, None,
               device=False)["md5"]
    run("div8_cuda", ["--backend", "cuda"] + div, want)
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

    workers = max(1, min(8, os.cpu_count() or 1))
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")
                             ) as pool:
        parity_err = phase_parity(torch, pool, workers)
    timing, time_err = phase_time(torch)
    with tempfile.TemporaryDirectory() as td:
        runs = phase_e2e(torch, td)

    nt = timing["nt freq"]
    print(f"[summary] sim2k cuda {runs['sim2k_cuda']['wall_s']:.3f} s vs "
          f"native {runs['sim2k_native']['wall_s']:.3f} s on "
          f"{os.cpu_count()} cores; card {smi_line}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "talco_xdrop",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": runs["sim2k_cuda"]["launches"],
        "max_abs_err": max(parity_err, time_err),
        "ms": nt["ms_per_pair_resident"],
        "plain_ms": nt["plain_ms_per_pair"],
    }]}), flush=True)
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
