"""Synthetic TALCO-XDrop inputs, checks and timers for the kernel.

Shared by `chip_smoke.py` and the tools (`fuzz_talco`, `bench_kernel`,
`talco_ab`, `talco_profile`): seeded profile pairs shaped like what the
pipeline hands the batcher, the batcher's packers, one launch on the card
or on the CPU, the host references a launch is held to (the NumPy oracle,
the native host kernel, the plain version) and the comparison, a
CUDA-event timer, the launch round trip behind the level gate, the
kernel's bound on the H100, and the device time in a profiler trace. The
package's modules are imported inside the functions, so that a caller
may put another checkout's package first on sys.path and measure it on
the same inputs.
"""
from __future__ import annotations

import time

import numpy as np

GO, GE = -50.0, -5.0          # the CLI's default gap scores
WIDE_XDROP = 60000            # bands of 4300-5200-column pairs past 4096
GATE_PAIRS, GATE_COLS, GATE_REPS = 8, 100, 50   # the launch round trip
# f32 operations per DP cell of talco_xdrop.cu: similarity<P> (P = 6: 5
# rows of 10 mul + 5 add, 2 x 5 gap terms of 2 mul + 1 add, 1 div = 106;
# P = 22: 21 rows of 16 + 24 + 15 + 7 + 1, 2 x 21 gap terms of 3, 1 div =
# 1450; leaf: a matrix entry + 0.0f = 1) plus the recurrence (5 adds: the
# match and 4 gap terms; 6 compares: 2 gap pointers, 2 for the best
# state, the X-drop cut, the live test; 4 selects; the max = 16)
OPS_PER_CELL = {"nt freq": 122, "nt leaf": 17, "protein freq": 1466,
                "protein leaf": 17}
F32_PEAK = 67e12               # H100 SXM f32 outside the tensor cores
HBM_PEAK = 3.35e12             # H100 SXM device memory, bytes/s


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


def _scaled_profile(rng, base, num, p, gap_rate):
    """Profile of `num` sequences derived column-wise from base, drawn as
    counts (no loop over the sequences): each column holds Binomial(num,
    gap_rate) gaps and Binomial(rest, 0.08) substitutions spread over the
    letters, the rest on the base letter. Then, as calculate_profile
    gives a stored profile back, divided by the side's weight and
    multiplied by num in f32: [len, P] f32 of row sums near num, not all
    integers."""
    n = len(base)
    gaps = rng.binomial(num, gap_rate, n)
    subs = rng.binomial(num - gaps, 0.08)
    counts = rng.multinomial(subs, np.full(p - 2, 1.0 / (p - 2))).astype(
        np.int64)
    counts[np.arange(n), np.asarray(base)] += num - gaps - subs
    freq = np.zeros((n, p), np.float32)
    freq[:, :p - 2] = counts
    freq[:, p - 1] = gaps
    weight = np.float32(num * rng.uniform(0.5, 1.5))
    stored = (freq / np.float32(num)) * weight
    return (stored / weight) * np.float32(num)


def make_pair(rng, p, leaf, length, related=True, gap_rate=0.05,
              cap=2048, counts=None):
    """(prepared tuple, meta) for one pair of sides at most `cap` long:
    freq route profiles with position-specific gap scores, or leaf route
    letters. `counts` (ref, qry), freq only: each side stands for that
    many sequences (_scaled_profile); else 1-4 sequences a side."""
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
    if counts is None:
        kr, kq = int(rng.integers(1, 5)), int(rng.integers(1, 5))
        fr = _profile(rng, rseq, kr, p, gap_rate)
        fq = _profile(rng, qseq, kq, p, gap_rate)
    else:
        kr, kq = counts
        fr = _scaled_profile(rng, rseq, kr, p, gap_rate)
        fq = _scaled_profile(rng, qseq, kq, p, gap_rate)

    def psgp(freq, k, base):
        gap = freq[:, p - 1] / np.float32(k)
        return (base * (np.float32(1.0) - np.float32(0.5) * gap)).astype(
            np.float32)
    go = (psgp(fr, kr, np.float32(GO)), psgp(fq, kq, np.float32(GO)))
    ge = (psgp(fr, kr, np.float32(GE)), psgp(fq, kq, np.float32(GE)))
    return ((fr, fq, (None, None), ([], []), (rl, ql), go, ge),
            (rl, ql, kr, kq))


def long_pair(rng, p, leaf, lo, hi, related=True, counts=None):
    """A pair (make_pair) of about lo-hi columns, log-uniform, whose
    longer side is above the 2048 bucket."""
    while True:
        length = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        prep, meta = make_pair(rng, p, leaf, length, related=related,
                               cap=hi, counts=counts)
        if max(prep[4]) > 2048:
            return prep, meta


def pack(chunk, prepared, metas, task, p, leaf, param, flen, xdrop, marker,
         pin=False, padlen=2048):
    """The batcher's packed launch of the pairs `chunk` (the freq or the
    leaf packer)."""
    from twilight_tpu_torch.ops import device_kernel as dk
    if leaf:
        return dk.pack_batch_leaf(chunk, prepared, metas, padlen, p, param,
                                  flen, xdrop, marker=marker, pin=pin)
    return dk.pack_batch(chunk, prepared, metas, task, padlen, p, param,
                         flen, xdrop, marker=marker, pin=pin)


def _matrix(torch, p, device):
    from twilight_tpu_torch.config import Params
    return torch.from_numpy(Params.make("n" if p == 6 else "p")
                            .scoring_matrix.astype(np.float32)).to(device)


def launch(torch, st, p, marker=1024, device="cuda"):
    """One launch of a packed batch: (paths, tail) as numpy. On "cuda"
    the kernel runs on copies of the inputs (synchronised); on "cpu" the
    wrapper runs its plain version on the staging tensors themselves."""
    from twilight_tpu_torch.ops import talco_cuda
    views = st.views(st.buf.to(device))
    paths, tail = talco_cuda.talco_align(
        views[1], views[2], views[0], views[3], views[4],
        _matrix(torch, p, device), p=p, marker=marker,
        scratch_bytes=int(st.offs[-1]))
    if device != "cpu":
        torch.cuda.synchronize()
    return paths.cpu().numpy(), tail.cpu().numpy()


def launch_times(torch, st, p, b, padlen, reps):
    """(production ms, resident ms, host paths, host tail) of one batch
    on the card: production is H2D + kernel + D2H as the batcher issues
    them, resident the kernel alone on inputs already on the card."""
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.ops.device_kernel import out_views
    mat = _matrix(torch, p, "cuda")
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

    prod = timed(torch, production, reps)
    res = timed(torch, kernel_only, reps)
    production()
    torch.cuda.synchronize()
    paths, tail = out_views(host_out, b, padlen)
    return prod, res, paths.numpy().copy(), tail.numpy().copy()


def host_check(job):
    """Host reference of one launched pair (runs in a worker): the NumPy
    oracle, or the native host kernel when job["native"]; and the plain
    version on CPU tensors at the launch's padlen unless job["plain"] is
    false. Returns (path, error, plain path or None, plain tail or None)."""
    from twilight_tpu_torch.config import Params
    from twilight_tpu_torch.constants import letter_lut
    from twilight_tpu_torch.ops import talco_host, talco_np
    p, leaf, marker, task = job["p"], job["leaf"], job["marker"], job["task"]
    prep, meta = job["prep"], job["meta"]
    param = Params.make("n" if p == 6 else "p")
    rl, ql = prep[4]
    if leaf:
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
        # the packer's rule (device_kernel.pack_batch)
        gap_char = (0.0 if task in (1, 2) or meta[2] > 10000
                    or meta[3] > 10000 else GE)
    tp = talco_np.TalcoRunParams(
        param.scoring_matrix, GO, GE, gap_char, job["xdrop"],
        flen=job["flen"], marker=marker)
    engine = (talco_host.align_freq if job.get("native")
              else talco_np.align_freq)
    gold, gerr = engine(tp, fr, fq, go, ge, (meta[2], meta[3]))
    if not job.get("plain", True):
        return gold, int(gerr), None, None
    import torch
    torch.set_num_threads(1)
    st = pack([0], [prep], [meta], task, p, leaf, param, [job["flen"]],
              [job["xdrop"]], marker, padlen=job.get("padlen", 2048))
    paths, tail = launch(torch, st, p, marker, "cpu")
    n = int(tail[0, 0])
    return gold, int(gerr), paths[0, :n].copy(), tail[0]


def host_refs(pool, jobs):
    """host_check over the jobs, on the process pool (None: in this
    process): the plain-version ones (slowest) first, each kind the
    largest first, so that no long job starts last."""
    def cost(j):
        rl, ql = jobs[j]["prep"][4]
        return not jobs[j]["plain"], -rl * ql
    order = sorted(range(len(jobs)), key=cost)
    todo = [jobs[j] for j in order]
    done = (map(host_check, todo) if pool is None
            else pool.map(host_check, todo, chunksize=1))
    out = [None] * len(jobs)
    for j, r in zip(order, done):
        out[j] = r
    return out


def hold(kern, refs, label):
    """Holds each kernel result (path, tail, key) to its host reference:
    the error code and the path, and, where the plain version ran, the
    whole tail and the path. Prints each mismatch with its key. Returns
    (mismatches, max |kernel - ref|, error counts, pairs held to the plain
    version)."""
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


def bound_ms(ops, nbytes):
    """(least ms the H100 could take, what bounds it): the larger of the
    f32 operations over the f32 peak and the bytes over the memory rate
    (each input read once, each output written once)."""
    t_ops, t_bytes = ops / F32_PEAK, nbytes / HBM_PEAK
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def talco_bound(res, name, b, padlen):
    """Adds the per-pair bound and roofline share of one timed launch to
    its result: dp_cells x OPS_PER_CELL[name] operations, the staging
    buffer in and paths + tails out."""
    ops = res["dp_cells"] * OPS_PER_CELL[name] / b
    nbytes = (res["h2d_bytes"] + b * 2 * padlen + b * 16) / b
    res["bound_ms_per_pair"], res["bound_by"] = bound_ms(ops, nbytes)
    res["roofline_share"] = (res["bound_ms_per_pair"]
                             / res["ms_per_pair_resident"])


def timed(torch, fn, reps):
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


def gate_round_trip(torch) -> dict:
    """One launch round trip through the batcher, the figure behind the
    level gate (pipeline/aligner.py LAUNCH_ROUND_TRIP_S): pack GATE_PAIRS
    nt freq pairs of GATE_COLS columns into pinned staging, H2D, the
    kernel, D2H, and the wait on the launch's event; the median of
    GATE_REPS after a warm-up, by the host clock (what a level pays)."""
    from twilight_tpu_torch.config import Options, Params
    from twilight_tpu_torch.ops import device_kernel as dk
    rng = np.random.default_rng(9)
    param = Params.make("n")
    prepared, metas = zip(*[make_pair(rng, 6, False, GATE_COLS)
                            for _ in range(GATE_PAIRS)])
    batcher = dk.DeviceTalco(Options(device_backend="cuda", type="n"),
                             param, "cuda")
    chunk = list(range(GATE_PAIRS))
    walls = []
    try:
        for _ in range(GATE_REPS + 1):
            flen, xdrop = [4096] * GATE_PAIRS, [5000] * GATE_PAIRS
            t0 = time.perf_counter()
            ln = batcher._launch(chunk, dk.SHORT_PADLEN, prepared, metas, 0,
                                 False, flen, xdrop)
            ln.wait()
            walls.append(time.perf_counter() - t0)
            tail = dk.out_views(ln.host_out, GATE_PAIRS, dk.SHORT_PADLEN)[1]
            if not (tail.numpy()[:, 1] == 0).all():
                raise RuntimeError("gate: kernel errors")
    finally:
        batcher.close()
    return {"pairs": GATE_PAIRS, "columns": GATE_COLS,
            "round_trip_ms": float(np.median(walls[1:])) * 1e3,
            "min_ms": min(walls[1:]) * 1e3, "max_ms": max(walls[1:]) * 1e3,
            "reps": GATE_REPS}


DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_device_ms(path: str) -> dict:
    """Device time in a torch.profiler chrome trace (the CLI's
    --profile-trace DIR writes DIR/trace.json), ms: the TALCO kernel's
    launches (`talco_ms`, over `talco_kernels` events), every kernel
    (`kernel_ms`), the copies and memsets (`copy_ms`), and `busy_ms`, the
    union of all their intervals: the time the card ran anything."""
    import json
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev = [e for e in events if e.get("cat") in DEVICE_EVENTS and "dur" in e]
    talco = [e for e in dev if e["cat"] == "kernel"
             and "talco_xdrop" in e.get("name", "")]
    busy, end = 0.0, None
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        if end is None or a >= end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return {"talco_ms": sum(e["dur"] for e in talco) / 1e3,
            "talco_kernels": len(talco),
            "kernel_ms": sum(e["dur"] for e in dev
                             if e["cat"] == "kernel") / 1e3,
            "copy_ms": sum(e["dur"] for e in dev
                           if e["cat"] != "kernel") / 1e3,
            "busy_ms": busy / 1e3}
