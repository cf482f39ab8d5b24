"""Pre/post alignment column math.

Host-side helpers around the DP kernel: profile accumulation, gappy-column
removal/splice-back, position-specific gap penalties, consensus, profile
merge, and alignment application. Reference semantics from
TWILIGHT src/alignment-helper.cpp (cited per function); float32
operation order preserved where it affects output bytes.
"""
from __future__ import annotations

import ctypes
from itertools import chain
from operator import attrgetter
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import native
from ..constants import letter_lut, profile_size
from ..core.seqdb import SequenceDB, GAP

F32 = np.float32
F64 = np.float64

CAL_PROFILE_TH = 1000
UPDATE_SEQ_TH = 1000

_CONSENSUS_NUC = np.frombuffer(b"ACGTN", dtype=np.uint8)
_CONSENSUS_AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX", dtype=np.uint8)


_LUT8 = {}


def _lut8(lut: np.ndarray) -> np.ndarray:
    key = id(lut)
    if key not in _LUT8:
        _LUT8[key] = np.ascontiguousarray(lut, dtype=np.uint8)
    return _LUT8[key]


def _accumulate_seqs(profile: np.ndarray, node, database: SequenceDB,
                     lut: np.ndarray, length: int, node_weight: float,
                     node_num: int) -> None:
    """Sequential per-sequence accumulation; each column add is
    float = f32(double(acc) + double(w)) like the reference's
    `profile[...] += 1.0 * w` (alignment-helper.cpp:23-34). The hot loop
    runs in native code (hostops.accumulate_profile, same op order) when
    the toolchain is available."""
    lib = _get_hostops()
    idxs = node.seqs_included
    if (lib and hasattr(lib, "accumulate_profile") and idxs
            and all(s >= 0 for s in idxs)):
        n = len(idxs)
        ptrs = np.empty(n, dtype=np.uint64)
        ws = np.empty(n, dtype=np.float32)
        for j, s_idx in enumerate(idxs):
            seq = database.sequences[s_idx]
            ptrs[j] = seq.aln.ctypes.data
            ws[j] = F32(F32(seq.weight) / F32(node_weight)) * F32(node_num)
        lib.accumulate_profile(
            ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p)),
            ws.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, _lut8(lut).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            length, profile.shape[1],
            profile.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return
    cols = np.arange(length)
    for s_idx in idxs:
        seq = database.sequences[s_idx]
        w = F32(F32(seq.weight) / F32(node_weight)) * F32(node_num)
        letters = lut[seq.aln[:length]]
        vals = profile[cols, letters].astype(F64) + F64(w)
        profile[cols, letters] = vals.astype(F32)


def calculate_profile(nodes, database: SequenceDB, type_: str
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Weighted letter-frequency profiles for a node pair
    (reference alignment-helper.cpp:8-72). Returns (freq_ref, freq_qry),
    each [len, profileSize] f32, and caches node.msa_freq when large."""
    psize = profile_size(type_)
    lut = letter_lut(type_)
    ref, qry = nodes
    ref_num, qry_num = ref.aln_num, qry.aln_num
    ref_len, qry_len = ref.aln_len, qry.aln_len
    ref_w, qry_w = ref.aln_weight, qry.aln_weight
    store = (ref_num >= CAL_PROFILE_TH or qry_num >= CAL_PROFILE_TH
             or _has_freq(ref) or _has_freq(qry))

    def one_side(node, num, length, weight) -> np.ndarray:
        if _has_freq(node):
            return (node.msa_freq / F32(weight)) * F32(num)
        prof = np.zeros((length, psize), dtype=np.float32)
        _accumulate_seqs(prof, node, database, lut, length, weight, num)
        if store:
            node.msa_freq = (prof / F32(num)) * F32(weight)
        return prof

    return one_side(ref, ref_num, ref_len, ref_w), \
        one_side(qry, qry_num, qry_len, qry_w)


def _has_freq(node) -> bool:
    return node.msa_freq is not None and len(node.msa_freq) > 0


def _gappy_runs(gap_col: np.ndarray, num: int, threshold: float,
                length: int) -> List[Tuple[int, int]]:
    """Run-length encode the over-threshold columns (vectorized; the float
    comparison is identical to the reference's per-column test,
    alignment-helper.cpp:84)."""
    flags = (gap_col[:length] / F32(num)) > F32(threshold)
    edges = np.flatnonzero(np.diff(np.concatenate(
        (np.zeros(1, np.int8), flags.astype(np.int8), np.zeros(1, np.int8)))))
    starts, ends = edges[0::2], edges[1::2]
    return list(zip(starts.tolist(), (ends - starts).tolist()))


def remove_gappy_columns(freq_ref: np.ndarray, freq_qry: np.ndarray,
                         nodes, type_: str, threshold: float,
                         current_task: int
                         ) -> Tuple[np.ndarray, np.ndarray,
                                    Tuple[List[Tuple[int, int]],
                                          List[Tuple[int, int]]],
                                    Tuple[int, int]]:
    """Strip columns whose gap fraction exceeds the threshold
    (reference alignment-helper.cpp:74-166). Returns compacted profiles,
    the removed runs per side, and new lengths."""
    ref, qry = nodes
    ref_len, qry_len = ref.aln_len, qry.aln_len
    if threshold == 1.0:
        return freq_ref, freq_qry, ([], []), (ref_len, qry_len)
    psize = freq_ref.shape[1]
    runs_r = _gappy_runs(freq_ref[:, psize - 1], ref.aln_num, threshold, ref_len)
    runs_q = _gappy_runs(freq_qry[:, psize - 1], qry.aln_num, threshold, qry_len)

    def compact(freq, runs, length):
        if not runs:
            return freq, length
        keep = np.ones(length, dtype=bool)
        for s, ln in runs:
            keep[s:s + ln] = False
        kept = freq[:length][keep]
        return kept, kept.shape[0]

    new_ref, new_rlen = compact(freq_ref, runs_r, ref_len)
    new_qry, new_qlen = compact(freq_qry, runs_q, qry_len)
    return new_ref, new_qry, (runs_r, runs_q), (new_rlen, new_qlen)


def calculate_psgp(freq_ref: np.ndarray, freq_qry: np.ndarray, nodes,
                   type_: str, lens: Tuple[int, int], param
                   ) -> Tuple[Tuple[np.ndarray, np.ndarray],
                              Tuple[np.ndarray, np.ndarray]]:
    """ClustalW position-specific gap open/extend
    (reference alignment-helper.cpp:168-219). Returns ((gapOpRef, gapOpQry),
    (gapExRef, gapExQry)), f32 arrays over the compacted profiles."""
    ref, qry = nodes
    psize = freq_ref.shape[1]
    scale = F32(0.5) if type_ == "n" else F32(1.0)
    go = F32(param.gap_open)
    ge = F32(param.gap_extend)
    min_ge = F32(F64(ge) * 0.2)
    min_go = F32(F64(go) * 0.1)

    def one_side(freq, num, length):
        gap_ratio = freq[:length, psize - 1]
        # f32(gapOpen*scale) * ((num - gapRatio)*1.0/num) in double, cast f32
        a = go * scale
        # (num - gapRatio) rounds in f32 first, then double-divides
        frac = (F32(num) - gap_ratio).astype(F64) * 1.0 / F64(num)
        op_scaled = (F64(a) * frac).astype(F32)
        ex_scaled = (F64(ge) * frac).astype(F32)
        op = np.where(gap_ratio > 0, np.minimum(min_go, op_scaled), go)
        ex = np.where(gap_ratio > 0, np.minimum(min_ge, ex_scaled), ge)
        return op.astype(F32), ex.astype(F32)

    op_r, ex_r = one_side(freq_ref, ref.aln_num, lens[0])
    op_q, ex_q = one_side(freq_qry, qry.aln_num, lens[1])
    return (op_r, op_q), (ex_r, ex_q)


def get_consensus(freq: np.ndarray, type_: str, length: int) -> np.ndarray:
    """Argmax letter per column, ambiguity letter when all non-gap counts
    are <= 0 (reference alignment-helper.cpp:221-241). Returns uint8 bytes."""
    psize = freq.shape[1]
    lut = _CONSENSUS_NUC if type_ == "n" else _CONSENSUS_AA
    counts = freq[:length, :psize - 2]
    # first strict max scanning left to right == np.argmax's first-max rule
    best = np.argmax(counts, axis=1)
    mx = counts[np.arange(length), best]
    idx = np.where(mx > 0, best, psize - 2)
    return lut[idx]


class _PrepIn(ctypes.Structure):
    """hostops.cpp's PrepIn: a level's sides and their members."""
    _fields_ = [("npairs", ctypes.c_int64), ("psize", ctypes.c_int64),
                *((n, ctypes.c_void_p) for n in (
                    "lut", "letters", "len", "rows", "num", "weight", "freq",
                    "mem_off", "mem_rows", "mem_w")),
                ("gappy", ctypes.c_int32), ("threshold", ctypes.c_float),
                ("gap_open", ctypes.c_float), ("gap_extend", ctypes.c_float),
                ("scale", ctypes.c_float)]


class _PrepOut(ctypes.Structure):
    """hostops.cpp's PrepOut: where each side's outputs go."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "n_runs", "kept", "prof", "cons", "op", "ex", "runs", "store")]


def native_prep_ok(pair, psize: int) -> bool:
    """Whether prepare_level_native can prep `pair`: hostops has it, and
    each side has a cached f32 profile of at least aln_len rows, or
    members whose ids are all 0 or more."""
    lib = _get_hostops()
    if not (lib and hasattr(lib, "prep_level_fill")):
        return False
    for node in pair:
        if _has_freq(node):
            f = node.msa_freq
            if not (isinstance(f, np.ndarray) and f.dtype == F32
                    and f.ndim == 2 and f.shape[1] == psize
                    and f.flags.c_contiguous and len(f) >= node.aln_len):
                return False
        elif node.seqs_included and min(node.seqs_included) < 0:
            return False
    return True


def _data_pointers(arrays: list) -> np.ndarray:
    """The data pointers of `arrays` (NumPy arrays) as uint64."""
    return np.fromiter((a.ctypes.data for a in arrays), np.uint64,
                       len(arrays))


def _offsets(counts: np.ndarray) -> np.ndarray:
    """Exclusive cumsum of counts, with the total last."""
    off = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=off[1:])
    return off


def prepare_level_native(pairs, database: SequenceDB, type_: str,
                         threshold: float, param, nthreads: int) -> list:
    """calculate_profile, get_consensus, remove_gappy_columns and
    calculate_psgp of every pair (each passing native_prep_ok), in two
    native calls with the GIL released, on nthreads threads. Returns the
    7-tuples of aligner._prepare_pair, byte for byte, and sets
    node.msa_freq where calculate_profile stores it.

    The first call finds each side's gappy runs from its gap column
    alone, so that every output is allocated at its compacted size; the
    second builds each full profile in its thread's scratch and writes
    the outputs."""
    lib = _get_hostops()
    psize = profile_size(type_)
    n = len(pairs)
    nodes = [node for pair in pairs for node in pair]
    cached = [_has_freq(node) for node in nodes]
    length = np.fromiter((nd.aln_len for nd in nodes), np.int64, 2 * n)
    num = np.fromiter((nd.aln_num for nd in nodes), np.int64, 2 * n)
    weight = np.fromiter((nd.aln_weight for nd in nodes), F32, 2 * n)
    rows = length.copy()
    freq = np.zeros(2 * n, dtype=np.uint64)
    for s in np.flatnonzero(cached).tolist():
        rows[s] = len(nodes[s].msa_freq)
        freq[s] = nodes[s].msa_freq.ctypes.data
    # every member of every side in one pass: row addresses and weights
    members = [() if c else nd.seqs_included
               for nd, c in zip(nodes, cached)]
    mem_off = _offsets(np.fromiter(map(len, members), np.int64, 2 * n))
    infos = list(map(database.sequences.__getitem__,
                     chain.from_iterable(members)))
    alns = list(map(attrgetter("aln"), infos))
    mem_rows = _data_pointers(alns)
    mem_w = np.fromiter(map(attrgetter("weight"), infos), F32, len(infos))
    lut = _lut8(letter_lut(type_))
    letters = _CONSENSUS_NUC if type_ == "n" else _CONSENSUS_AA
    gappy = threshold != 1.0
    pin = _PrepIn(
        n, psize, lut.ctypes.data, letters.ctypes.data, length.ctypes.data,
        rows.ctypes.data, num.ctypes.data, weight.ctypes.data,
        freq.ctypes.data, mem_off.ctypes.data, mem_rows.ctypes.data,
        mem_w.ctypes.data, int(gappy), threshold, param.gap_open,
        param.gap_extend, 0.5 if type_ == "n" else 1.0)

    n_runs = np.zeros(2 * n, dtype=np.int64)
    kept = length.copy()
    if gappy:
        lib.prep_level_scan(ctypes.byref(pin), n_runs.ctypes.data,
                            kept.ctypes.data, nthreads)
    # one array an output, as the Python path makes them (small ones come
    # from the heap's free lists, not from fresh pages)
    kl = kept.tolist()
    profs = [np.empty((r, psize), dtype=F32)
             for r in np.where(n_runs > 0, kept, rows).tolist()]
    conss = [np.empty(ln, dtype=np.uint8) for ln in length.tolist()]
    ops = [np.empty(k, dtype=F32) for k in kl]
    exs = [np.empty(k, dtype=F32) for k in kl]
    runs_off = _offsets(n_runs)
    runs = np.empty((runs_off[-1], 2), dtype=np.int64)
    store = np.zeros(2 * n, dtype=np.uint64)
    stored = {}
    for i, (ref, qry) in enumerate(pairs):
        if (ref.aln_num >= CAL_PROFILE_TH or qry.aln_num >= CAL_PROFILE_TH
                or cached[2 * i] or cached[2 * i + 1]):
            for s in (2 * i, 2 * i + 1):
                if not cached[s]:
                    stored[s] = np.empty((length[s], psize), dtype=F32)
                    store[s] = stored[s].ctypes.data
    where = [n_runs, kept, *(_data_pointers(x)
                             for x in (profs, conss, ops, exs)),
             np.uint64(runs.ctypes.data)
             + runs_off[:-1].astype(np.uint64) * np.uint64(16), store]
    pout = _PrepOut(*(a.ctypes.data for a in where))
    bad = lib.prep_level_fill(ctypes.byref(pin), ctypes.byref(pout),
                              nthreads)
    if bad:
        raise RuntimeError(f"level prep: {bad} sides' gappy runs differ "
                           "between the scan and the fill")
    for s, arr in stored.items():
        nodes[s].msa_freq = arr

    every_run = list(zip(runs[:, 0].tolist(), runs[:, 1].tolist()))
    ro = runs_off.tolist()
    gappy_runs = [every_run[ro[s]:ro[s + 1]] for s in range(2 * n)]
    return [(profs[r], profs[r + 1], (conss[r], conss[r + 1]),
             (gappy_runs[r], gappy_runs[r + 1]), (kl[r], kl[r + 1]),
             (ops[r], ops[r + 1]), (exs[r], exs[r + 1]))
            for r in range(0, 2 * n, 2)]


_hostops = None


def _get_hostops():
    global _hostops
    if _hostops is None:
        lib = native.load("hostops")
        if lib is not None:
            lib.pairwise_global.restype = ctypes.c_int64
            lib.pairwise_global.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                ctypes.c_float, ctypes.c_float,
                ctypes.POINTER(ctypes.c_int8)]
            if hasattr(lib, "accumulate_profile"):
                lib.accumulate_profile.restype = None
                lib.accumulate_profile.argtypes = [
                    ctypes.POINTER(ctypes.c_void_p),
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                    ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
            if hasattr(lib, "apply_path_rows"):
                lib.apply_path_rows.restype = None
                lib.apply_path_rows.argtypes = [
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_void_p),
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                    ctypes.c_uint8]
            if hasattr(lib, "prep_level_fill"):
                lib.prep_level_scan.restype = None
                lib.prep_level_scan.argtypes = [
                    ctypes.POINTER(_PrepIn), ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int64]
                lib.prep_level_fill.restype = ctypes.c_int64
                lib.prep_level_fill.argtypes = [
                    ctypes.POINTER(_PrepIn), ctypes.POINTER(_PrepOut),
                    ctypes.c_int64]
        _hostops = lib if lib is not None else False
    return _hostops


def pairwise_global(seq1: np.ndarray, seq2: np.ndarray, type_: str,
                    param) -> np.ndarray:
    """Affine global alignment of two consensus byte strings with free end
    gaps (reference alignment-helper.cpp:243-322). Returns int8 path."""
    lut = letter_lut(type_)
    idx1 = lut[seq1].astype(np.int32)
    idx2 = lut[seq2].astype(np.int32)
    lib = _get_hostops()
    if lib:
        m, n = len(idx1), len(idx2)
        out = np.zeros(m + n, dtype=np.int8)
        mat = np.ascontiguousarray(param.scoring_matrix, dtype=np.float32)
        ln = lib.pairwise_global(
            idx1.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), m,
            idx2.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
            mat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            param.matrix_size,
            ctypes.c_float(param.gap_open), ctypes.c_float(param.gap_extend),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
        return out[:ln]
    return _pairwise_global_py(idx1, idx2, param)


def _pairwise_global_py(idx1: np.ndarray, idx2: np.ndarray, param) -> np.ndarray:
    """Pure-python fallback (float32 per-op, slow)."""
    m, n = len(idx1), len(idx2)
    NEG = F32(-1e9)
    go, ge = F32(param.gap_open), F32(param.gap_extend)
    mat = param.scoring_matrix
    M = np.zeros((m + 1, n + 1), dtype=F32)
    X = np.zeros((m + 1, n + 1), dtype=F32)
    Y = np.zeros((m + 1, n + 1), dtype=F32)
    tb = np.zeros((m + 1, n + 1), dtype=np.int8)
    X[1:, 0] = 0.0
    Y[1:, 0] = NEG
    tb[1:, 0] = 2
    Y[0, 1:] = 0.0
    X[0, 1:] = NEG
    tb[0, 1:] = 1
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            base = mat[idx1[i - 1], idx2[j - 1]]
            mm = base + max(M[i-1, j-1], X[i-1, j-1], Y[i-1, j-1])
            xx = max(M[i-1, j] + go, X[i-1, j] + ge)
            yy = max(M[i, j-1] + go, Y[i, j-1] + ge)
            M[i, j], X[i, j], Y[i, j] = mm, xx, yy
            best = max(mm, xx, yy)
            tb[i, j] = 0 if best == mm else (1 if best == yy else 2)
    out = []
    i, j = m, n
    while i > 0 or j > 0:
        d = tb[i, j]
        out.append(d)
        if d == 0:
            i -= 1
            j -= 1
        elif d == 1:
            j -= 1
        else:
            i -= 1
    return np.asarray(out[::-1], dtype=np.int8)


def add_gappy_columns_back(aln_before: np.ndarray,
                           gappy: Tuple[List[Tuple[int, int]],
                                        List[Tuple[int, int]]],
                           param, type_: str,
                           consensus: Tuple[np.ndarray, np.ndarray]
                           ) -> np.ndarray:
    """Splice removed gappy runs back into the path
    (reference alignment-helper.cpp:324-375).

    The reference walks the path once, inserting each run where the
    consumed-column count reaches the run start (counts in ORIGINAL
    profile coordinates, which include previously re-inserted runs).
    Equivalent vectorized form: exclusive cumsums of consumed compacted
    columns locate each run's insertion index via searchsorted (run
    starts shifted by the prior runs' lengths); runs from both sides
    landing at the same index are the reference's simultaneous-gappy
    case and merge through pairwiseGlobal."""
    runs_r, runs_q = gappy
    if not runs_r and not runs_q:
        return aln_before
    cons_r, cons_q = consensus
    aln = np.ascontiguousarray(aln_before, dtype=np.int8)
    n = len(aln)
    pr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(aln != 1, out=pr[1:])
    pq = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(aln != 2, out=pq[1:])

    # batched insertion points (deferral-heavy configs have hundreds of
    # runs per pair — per-run searchsorted/np.full calls dominated the
    # deferred pass): one vector searchsorted per side, dict semantics
    # identical to the per-run loop (incl. same-t overwrite order)
    events: Dict[int, Dict[str, Tuple[int, int]]] = {}
    if runs_r:
        arr = np.asarray(runs_r, dtype=np.int64)
        shifts = np.zeros(len(arr), dtype=np.int64)
        np.cumsum(arr[:-1, 1], out=shifts[1:])
        for t, s, ln in zip(np.searchsorted(pr, arr[:, 0] - shifts,
                                            side="left").tolist(),
                            arr[:, 0].tolist(), arr[:, 1].tolist()):
            events.setdefault(t, {})["r"] = (s, ln)
    if runs_q:
        arr = np.asarray(runs_q, dtype=np.int64)
        shifts = np.zeros(len(arr), dtype=np.int64)
        np.cumsum(arr[:-1, 1], out=shifts[1:])
        for t, s, ln in zip(np.searchsorted(pq, arr[:, 0] - shifts,
                                            side="left").tolist(),
                            arr[:, 0].tolist(), arr[:, 1].tolist()):
            events.setdefault(t, {})["q"] = (s, ln)

    # constant-code gap pieces come from two shared templates (views,
    # copied once by the final concatenate) instead of per-run np.full
    max_r = max((ln for _, ln in runs_r), default=0)
    max_q = max((ln for _, ln in runs_q), default=0)
    tmpl2 = np.full(max_r, 2, dtype=np.int8)
    tmpl1 = np.full(max_q, 1, dtype=np.int8)
    pieces: List[np.ndarray] = []
    prev = 0
    for t in sorted(events):
        pieces.append(aln[prev:t])
        prev = t
        ev = events[t]
        if "r" in ev and "q" in ev:
            (sr, lr), (sq, lq) = ev["r"], ev["q"]
            pieces.append(pairwise_global(cons_r[sr:sr + lr],
                                          cons_q[sq:sq + lq], type_, param))
        elif "r" in ev:
            pieces.append(tmpl2[:ev["r"][1]])
        else:
            pieces.append(tmpl1[:ev["q"][1]])
    pieces.append(aln[prev:])
    return np.concatenate(pieces)


def update_alignment(nodes, database: SequenceDB, aln: np.ndarray,
                     current_task: int) -> None:
    """Apply a pair path to all member sequences / collapsed sub-paths and
    merge the pair's bookkeeping (reference alignment-helper.cpp:377-503)."""
    ref, qry = nodes
    total_len = len(aln)
    keep_ref = aln != 1   # codes 0 and 2 consume a reference char
    keep_qry = aln != 2   # codes 0 and 1 consume a query char

    def apply_side(node, keep: np.ndarray):
        pos = np.nonzero(keep)[0]
        if len(pos) == total_len and node.aln_len == total_len:
            # identity: every output column consumes this side's char and
            # the side is already at the final length, so every row (and
            # collapsed sub-path) would be rewritten with its own
            # content. Common in the deferred pass, where most deferred
            # sequences fit the frozen profile without inserting columns
            # — skipping the copy leaves the bytes untouched.
            return
        real = [s for s in node.seqs_included
                if current_task != 2 and s >= 0]
        lib = _get_hostops()
        if len(real) > 2 and lib and hasattr(lib, "apply_path_rows"):
            # batch the char shuffle through native code: one contiguous
            # output block, per-seq rows become views into it
            src_map = np.full(total_len, -1, dtype=np.int64)
            src_map[pos] = np.arange(len(pos), dtype=np.int64)
            ptrs = np.empty(len(real), dtype=np.uint64)
            for j, s_idx in enumerate(real):
                ptrs[j] = database.sequences[s_idx].aln.ctypes.data
            out_block = np.empty((len(real), total_len), dtype=np.uint8)
            lib.apply_path_rows(
                src_map.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                total_len,
                ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p)),
                out_block.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                len(real), ctypes.c_uint8(GAP))
            for j, s_idx in enumerate(real):
                seq = database.sequences[s_idx]
                seq.aln = out_block[j]
                seq.len = total_len
            real_set = set(real)
        else:
            real_set = set()
        for s_idx in node.seqs_included:
            if s_idx in real_set:
                continue
            if current_task != 2 and s_idx >= 0:
                seq = database.sequences[s_idx]
                new = np.full(total_len, GAP, dtype=np.uint8)
                new[pos] = seq.aln[:len(pos)]
                seq.aln = new
                seq.len = total_len
            else:
                org = database.subtree_aln[s_idx]
                new = np.ones(total_len, dtype=np.int8)
                new[pos] = org[:len(pos)]
                database.subtree_aln[s_idx] = new

    apply_side(ref, keep_ref)
    apply_side(qry, keep_qry)
    ref.aln_num += qry.aln_num
    ref.aln_len = total_len
    # f32 accumulation: the reference's alnWeight is a float and its bits
    # feed the profile math (phylogeny.hpp:44, alignment-helper.cpp:475)
    ref.aln_weight = float(F32(F32(ref.aln_weight) + F32(qry.aln_weight)))
    ref.seqs_included.extend(qry.seqs_included)
    qry.seqs_included = []
    # lazy collapse behind a negative pseudo-id
    if (len(ref.seqs_included) > UPDATE_SEQ_TH and _has_freq(ref)
            and current_task != 2):
        seq_count = 0
        first_seq_id = 0
        for idx in ref.seqs_included:
            if idx > 1:
                if first_seq_id == 0:
                    first_seq_id = -idx
                seq_count += 1
        if seq_count >= UPDATE_SEQ_TH:
            database.subtree_aln[first_seq_id] = np.zeros(total_len, dtype=np.int8)
            new_included = [first_seq_id]
            for idx in ref.seqs_included:
                if idx >= 0:
                    database.sequences[idx].subtree_idx = first_seq_id
                else:
                    new_included.append(idx)
            ref.seqs_included = new_included


def update_frequency(nodes, aln: np.ndarray,
                     weights: Tuple[float, float]) -> None:
    """Merge cached profiles along the path (reference
    alignment-helper.cpp:506-539); gap row accrues the other side's weight."""
    ref, qry = nodes
    if not _has_freq(ref) or not _has_freq(qry):
        return
    psize = ref.msa_freq.shape[1]
    ref_w, qry_w = F32(weights[0]), F32(weights[1])
    n = len(aln)
    r_idx = np.cumsum(aln != 1) - 1
    q_idx = np.cumsum(aln != 2) - 1
    merged = np.zeros((n, psize), dtype=np.float32)
    is_m = aln == 0
    is_i = aln == 1
    is_d = aln == 2
    if np.any(is_m):
        merged[is_m] = ref.msa_freq[r_idx[is_m]] + qry.msa_freq[q_idx[is_m]]
    if np.any(is_i):
        rows = qry.msa_freq[q_idx[is_i]].copy()
        # float + 1.0*weight: double add, truncate to f32
        rows[:, psize - 1] = (rows[:, psize - 1].astype(F64)
                              + F64(1.0) * F64(ref_w)).astype(F32)
        merged[is_i] = rows
    if np.any(is_d):
        rows = ref.msa_freq[r_idx[is_d]].copy()
        rows[:, psize - 1] = (rows[:, psize - 1].astype(F64)
                              + F64(1.0) * F64(qry_w)).astype(F32)
        merged[is_d] = rows
    ref.msa_freq = merged
    qry.msa_freq = None
    ref.aln_len = n


def sort_fallback(bad: List) -> List:
    """Order the deferred-realign nodes like the reference: std::sort with
    (alnNum desc, alnLen desc). std::sort is unstable and the permutation
    of equal keys is libstdc++'s introsort order, so the sort runs through
    the native library's std::sort (hostops.sort_fallback_perm) to
    reproduce it bit-for-bit; the stable Python sort is only a fallback
    when no toolchain exists (equal-key order may then differ from the
    reference)."""
    lib = _get_hostops()
    if lib and hasattr(lib, "sort_fallback_perm"):
        n = len(bad)
        nums = np.asarray([b.aln_num for b in bad], dtype=np.int32)
        lens = np.asarray([b.aln_len for b in bad], dtype=np.int32)
        idx = np.zeros(n, dtype=np.int32)
        lib.sort_fallback_perm(
            nums.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
        return [bad[i] for i in idx]
    return sorted(bad, key=lambda b: (-b.aln_num, -b.aln_len))


def fallback_to_deferred(fallback_pairs: List[int], nodes_list,
                         database: SequenceDB, no_filter: bool) -> None:
    """Defer the smaller side of failed pairs; keep the bigger profile alive
    (reference alignment-helper.cpp:541-591)."""
    filtering = not no_filter
    fallback_pairs.sort()
    for n_idx in fallback_pairs:
        ref, qry = nodes_list[n_idx]
        ref_num, qry_num = ref.aln_num, qry.aln_num
        low_r = False if ref_num > 1 else \
            database.sequences[ref.seqs_included[0]].low_quality
        low_q = False if qry_num > 1 else \
            database.sequences[qry.seqs_included[0]].low_quality
        if (ref_num < qry_num) or low_r:
            if (not filtering) or (not low_r):
                database.fallback_nodes.append(qry)
                if low_r:
                    database.sequences[ref.seqs_included[0]].low_quality = False
            # swap ref and query node state
            ref.aln_len, qry.aln_len = qry.aln_len, ref.aln_len
            ref.aln_num, qry.aln_num = qry.aln_num, ref.aln_num
            ref.aln_weight, qry.aln_weight = qry.aln_weight, ref.aln_weight
            ref.seqs_included, qry.seqs_included = (qry.seqs_included,
                                                    ref.seqs_included)
            ref.msa_freq, qry.msa_freq = qry.msa_freq, ref.msa_freq
        else:
            if (not filtering) or (not low_q):
                database.fallback_nodes.append(qry)
                if low_q:
                    database.sequences[qry.seqs_included[0]].low_quality = False


def merge_insertions(database: SequenceDB, root) -> None:
    """PLACE_WO_TREE: union per-sequence insertion runs into global columns
    ('.'-filled), reference alignment-helper.cpp:593-690."""
    ref_len = len(database.subtree_aln[-1])

    # per-position max insertion length over all placed paths
    longest = np.zeros(ref_len + 1, dtype=np.int64)
    for s in range(len(database.sequences)):
        if s in database.subtree_aln and not database.sequences[s].low_quality:
            pos, lens = _path_insertion_runs(database.subtree_aln[s])
            np.maximum.at(longest, pos, lens)

    # output layout: [longest[0] insertion cols][ref col 0][longest[1]]...
    total_len = ref_len + int(longest.sum())
    block_start = np.zeros(ref_len + 1, dtype=np.int64)
    block_start[1:] = np.cumsum(longest[:-1] + 1)
    ref_aln = np.full(total_len, 3, dtype=np.int8)
    ref_col_pos = block_start[:ref_len] + longest[:ref_len]
    ref_aln[ref_col_pos] = 0

    # re-project every sequence onto the global columns: the t-th path
    # entry lands at its backbone block (exclusive count of non-insertion
    # entries before t), insertions left-aligned within the block
    for s_idx, seq in enumerate(database.sequences):
        if seq.low_quality:
            continue
        path = database.subtree_aln[s_idx]
        is1 = path == 1
        non1 = (~is1).astype(np.int64)
        ref_idx = np.cumsum(non1) - non1          # exclusive
        org = np.cumsum(path != 2) - (path != 2)  # exclusive
        pos = block_start[ref_idx] + longest[ref_idx]  # non-1 → ref col
        if is1.any():
            idx1 = np.flatnonzero(is1)
            brk = np.flatnonzero(np.diff(idx1) > 1) + 1
            run_first = idx1[np.concatenate(([0], brk))]
            run_lens = np.diff(np.concatenate((np.array([0]), brk,
                                               np.array([idx1.size]))))
            rank = idx1 - np.repeat(run_first, run_lens)
            pos[idx1] = block_start[ref_idx[idx1]] + rank
        new = np.full(total_len, ord("."), dtype=np.uint8)
        takes = path != 2
        new[pos[takes]] = seq.aln[org[takes]]
        new[pos[path == 2]] = GAP
        seq.aln = new
        seq.len = total_len
    database.subtree_aln[-1] = ref_aln
    root.aln_len = total_len


def _path_insertion_runs(path: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Runs of insertion entries ('1') in a path, keyed by the backbone
    position they precede (= count of non-insertion entries before the
    run). Returns (positions, lengths)."""
    is1 = path == 1
    idx = np.flatnonzero(is1)
    if idx.size == 0:
        return (np.zeros(0, dtype=np.int64),) * 2
    brk = np.flatnonzero(np.diff(idx) > 1) + 1
    starts = idx[np.concatenate(([0], brk))]
    ends = idx[np.concatenate((brk - 1, [idx.size - 1]))]
    nonone = np.cumsum(~is1)
    pos = np.where(starts > 0, nonone[np.maximum(starts - 1, 0)], 0)
    return pos.astype(np.int64), (ends - starts + 1).astype(np.int64)
