"""Batch pair aligner: per-level pipeline around the DP kernel.

Reference flow: TWILIGHT src/alignment-cpu.cpp:36-183 — per pair:
profile → consensus → gappy removal → PSGP → TALCO DP (retry ladder on
band/x-drop errors) → splice gappy columns back → merge profiles → apply
path. The DP itself is pluggable: the NumPy oracle (exact reference
semantics), the native host kernel, or the batched CUDA kernel
(ops/device_kernel.py); everything around it is host code.
"""
from __future__ import annotations

import os
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from .. import trace
from ..config import MERGE_MSA, PLACE_WO_TREE, Options, Params, host_pool_size
from ..constants import profile_size
from ..core.seqdb import SequenceDB
from ..ops import ladder, talco_host
from . import helpers

# Host DP seconds per profile column, measured once at startup on THIS
# machine (one ~512-col pair through the active host kernel). Drives the
# device-vs-host dispatch estimate — the analogue of the reference's
# "GPU only when pairs >= 3*cpuNum" rule (cuda/alignment-gpu.cu:12-16).
# Fallback 15e-6 is the round-1 hand-measured figure for one Zen core.
_host_s_per_col: Optional[float] = None
# With host work-stealing as the safety net (device_kernel.py), the device
# threshold only gates how small a level is worth a launch at all: a level
# goes to the card when its host-DP estimate exceeds GATE_ROUND_TRIPS
# launch round trips. LAUNCH_ROUND_TRIP_S is one round trip through the
# batcher (pack 8 nt pairs of 100 columns into pinned staging, H2D, the
# kernel, D2H, the wait on its event): chip_smoke.py's `gate` phase (the
# median of 50) with the kernel of shared-memory rows, producer warps and
# 256 consumer threads as a constant, on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit: 0.854 ms.
LAUNCH_ROUND_TRIP_S = 0.854e-3
GATE_ROUND_TRIPS = 4
_DEVICE_MIN_EST_S = GATE_ROUND_TRIPS * LAUNCH_ROUND_TRIP_S


def host_s_per_col(option: Options, param: Params) -> float:
    """Calibrated host-kernel cost per profile column (cached)."""
    global _host_s_per_col
    if _host_s_per_col is not None:
        return _host_s_per_col
    try:
        n = 1024
        psize = profile_size(option.type)
        rng = np.random.default_rng(0)
        letters = rng.integers(0, param.matrix_size - 1, size=(2, n))
        q = letters[0].copy()
        mut = rng.random(n) < 0.1
        q[mut] = letters[1][mut]
        fr = np.zeros((n, psize), dtype=np.float32)
        fq = np.zeros((n, psize), dtype=np.float32)
        fr[np.arange(n), letters[0]] = 1.0
        fq[np.arange(n), q] = 1.0
        go = (np.full(n, param.gap_open, np.float32),) * 2
        ge = (np.full(n, param.gap_extend, np.float32),) * 2
        t0 = time.time()
        with trace.span("level.dp_host"):
            ladder.run_talco_with_retries(fr, fq, go, ge, (1.0, 1.0),
                                          (n, n), param, False, 0, option)
        _host_s_per_col = min(max((time.time() - t0) / (2 * n), 1e-6),
                              5e-4)
    except Exception:
        _host_s_per_col = 15e-6
    if trace.on():
        print(f"  [profile] host DP calibration: "
              f"{_host_s_per_col * 1e6:.1f} us/col", file=sys.stderr)
    return _host_s_per_col


def _dump_path(name: str) -> str:
    """Where TW_DEBUG_DUMP_PAIR writes its files (the temp directory)."""
    return os.path.join(tempfile.gettempdir(), name)


def _prepare_pair(pair, database: SequenceDB, option: Options, param: Params):
    """Profile + consensus + gappy removal + PSGP for one pair."""
    ref, qry = pair
    has_r, has_q = helpers._has_freq(ref), helpers._has_freq(qry)
    freq_ref, freq_qry = helpers.calculate_profile(pair, database, option.type)
    dump = os.environ.get("TW_DEBUG_DUMP_PAIR")
    if dump and f"{ref.identifier}:{qry.identifier}" == dump:
        freq_ref[:ref.aln_len].tofile(_dump_path("od_full_ref.bin"))
        freq_qry[:qry.aln_len].tofile(_dump_path("od_full_qry.bin"))
        with open(_dump_path("od_hasfreq.txt"), "w") as f:
            f.write(f"{int(has_r)} {int(has_q)}\n")
        with open(_dump_path("od_rows.txt"), "w") as f:
            for s_idx in qry.seqs_included:
                if s_idx < 0:
                    f.write(f">NEG {s_idx}\n")
                    continue
                sq = database.sequences[s_idx]
                f.write(f">{sq.name}\n")
                f.write(bytes(sq.aln[:qry.aln_len]).decode("latin-1") + "\n")
    cons_r = helpers.get_consensus(freq_ref, option.type, ref.aln_len)
    cons_q = helpers.get_consensus(freq_qry, option.type, qry.aln_len)
    freq_ref, freq_qry, gappy, lens = helpers.remove_gappy_columns(
        freq_ref, freq_qry, pair, option.type, option.gappy_vertical,
        database.current_task)
    gap_op, gap_ex = helpers.calculate_psgp(
        freq_ref, freq_qry, pair, option.type, lens, param)
    return freq_ref, freq_qry, (cons_r, cons_q), gappy, lens, gap_op, gap_ex


def _low_quality_flags(pair, database: SequenceDB, option: Options):
    ref, qry = pair
    low_r = False if (option.aln_mode == MERGE_MSA or ref.aln_num > 1) else \
        database.sequences[ref.seqs_included[0]].low_quality
    low_q = False if (option.aln_mode == MERGE_MSA or qry.aln_num > 1) else \
        database.sequences[qry.seqs_included[0]].low_quality
    return low_r, low_q


def _precompute_host_paths(pairs, prepared, metas, database: SequenceDB,
                           option: Options, param: Params):
    """Run the host DP concurrently for every pair the post loop will need.

    The reference runs the whole per-pair pipeline under a TBB parallel_for
    (alignment-cpu.cpp:46); here only the DP itself is pooled — it dominates
    host time, its results are order-independent, and the native kernel
    (ctypes) releases the GIL, so threads scale on multi-core hosts while
    the mutating post phase stays sequential in pair order (parity).
    """
    task = database.current_task
    todo = []
    for n_idx, pair in enumerate(pairs):
        ref_len, qry_len, _, _ = metas[n_idx]
        if ref_len == 0 or qry_len == 0:
            continue
        low_r, low_q = _low_quality_flags(pair, database, option)
        if low_r or low_q:
            continue
        todo.append(n_idx)
    if len(todo) < 2:
        return {}

    def _one(i):
        return ladder.align_prepared(prepared[i], metas[i], task, param,
                                     option)

    results = {}
    with ThreadPoolExecutor(
            max_workers=min(host_pool_size(option), len(todo))) as ex:
        for i, res in zip(todo, ex.map(_one, todo)):
            results[i] = res
    return results


def _post_one(n_idx, pair, prep, meta, path, database: SequenceDB,
              option: Options, param: Params, task: int,
              fallback_pairs: List[int], recheck_none: bool) -> None:
    """Post-process one pair: gappy splice-back, profile merge, path
    application, fallback bookkeeping. Exactly the per-pair tail of the
    reference loop (alignment-cpu.cpp:131-175); must run in pair order
    (fallback append order feeds the deferred pass's unstable sort)."""
    ref, qry = pair
    ref_len, qry_len, ref_num, qry_num = meta
    consensus, gappy = prep[2], prep[3]

    aln_wo_gc: Optional[np.ndarray] = None
    if ref_len == 0:
        aln_wo_gc = np.ones(qry_len, dtype=np.int8)
    if qry_len == 0:
        aln_wo_gc = np.full(ref_len, 2, dtype=np.int8)

    low_r, low_q = _low_quality_flags(pair, database, option)

    if not low_r and not low_q:
        if aln_wo_gc is None:
            if path is None and recheck_none:
                # the host ladder is the authority on deferral: confirm a
                # device/steal failure before deferring the pair
                with trace.span("level.dp_host", mark=False):
                    path, needs_fallback = ladder.align_prepared(
                        prep, meta, task, param, option)
                if needs_fallback:
                    fallback_pairs.append(n_idx)
                    return
            elif path is None:
                fallback_pairs.append(n_idx)
                return
            aln_wo_gc = path

    if task == 0 and (ref_num == 1 or qry_num == 1):
        if low_r or low_q:
            fallback_pairs.append(n_idx)
            return

    if aln_wo_gc is not None and len(aln_wo_gc):
        aln_w_gc = helpers.add_gappy_columns_back(
            aln_wo_gc, gappy, param, option.type, consensus)
        if os.environ.get("TW_DEBUG_LENS"):
            h = 1469598103934665603
            for a in aln_w_gc.tolist():
                h = ((h ^ (a & 0xFFFFFFFFFFFFFFFF))
                     * 1099511628211) % (1 << 64)
            print(f"DBGPATH {ref.identifier} {qry.identifier} "
                  f"{len(aln_w_gc)} {h:016x}", file=sys.stderr)
        ref_weight, qry_weight = ref.aln_weight, qry.aln_weight
        if option.aln_mode != PLACE_WO_TREE:
            helpers.update_frequency(pair, aln_w_gc,
                                     (ref_weight, qry_weight))
            helpers.update_alignment(pair, database, aln_w_gc, task)
        else:
            database.subtree_aln[qry.seqs_included[0]] = aln_w_gc


def align_pairs(pairs: List, database: SequenceDB, option: Options,
                param: Params, kernel=None,
                fallback_out: Optional[List[int]] = None) -> None:
    """Align one level's batch of node pairs.

    `kernel`, when given, is the DP batcher (ops/device_kernel.py:
    prepared pairs -> list of (path | None), each result also handed to
    `on_final` as soon as it is final); failed entries fall back to the
    host retry ladder. When the level gate sends the level to the
    batcher, the call runs in a background thread and each pair's post
    phase runs (in pair order) as soon as its result is final —
    overlapping host post work with device compute, like the reference's
    per-pair TBB pipeline (alignment-cpu.cpp:46) but with the
    deterministic commit order the byte-parity bar requires.
    """
    with trace.span("level"):
        fallback_pairs = _align_level(pairs, database, option, param,
                                      kernel)
        trace.count("deferred", len(fallback_pairs))
        if fallback_out is not None:
            # cross-level scheduling: the caller materializes deferrals in
            # global (level, index) order after all rounds — recording
            # only keeps the reference's fallback-list order intact
            fallback_out.extend(fallback_pairs)
        elif fallback_pairs:
            helpers.fallback_to_deferred(fallback_pairs, pairs, database,
                                         option.no_filter)


def _align_level(pairs, database: SequenceDB, option: Options,
                 param: Params, kernel) -> List[int]:
    """Prep, the gate's route, DP and post of one level; the indices of
    the pairs deferred, in the reference's order."""
    fallback_pairs: List[int] = []
    metas = [(p[0].aln_len, p[1].aln_len, p[0].aln_num, p[1].aln_num)
             for p in pairs]
    with trace.span("level.prep") as prep:
        prepared = _prepare_level(pairs, metas, database, option, param)
    use_device = kernel is not None and _gate(prepared, option, param)
    trace.count("levels_card" if use_device else "levels_host")
    trace.count("pairs_card" if use_device else "pairs_host", len(pairs))
    if use_device:
        wait_ns, post_ns = _post_pipelined(pairs, prepared, metas, kernel,
                                           database, option, param,
                                           fallback_pairs)
        if trace.on():
            print(f"  [profile] {len(pairs)} pairs on the card: "
                  f"prep={prep.ns / 1e9:.2f}s wait={wait_ns / 1e9:.2f}s "
                  f"post={post_ns / 1e9:.2f}s", file=sys.stderr)
    else:
        dp_ns, post_ns = _post_host(pairs, prepared, metas, database,
                                    option, param, fallback_pairs)
        if trace.on():
            print(f"  [profile] {len(pairs)} pairs on the host: "
                  f"prep={prep.ns / 1e9:.2f}s dp={dp_ns / 1e9:.2f}s "
                  f"post={post_ns / 1e9:.2f}s", file=sys.stderr)
    return fallback_pairs


def _prepare_level(pairs, metas, database: SequenceDB, option: Options,
                   param: Params) -> list:
    """`_prepare_pair` of every pair, in pair order.

    The pairs that `helpers.native_prep_ok` accepts (a side with a cached
    profile, or with members whose ids are all 0 or more, on a host
    whose toolchain built hostops) go to `helpers.prepare_level_native`:
    the whole level in two native calls, the pairs spread over
    `host_pool_size(option)` C++ threads with the GIL released, largest
    pair first. The others run `_prepare_pair` in Python, one after
    another: without hostops, for a side with a negative member id, and
    for the whole level under TW_DEBUG_DUMP_PAIR. Both give the same
    bytes; the counters `pairs_prep_native` and `pairs_prep_py` say how
    many pairs took each path."""
    task = database.current_task
    dump = os.environ.get("TW_DEBUG_DUMP_PAIR")
    psize = profile_size(option.type)
    native = [] if dump else [i for i, pair in enumerate(pairs)
                              if helpers.native_prep_ok(pair, psize)]
    prepared = [None] * len(pairs)
    if native:
        preps = helpers.prepare_level_native(
            [pairs[i] for i in native], database, option.type,
            option.gappy_vertical, param, host_pool_size(option))
        for i, prep in zip(native, preps):
            prepared[i] = prep
    for n_idx, pair in enumerate(pairs):
        if prepared[n_idx] is None:
            prepared[n_idx] = _prepare_pair(pair, database, option, param)
    trace.count("pairs_prep_native", len(native))
    trace.count("pairs_prep_py", len(pairs) - len(native))
    if not dump:
        return prepared
    for n_idx, pair in enumerate(pairs):
        ref, qry = pair
        prep = prepared[n_idx]
        ref_len, qry_len, ref_num, qry_num = metas[n_idx]
        if f"{ref.identifier}:{qry.identifier}" == dump:
            freq_ref, freq_qry, cons, gappy, lens, gap_op, gap_ex = prep
            np.savez(os.environ.get("TW_DEBUG_DUMP_FILE",
                                    _dump_path("pair.npz")),
                     freq_ref=freq_ref[:lens[0]], freq_qry=freq_qry[:lens[1]],
                     gap_op_r=gap_op[0], gap_op_q=gap_op[1],
                     gap_ex_r=gap_ex[0], gap_ex_q=gap_ex[1],
                     ref_num=ref_num, qry_num=qry_num,
                     task=task, ref_len=ref_len, qry_len=qry_len,
                     cons_r=cons[0], cons_q=cons[1],
                     gappy_r=np.asarray(gappy[0], dtype=np.int64),
                     gappy_q=np.asarray(gappy[1], dtype=np.int64))
    return prepared


def _gate(prepared, option: Options, param: Params) -> bool:
    """The level gate: the batcher when the level's host-DP estimate
    reaches _DEVICE_MIN_EST_S (or without a host kernel, or under
    TWILIGHT_FORCE_DEVICE); else the host kernel."""
    est_host_s = sum(
        (prep[4][0] + prep[4][1]) * host_s_per_col(option, param)
        for prep in prepared) / host_pool_size(option)
    return (est_host_s >= _DEVICE_MIN_EST_S
            or not talco_host.available()
            or bool(os.environ.get("TWILIGHT_FORCE_DEVICE")))


def _post_pipelined(pairs, prepared, metas, kernel, database: SequenceDB,
                    option: Options, param: Params,
                    fallback_pairs: List[int]):
    """The batcher in a background thread; each pair's post phase in
    ORDER as soon as its result is final. (wait ns, post ns) of this
    thread, from its spans."""
    task = database.current_task
    n = len(pairs)
    final = [False] * n
    paths: List[Optional[np.ndarray]] = [None] * n
    cond = threading.Condition()
    kernel_err: List[BaseException] = []

    def on_final(i, path):
        with cond:
            if not final[i]:
                paths[i] = path
                final[i] = True
                cond.notify_all()

    def run_kernel():
        try:
            res = kernel(prepared, metas, database, option, param,
                         on_final=on_final)
            for i, r in enumerate(res):
                on_final(i, r)
        except BaseException as e:  # surface in main thread
            kernel_err.append(e)
        finally:
            with cond:
                for i in range(n):
                    final[i] = True
                cond.notify_all()

    th = threading.Thread(target=run_kernel)
    th.start()
    wait_ns = post_ns = 0
    for n_idx, pair in enumerate(pairs):
        with trace.span("level.wait", mark=False) as sp:
            with cond:
                while not final[n_idx] and not kernel_err:
                    cond.wait(0.5)
        wait_ns += sp.ns
        if kernel_err:
            break
        with trace.span("level.post", mark=False) as sp:
            _post_one(n_idx, pair, prepared[n_idx], metas[n_idx],
                      paths[n_idx], database, option, param, task,
                      fallback_pairs, recheck_none=True)
        post_ns += sp.ns
    with trace.span("level.wait", mark=False) as sp:
        th.join()
    wait_ns += sp.ns
    if kernel_err:
        raise kernel_err[0]
    return wait_ns, post_ns


def _post_host(pairs, prepared, metas, database: SequenceDB,
               option: Options, param: Params, fallback_pairs: List[int]):
    """The level on the host kernel: the DP pooled across pairs, then
    each pair's post phase in order. (DP ns, post ns), from the spans."""
    task = database.current_task
    host_paths = {}
    dp_ns = post_ns = 0
    if host_pool_size(option) > 1:
        with trace.span("level.dp_host") as sp:
            host_paths = _precompute_host_paths(pairs, prepared, metas,
                                                database, option, param)
        dp_ns = sp.ns
    for n_idx, pair in enumerate(pairs):
        path, recheck = None, True
        if n_idx in host_paths:
            path, needs_fallback = host_paths[n_idx]
            if needs_fallback:
                path = None
            recheck = False
        with trace.span("level.post", mark=False) as sp:
            _post_one(n_idx, pair, prepared[n_idx], metas[n_idx], path,
                      database, option, param, task, fallback_pairs,
                      recheck_none=recheck)
        post_ns += sp.ns
    return dp_ns, post_ns
