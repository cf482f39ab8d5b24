"""Batcher for the CUDA TALCO kernel: the port of
`twilight_tpu/ops/device_kernel.py` (`DeviceTalco`, `make_device_kernel`,
`select_devices`).

Per level it sorts the pairs by size and cuts them into launches by route:
short launches (every side within the 2048-column bucket, padlen 2048),
long launches (the route of the TPU's K4: padlen is the launch's longest
side rounded up to 256) and wide launches (pairs whose retry-ladder width
grew past 4096, the work of the TPU's K5). Each launch holds at most
--pair-batch pairs and stays within a byte budget for its pinned staging
and its device scratch. It packs each launch's pairs straight into one
pinned host buffer (the g8 compact layout, `talco_cuda` module doc), and
issues one H2D copy, the kernel and one D2H copy on its own CUDA stream,
with an event marking the result ready. While launches are in flight the
host steals pairs from the tail onto the native kernel (both produce the
same bits), and each result is handed to `on_final` as soon as it is
final. Errors 1/2 at task != 0 re-launch with the reference retry ladder;
errors 3/4, and 1/2 at task 0, give None (the host ladder decides). A pair
whose ladder width would exceed `MAX_WINDOW` gives None as well, as in the
JAX batcher, and is counted and announced. A failed launch raises.
"""
from __future__ import annotations

import os
import sys
import threading
from typing import List, Optional

import numpy as np
import torch

from twilight_tpu.config import Options, Params
from twilight_tpu.constants import letter_lut

from . import talco_cuda
from .talco_cuda import MARKER, MAX_WINDOW, TAIL, p8_of

MAX_ROUNDS = 30
SHORT_PADLEN = 2048          # the main path's bucket
PADLEN_ALIGN = 256           # a long launch's padlen is a multiple of this
STAGING_BUDGET = 64 << 20    # pinned ref + qry bytes of one launch
SCRATCH_BUDGET = 2 << 30     # device scratch bytes of one launch
_TAG = "[twilight-tpu-torch]"


def padlen_bucket(m: int) -> int:
    """Padded length of a pair whose longer side has m columns
    (twilight_tpu device_kernel.py:456-462)."""
    if m <= 2048:
        return 2048
    if m <= 32768:
        return 32768
    p = 1
    while p < m:
        p <<= 1
    return p


def launch_padlen(m: int) -> int:
    """Padded length of a launch whose longest side has m columns: the
    2048 bucket, or above it m rounded up to 256 (a CUDA launch takes
    padlen as an argument; the TPU's fixed buckets only bounded
    recompiles)."""
    if m <= SHORT_PADLEN:
        return SHORT_PADLEN
    return -(-m // PADLEN_ALIGN) * PADLEN_ALIGN


def split_launches(idxs, prepared, flen_param, rows: int, esz: int,
                   batch: int, *, marker: int = MARKER,
                   staging_budget: int = STAGING_BUDGET,
                   scratch_budget: int = SCRATCH_BUDGET):
    """Cuts a route's size-sorted pairs into launches of at most `batch`
    pairs whose ref + qry blocks ([B, rows, padlen] of `esz`-byte
    elements each) and scratch stay within the budgets; a pair over a
    budget on its own gets a launch of its own. Returns [(chunk, padlen)]."""
    out = []
    chunk, padlen, scratch = [], 0, 0
    for i in idxs:
        rl, ql = prepared[i][4]
        need = talco_cuda.pair_scratch_bytes(rl, ql, flen_param[i], marker)
        pad = max(padlen, launch_padlen(max(rl, ql)))
        if chunk and (len(chunk) == batch
                      or 2 * (len(chunk) + 1) * rows * pad * esz
                      > staging_budget
                      or scratch + need > scratch_budget):
            out.append((chunk, padlen))
            chunk, scratch = [], 0
            pad = launch_padlen(max(rl, ql))
        chunk.append(i)
        padlen = pad
        scratch += need
    if chunk:
        out.append((chunk, padlen))
    return out


def select_devices(n_avail: int, option: Options) -> List[int]:
    """--devices/--device-index rules of the reference GPU build
    (cuda/gpu-info.cu:14-61): the count is bounds-checked, an explicit
    index list must match it, and every index must exist. An invalid
    selection exits 1. Returns the selected device indices."""
    num, idx = option.device_num, option.device_index
    if num is None and idx is None:
        return list(range(n_avail))
    n = num if num is not None else n_avail
    if n < 0 or n > n_avail:
        print(f"ERROR: Invalid number of devices. Please request between "
              f"0 and {n_avail}.", file=sys.stderr)
        raise SystemExit(1)
    if idx is not None:
        if len(idx) != n:
            print("ERROR: the number of requested devices does not match "
                  "the number of specified device indexes.",
                  file=sys.stderr)
            raise SystemExit(1)
        for i in idx:
            if i >= n_avail or i < 0:
                print("ERROR: specified device index >= the number of "
                      "devices", file=sys.stderr)
                raise SystemExit(1)
        chosen = list(idx)
    else:
        chosen = list(range(n))
    if not chosen:
        raise RuntimeError("0 devices requested")
    print(f"Maximum available devices: {n_avail}. Using {len(chosen)} "
          f"devices.", file=sys.stderr)
    return chosen


class Staging:
    """One launch's inputs in one host buffer (pinned for a CUDA launch),
    so that the launch makes a single H2D copy: offs int64 [B+1], ints
    int32 [4, B], floats f32 [5, B], then the ref and qry blocks."""

    def __init__(self, batch: int, rows: int, padlen: int, dtype,
                 pin: bool):
        esz = torch.empty(0, dtype=dtype).element_size()
        sizes = [(batch + 1) * 8, 16 * batch, 20 * batch,
                 batch * rows * padlen * esz, batch * rows * padlen * esz]
        self._spec = []
        at = 0
        for s in sizes:
            self._spec.append((at, s))
            at += (s + 15) // 16 * 16
        self.shape = (batch, rows, padlen)
        self.dtype = dtype
        self.buf = torch.empty(at, dtype=torch.uint8, pin_memory=pin)
        (self.offs, self.ints, self.floats,
         self.ref, self.qry) = self.views(self.buf)

    def views(self, buf: torch.Tensor):
        b = self.shape[0]
        (o0, s0), (o1, s1), (o2, s2), (o3, s3), (o4, s4) = self._spec
        return (buf[o0:o0 + s0].view(torch.int64),
                buf[o1:o1 + s1].view(torch.int32).view(4, b),
                buf[o2:o2 + s2].view(torch.float32).view(5, b),
                buf[o3:o3 + s3].view(self.dtype).view(self.shape),
                buf[o4:o4 + s4].view(self.dtype).view(self.shape))


def pack_batch(chunk, prepared, metas, task: int, padlen: int, p: int,
               param: Params, flen_param, xdrop, *, marker: int = MARKER,
               pin: bool = False) -> Staging:
    """Freq route: profile rows 0..P-1 and the gap open/extend rows
    P8-2/P8-1, ref reversed and right-aligned at padlen, query
    left-aligned (DeviceTalco._pack_batch with off=0, tot=padlen)."""
    p8 = p8_of(p)
    st = Staging(len(chunk), p8, padlen, torch.float32, pin)
    ref, qry = st.ref.numpy(), st.qry.numpy()
    ints, floats = st.ints.numpy(), st.floats.numpy()
    ref.fill(0.0)
    qry.fill(0.0)
    go, ge = np.float32(param.gap_open), np.float32(param.gap_extend)
    for bi, i in enumerate(chunk):
        freq_ref, freq_qry, _, _, lens, gap_op, gap_ex = prepared[i]
        rl, ql = lens
        rnum, qnum = metas[i][2], metas[i][3]
        ref[bi, :p, padlen - rl:] = freq_ref[:rl][::-1].T
        qry[bi, :p, :ql] = freq_qry[:ql].T
        ref[bi, p8 - 2, padlen - rl:] = gap_op[0][::-1]
        ref[bi, p8 - 1, padlen - rl:] = gap_ex[0][::-1]
        qry[bi, p8 - 2, :ql] = gap_op[1]
        qry[bi, p8 - 1, :ql] = gap_ex[1]
        zero_gc = task in (1, 2) or rnum > 10000 or qnum > 10000
        ints[:, bi] = (rl, ql, flen_param[i], xdrop[i])
        floats[:, bi] = (np.float32(rnum), np.float32(qnum),
                         np.float32(0.0) if zero_gc else ge, go, ge)
    st.offs.numpy()[:] = talco_cuda.scratch_offsets(ints[0], ints[1],
                                                    ints[2], marker)
    return st


def pack_batch_leaf(chunk, prepared, metas, padlen: int, p: int,
                    param: Params, flen_param, xdrop, *,
                    marker: int = MARKER, pin: bool = False) -> Staging:
    """Leaf route: int8 letter codes of the raw sequences (the consensus
    of a one-hot unit-weight leaf profile), padded with the ambiguity
    code; scalar gap scores and gap_char = gap_extend
    (DeviceTalco._pack_batch_leaf with off=0, tot=padlen)."""
    type_ = "n" if p == 6 else "p"
    lut = letter_lut(type_).astype(np.int32)
    st = Staging(len(chunk), 1, padlen, torch.int8, pin)
    ref, qry = st.ref.numpy(), st.qry.numpy()
    ints, floats = st.ints.numpy(), st.floats.numpy()
    ref.fill(p - 2)          # ambiguity code: 4 (nt), 20 (protein)
    qry.fill(p - 2)
    go, ge = np.float32(param.gap_open), np.float32(param.gap_extend)
    for bi, i in enumerate(chunk):
        _, _, cons, _, lens, _, _ = prepared[i]
        rl, ql = lens
        ref[bi, 0, padlen - rl:] = lut[cons[0][:rl]].astype(np.int8)[::-1]
        qry[bi, 0, :ql] = lut[cons[1][:ql]].astype(np.int8)
        ints[:, bi] = (rl, ql, flen_param[i], xdrop[i])
        floats[:, bi] = (np.float32(1.0), np.float32(1.0), ge, go, ge)
    st.offs.numpy()[:] = talco_cuda.scratch_offsets(ints[0], ints[1],
                                                    ints[2], marker)
    return st


def is_leaf_pair(prep, meta, task: int, flen_param: int,
                 base_flen: int) -> bool:
    """Two raw sequences with no ladder state (device_kernel.py:482-488):
    they ship as letter codes."""
    return (flen_param == base_flen and task == 0
            and meta[2] == 1 and meta[3] == 1
            and not prep[3][0] and not prep[3][1])


def out_views(buf: torch.Tensor, batch: int, padlen: int):
    """(paths int8 [B, 2*padlen], tail int32 [B, 4]) inside one byte
    buffer, so a launch's results come back in one D2H copy."""
    n = batch * 2 * padlen
    return (buf[:n].view(torch.int8).view(batch, 2 * padlen),
            buf[n:n + batch * TAIL * 4].view(torch.int32).view(batch, TAIL))


class _Launch:
    __slots__ = ("chunk", "staging", "host_out", "event", "padlen")

    def __init__(self, chunk, staging, host_out, event, padlen):
        self.chunk = chunk
        self.staging = staging      # held until the H2D copy has completed
        self.host_out = host_out
        self.event = event
        self.padlen = padlen

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()   # releases the GIL


class DeviceTalco:
    """The kernel contract of pipeline/aligner.py:302-378 over the CUDA
    kernel (or, on a CPU device, its plain PyTorch version)."""

    supports_on_final = True

    def __init__(self, option: Options, param: Params, device):
        self.option = option
        self.param = param
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.p = 6 if option.type == "n" else 22
        self.base_flen = 1 << 12     # starting ladder width; wider is "wide"
        self.max_window = MAX_WINDOW
        self.marker = MARKER
        self.batch = max(1, option.pair_batch)
        self.matrix, _ = talco_cuda.device_params(param, self.device)
        self.stream = None
        if self.device.type == "cuda":
            from . import build
            build.load()     # a failed build raises before any level runs
            self.stream = torch.cuda.Stream(self.device)
        # launches counts kernel launches on the card; long_launches and
        # wide_launches count launches by route on either device, and
        # ladder_relaunches the pairs the retry ladder sent back to one
        self.stats = {"launches": 0, "pairs": 0, "zero_length": 0,
                      "pairs_on_device": 0, "host_stolen": 0,
                      "err3_fallbacks": 0, "task0_errors": 0,
                      "long_launches": 0, "wide_launches": 0,
                      "ladder_relaunches": 0, "host_wide": 0}

    def close(self) -> None:
        """Wait for the stream: no launch outlives the run."""
        if self.stream is not None:
            self.stream.synchronize()

    def summary(self) -> str:
        return (f"{_TAG} {self.device}: "
                + " ".join(f"{k}={v}" for k, v in self.stats.items()))

    def _launch(self, chunk, padlen, prepared, metas, task, leaf,
                flen_param, xdrop) -> _Launch:
        cuda = self.device.type == "cuda"
        if leaf:
            st = pack_batch_leaf(chunk, prepared, metas, padlen, self.p,
                                 self.param, flen_param, xdrop,
                                 marker=self.marker, pin=cuda)
        else:
            st = pack_batch(chunk, prepared, metas, task, padlen, self.p,
                            self.param, flen_param, xdrop,
                            marker=self.marker, pin=cuda)
        b = len(chunk)
        nbytes = b * 2 * padlen + b * TAIL * 4
        scratch = int(st.offs[-1])
        if not cuda:
            host = torch.empty(nbytes, dtype=torch.uint8)
            talco_cuda.talco_align(
                st.ints, st.floats, st.offs, st.ref, st.qry, self.matrix,
                p=self.p, marker=self.marker, scratch_bytes=scratch,
                out=out_views(host, b, padlen))
            return _Launch(chunk, st, host, None, padlen)
        with torch.cuda.stream(self.stream):
            dev = st.views(st.buf.to(self.device, non_blocking=True))
            obuf = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            offs, ints, floats, ref, qry = dev
            talco_cuda.talco_align(
                ints, floats, offs, ref, qry, self.matrix, p=self.p,
                marker=self.marker, scratch_bytes=scratch,
                out=out_views(obuf, b, padlen))
            host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            host.copy_(obuf, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.stats["launches"] += 1
        return _Launch(chunk, st, host, ev, padlen)

    def _host_align(self, prep, meta, task):
        """Reference retry ladder on the native host kernel (the same bits
        as the device path)."""
        from twilight_tpu.pipeline.aligner import _run_talco_with_retries
        freq_ref, freq_qry, _, _, lens, gap_op, gap_ex = prep
        rnum, qnum = meta[2], meta[3]
        gap_char_zero = task in (1, 2) or rnum > 10000 or qnum > 10000
        path, needs_fallback = _run_talco_with_retries(
            freq_ref[:lens[0]], freq_qry[:lens[1]], gap_op, gap_ex,
            (float(rnum), float(qnum)), lens, self.param, gap_char_zero,
            task, self.option)
        return path if not needs_fallback else None

    def _collect(self, launch, results, prepared, task, lock, claimed,
                 pending, flen_param, xdrop, note) -> None:
        launch.wait()
        b = len(launch.chunk)
        paths, tail = out_views(launch.host_out, b, launch.padlen)
        paths, tail = paths.numpy(), tail.numpy()
        for bi, i in enumerate(launch.chunk):
            with lock:
                if i in claimed:
                    continue         # the host stole it
                claimed.add(i)
            ln, e = int(tail[bi, 0]), int(tail[bi, 1])
            if e == 0:
                results[i] = paths[bi, :ln].copy()
                self.stats["pairs_on_device"] += 1
                note(i, results[i])
            elif e == talco_cuda.ERR_LAYOUT:
                raise RuntimeError("talco_xdrop: pair lengths or scratch "
                                   "layout do not match the batch "
                                   "(error 8)")
            elif task == 0 or e in (3, 4):
                # the device's answer is final: at task 0 the reference
                # defers the pair (the host ladder confirms it)
                self.stats["err3_fallbacks" if e in (3, 4)
                           else "task0_errors"] += 1
                results[i] = None
                note(i, None)
            else:
                lens = prepared[i][4]
                if e == 2:
                    flen_param[i] = min(int(flen_param[i] * 1.2) << 1,
                                        min(lens))
                elif e == 1:
                    xdrop[i] = int(xdrop[i] * 2)
                    flen_param[i] = min(int(xdrop[i] * 4) << 1, min(lens))
                pending.append(i)

    def __call__(self, prepared, metas, database, option, param,
                 on_final=None) -> List[Optional[np.ndarray]]:
        from twilight_tpu.pipeline.aligner import host_pool_size
        note = on_final or (lambda i, p: None)
        task = database.current_task
        n = len(prepared)
        results: List[Optional[np.ndarray]] = [None] * n
        flen_param = [self.base_flen] * n       # reference ladder state
        xdrop = [int(1000 * -1 * param.gap_extend)] * n

        pending: List[int] = []
        self.stats["pairs"] += n
        for i, prep in enumerate(prepared):
            lens = prep[4]
            if lens[0] <= 0 or lens[1] <= 0:
                self.stats["zero_length"] += 1
                note(i, None)   # zero-length side: post handles it
            else:
                pending.append(i)
        no_steal = bool(os.environ.get("TWILIGHT_NO_STEAL"))

        rounds = 0
        while pending and rounds < MAX_ROUNDS:
            rounds += 1
            buckets = {}
            too_wide = []
            for i in pending:
                lens = prepared[i][4]
                if min(flen_param[i], min(lens)) > self.max_window:
                    # the JAX batcher's cap (its device_kernel.py:464-468)
                    too_wide.append(i)
                    continue
                # after the first round, every pending pair is a ladder step
                self.stats["ladder_relaunches"] += rounds > 1
                long_ = padlen_bucket(max(lens)) > SHORT_PADLEN
                wide = flen_param[i] > self.base_flen
                leaf = is_leaf_pair(prepared[i], metas[i], task,
                                    flen_param[i], self.base_flen)
                buckets.setdefault((long_, wide, leaf), []).append(i)
            pending = []
            if too_wide:
                self.stats["host_wide"] += len(too_wide)
                print(f"{_TAG} {len(too_wide)} pairs need a ladder width "
                      f"above {self.max_window} columns: the host ladder "
                      "aligns them", file=sys.stderr)
                for i in too_wide:
                    results[i] = None
                    note(i, None)
            launches: List[_Launch] = []
            for (long_, wide, leaf), idxs in buckets.items():
                # size-sorted, so a launch's blocks carry similar work
                idxs.sort(key=lambda i: -(prepared[i][4][0]
                                          + prepared[i][4][1]))
                rows, esz = (1, 1) if leaf else (p8_of(self.p), 4)
                for chunk, padlen in split_launches(
                        idxs, prepared, flen_param, rows, esz, self.batch,
                        marker=self.marker):
                    launches.append(self._launch(
                        chunk, padlen, prepared, metas, task, leaf,
                        flen_param, xdrop))
                    self.stats["long_launches"] += int(long_)
                    self.stats["wide_launches"] += int(wide)

            # steal pairs from the tail onto the host kernel while the
            # launches run (TWILIGHT_NO_STEAL pins them to the device)
            lock = threading.Lock()
            claimed: set = set()
            steal_stack = ([] if no_steal else
                           [i for ln in launches for i in ln.chunk])

            def _claim():
                with lock:
                    while steal_stack:
                        cand = steal_stack.pop()
                        if cand not in claimed:
                            claimed.add(cand)
                            return cand
                return None

            def _steal_one(i):
                results[i] = self._host_align(prepared[i], metas[i], task)
                with lock:
                    self.stats["host_stolen"] += 1
                note(i, results[i])

            def _stealer():
                while (i := _claim()) is not None:
                    _steal_one(i)

            stealers = [threading.Thread(target=_stealer) for _ in range(
                min(host_pool_size(self.option) - 1, len(steal_stack)))]
            for th in stealers:
                th.start()
            try:
                waiting = list(launches)
                while waiting:
                    ready = next((ln for ln in waiting if ln.ready()), None)
                    if ready is None:
                        i = _claim()
                        if i is not None:
                            _steal_one(i)
                            continue
                        if all(p in claimed for ln in waiting
                               for p in ln.chunk):
                            break    # every pair left was stolen
                        ready = waiting[0]
                    waiting.remove(ready)
                    self._collect(ready, results, prepared, task, lock,
                                  claimed, pending, flen_param, xdrop, note)
                while (i := _claim()) is not None:
                    _steal_one(i)
            finally:
                for th in stealers:
                    th.join()
        for i in pending:
            results[i] = None
            note(i, None)
        return results


def make_device_kernel(option: Options, param: Params):
    """The batcher for --backend cuda (first selected GPU) or cpu (the
    plain version on CPU tensors); None for the host backends."""
    backend = option.device_backend
    if backend in ("numpy", "native"):
        return None
    if backend == "cpu":
        select_devices(1, option)
        return DeviceTalco(option, param, torch.device("cpu"))
    if backend != "cuda":
        raise ValueError(f"unknown backend {backend!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("--backend cuda needs a CUDA device, and "
                           "torch.cuda.is_available() is false")
    chosen = select_devices(torch.cuda.device_count(), option)
    if len(chosen) > 1:
        print(f"[twilight-tpu-torch] Using 1 of {len(chosen)} selected "
              f"devices (cuda:{chosen[0]}); multi-GPU runs are not ported "
              "yet", file=sys.stderr)
    return DeviceTalco(option, param, torch.device("cuda", chosen[0]))
