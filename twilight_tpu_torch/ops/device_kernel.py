"""Batcher for the CUDA TALCO kernel: the port of
`twilight_tpu/ops/device_kernel.py` (`DeviceTalco`, `make_device_kernel`,
`select_devices`).

A call runs in rounds, each one planned (`_plan`), issued (`_issue`) and
drained (`_drain`). Per round it sorts the pairs by size and cuts them
into launches by route: short launches (every side within the
2048-column bucket, padlen 2048), long launches (the route of the TPU's
K4: padlen is the launch's longest side rounded up to 256) and wide
launches (pairs whose retry-ladder width grew past 4096, the work of the
TPU's K5). Each launch holds at most
--pair-batch pairs and stays within a byte budget for its pinned staging
and its device scratch. It packs each launch's pairs straight into one
pinned host buffer (the g8 compact layout, `talco_cuda` module doc), and
issues one H2D copy, the kernel and one D2H copy on its own CUDA stream,
with an event marking the result ready. While launches are in flight the
host steals pairs from the tail onto the native kernel (both produce the
same bits), and each result is handed to `on_final` as soon as it is
final. Errors 1/2 at task != 0 re-launch with the reference retry ladder
(`ladder.step`; gap_char and the starting state come from `ladder` too);
errors 3/4, and 1/2 at task 0, give None (the host ladder decides). A pair
whose ladder width would exceed `MAX_WINDOW` gives None as well, as in the
JAX batcher, and is counted and announced. A failed launch raises.

Long launches (padlen above 2048) run side by side. Each pair is one
block, and a long pair's time is the latency of its tens of thousands of
dependent anti-diagonals, so a launch of a few dozen pairs leaves most
SMs idle. A round's long launches on a device therefore go out on a pool
of streams, as many as it takes for its launches to fill the device's
resident capacity (its SMs times the blocks of the kernel instance one
SM holds; `talco_cuda.resident_blocks`), and launch k takes stream k
modulo the pool (`wave_plan`). The launches that, in issue order, fit
that capacity together are the round's first wave: they start at once,
so the host never steals their pairs (a host thread takes longer for a
long pair than the card does). It steals from the tail of the later long
launches, and of every short launch, as before. The plain version on a
CPU device runs one launch at a time: its first wave is its first long
launch.

Several devices (the counterpart of the JAX package's pairs mesh,
`twilight_tpu/parallel/sharding.py` and its device_kernel.py:541-557):
each selected device has its own copy of the substitution matrix, its own
stream and its own launch count. A launch group takes --pair-batch pairs
a device (and the byte budgets a device) of the route's size-sorted
pairs, striped over the devices (device d takes group[d::n]), so that
every device's launch holds pairs of similar sizes. Stealing and the
ladder work on the launches of every device alike; the bits do not depend
on which device aligned a pair.

The run's tracer (`trace`) times a call (`batcher.call`), each launch's
packing (`batcher.pack`), issue (`batcher.launch`) and wait on its event
(`batcher.wait`), and each stolen pair (`batcher.steal`, and
`batcher.steal_long` in its place for a long pair). On the long route it
also counts the launches (`launches_long`, ladder relaunches included),
those issued while an earlier long launch of the round on another of the
device's streams had not finished (`launches_long_beside`), the pairs in
them (`pairs_long_launched`), the long pairs whose final
result came from the card (`pairs_long_card`) and those the host stole
(`pairs_long_host`). Spans and counters record only while the tracer is
on; `stats` counts the DP cells of every tail the batcher reads
(`dp_cells`) always. Where the tracer is on, the batcher prints from
those spans to stderr, in the JAX batcher's `[dev]` lines' place (its
device_kernel.py:538, 675, 695, 768): one line a launch, when its round ends (route, padlen, the pairs'
widest ladder width, --pair-batch, pairs, and the seconds of packing,
of issuing the launch, and of the host's wait for its result; a launch
whose pairs were all stolen is never waited for), the round's blocked
time on launches when above 1 s, and one line a call (pairs resolved on
the card and stolen by the host, the host's steal seconds summed over
its threads, launches, wall). Wide launches are the JAX batcher's
escalated buckets: their route says so.
"""
from __future__ import annotations

import os
import sys
import threading
from fractions import Fraction
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .. import trace
from ..config import Options, Params, host_pool_size
from ..constants import letter_lut
from . import ladder, talco_cuda
from .talco_cuda import MARKER, MAX_WINDOW, TAIL, p8_of

MAX_ROUNDS = 30
SHORT_PADLEN = 2048          # the main path's bucket
PADLEN_ALIGN = 256           # a long launch's padlen is a multiple of this
STAGING_BUDGET = 64 << 20    # pinned ref + qry bytes of one launch
SCRATCH_BUDGET = 2 << 30     # device scratch bytes of one launch
_TAG = "[twilight-tpu-torch]"


def is_long(lens) -> bool:
    """Whether a pair of side lengths `lens` takes the long route: a side
    above the 2048-column bucket."""
    return max(lens) > SHORT_PADLEN


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


def wave_plan(blocks, capacity):
    """The first wave and the streams of one device's long launches in a
    round, in issue order. Launch k holds `blocks[k]` pairs, one block
    each, of a kernel instance of which the device holds `capacity[k]`
    blocks at once (None: the device runs one launch at a time). Launch k
    is in the first wave when it fits the capacity together with the
    launches before it. The pool holds enough streams for the launch that
    takes the most of the capacity to fill it alongside launches of its
    own size, and no more than there are launches; launch k takes stream
    k modulo the pool. Returns ([in the first wave], [stream index])."""
    shares = [(b, b if c is None else c) for b, c in zip(blocks, capacity)]
    first, filled = [], Fraction(0)
    for b, c in shares:
        filled += Fraction(b, c)
        first.append(filled <= 1)
    pool = max(1, min([len(shares)] + [-(-c // b) for b, c in shares]))
    return first, [k % pool for k in range(len(shares))]


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
        ints[:, bi] = (rl, ql, flen_param[i], xdrop[i])
        floats[:, bi] = (np.float32(rnum), np.float32(qnum),
                         np.float32(0.0)
                         if ladder.gap_char_zero(task, rnum, qnum) else ge,
                         go, ge)
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
    __slots__ = ("chunk", "staging", "host_out", "event", "padlen",
                 "stream", "pack_s", "launch_s", "wait_s")

    def __init__(self, chunk, staging, host_out, event, padlen,
                 stream: int = 0):
        self.chunk = chunk
        self.staging = staging      # held until the H2D copy has completed
        self.host_out = host_out
        self.event = event
        self.padlen = padlen
        self.stream = stream        # its index in the device's pool
        self.pack_s = self.launch_s = 0.0
        self.wait_s = None          # never waited for: all stolen

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()   # releases the GIL


class _Planned(NamedTuple):
    """One launch of a round's plan."""
    chunk: list          # its pairs, size-sorted
    padlen: int
    long: bool           # `is_long` pairs
    wide: bool           # ladder width above the batcher's base_flen
    leaf: bool           # letter codes, not profiles
    device: int          # index in DeviceTalco.devices
    width: int           # the pairs' widest ladder width when planned
    first: bool = False  # in the device's first wave: never stolen
    stream: int = 0      # index in the device's pool of streams

    def route(self, n_dev: int) -> str:
        """Its route as the `[dev]` lines name it, over n_dev devices."""
        return (("long" if self.long else "short")
                + (" leaf" if self.leaf else " freq")
                + (" wide" if self.wide else "")
                + (f" q{self.device}" if n_dev > 1 else ""))


class _Call:
    """One call's pairs, their ladder state and results, and the seconds
    the host spent stealing (in ns, over its threads)."""
    __slots__ = ("prepared", "metas", "task", "note", "results", "flen",
                 "xdrop", "steal_ns")

    def __init__(self, prepared, metas, task, note, flen, xdrop):
        n = len(prepared)
        self.prepared, self.metas, self.task = prepared, metas, task
        self.note = note
        self.results: List[Optional[np.ndarray]] = [None] * n
        self.flen = [flen] * n       # the reference ladder's state
        self.xdrop = [xdrop] * n
        self.steal_ns = 0


class _Claims:
    """Which of a round's pairs the card or the host has taken, and the
    stack the host steals from."""

    def __init__(self, stack):
        self.lock = threading.Lock()
        self.claimed: set = set()
        self.stack = stack

    def take(self) -> Optional[int]:
        """The pair on top of the stack that nobody has taken, now the
        host's, or None."""
        with self.lock:
            while self.stack:
                i = self.stack.pop()
                if i not in self.claimed:
                    self.claimed.add(i)
                    return i
        return None


class DeviceTalco:
    """The kernel contract of pipeline/aligner.py:302-378 over the CUDA
    kernel (or, on a CPU device, its plain PyTorch version), on one device
    or a list of them (a device may appear twice: two queues on one
    card)."""

    supports_on_final = True

    def __init__(self, option: Options, param: Params, devices):
        self.option = option
        self.param = param
        if isinstance(devices, (str, torch.device)):
            devices = [devices]
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("no device given")
        for d in self.devices:
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {d}")
        self.device = self.devices[0]
        self.p = 6 if option.type == "n" else 22
        # starting ladder width; wider is "wide"
        self.base_flen = ladder.start(param)[0]
        self.max_window = MAX_WINDOW
        self.marker = MARKER
        self.batch = max(1, option.pair_batch)
        # TWILIGHT_NO_STEAL pins every pair to the device
        self.no_steal = bool(os.environ.get("TWILIGHT_NO_STEAL"))
        self.matrices = [talco_cuda.device_params(param, d)[0]
                         for d in self.devices]
        self.streams = [None] * len(self.devices)
        if any(d.type == "cuda" for d in self.devices):
            from . import build
            build.load()     # a failed build raises before any level runs
            self.streams = [torch.cuda.Stream(d) if d.type == "cuda"
                            else None for d in self.devices]
        # each device's pool of streams for long launches side by side,
        # its first stream the device's own; grown as rounds need
        self.pools = [[s] for s in self.streams]
        self._resident = {}     # (device index, leaf) -> capacity in blocks
        # launches counts kernel launches on the card; launches_by_device
        # counts the launches of each device in `devices` (of the plain
        # version on a CPU device); leaf_launches, long_launches and
        # wide_launches count launches by route on either device, and
        # ladder_relaunches the pairs the retry ladder sent back to one;
        # dp_cells sums the DP cells of the tails read
        self.stats = {"launches": 0, "pairs": 0, "zero_length": 0,
                      "pairs_on_device": 0, "host_stolen": 0,
                      "err3_fallbacks": 0, "task0_errors": 0,
                      "leaf_launches": 0, "long_launches": 0,
                      "wide_launches": 0,
                      "ladder_relaunches": 0, "host_wide": 0,
                      "dp_cells": 0,
                      "launches_by_device": [0] * len(self.devices)}

    def close(self) -> None:
        """Wait for every stream: no launch outlives the run."""
        for pool in self.pools:
            for stream in pool:
                if stream is not None:
                    stream.synchronize()

    def capacity(self, q: int, leaf: bool) -> Optional[int]:
        """Blocks of the route's kernel instance that device `q` holds at
        once, or None on a CPU device, which runs one launch at a time."""
        device = self.devices[q]
        if device.type != "cuda":
            return None
        key = (q, leaf)
        if key not in self._resident:
            self._resident[key] = talco_cuda.resident_blocks(
                self.p, leaf, device, msize=self.matrices[q].shape[0])
        return self._resident[key]

    def _stream(self, q: int, s: int):
        """Stream `s` of device `q`'s pool, made at first use."""
        pool = self.pools[q]
        while len(pool) <= s:
            device = self.devices[q]
            pool.append(torch.cuda.Stream(device) if device.type == "cuda"
                        else None)
        return pool[s]

    def summary(self) -> str:
        return (f"{_TAG} {', '.join(str(d) for d in self.devices)}: "
                + " ".join(f"{k}={v}" for k, v in self.stats.items()))

    def _launch(self, chunk, padlen, prepared, metas, task, leaf,
                flen_param, xdrop, s: int = 0, q: int = 0) -> _Launch:
        """One launch of `chunk` on stream `s` of the pool of device `q`
        of `devices`."""
        device, matrix, stream = (self.devices[q], self.matrices[q],
                                  self._stream(q, s))
        cuda = device.type == "cuda"
        self.stats["launches_by_device"][q] += 1
        with trace.span("batcher.pack", mark=False) as pack:
            if leaf:
                st = pack_batch_leaf(chunk, prepared, metas, padlen, self.p,
                                     self.param, flen_param, xdrop,
                                     marker=self.marker, pin=cuda)
            else:
                st = pack_batch(chunk, prepared, metas, task, padlen,
                                self.p, self.param, flen_param, xdrop,
                                marker=self.marker, pin=cuda)
        b = len(chunk)
        nbytes = b * 2 * padlen + b * TAIL * 4
        scratch = int(st.offs[-1])
        with trace.span("batcher.launch", mark=False) as issue:
            if not cuda:
                host = torch.empty(nbytes, dtype=torch.uint8)
                talco_cuda.talco_align(
                    st.ints, st.floats, st.offs, st.ref, st.qry, matrix,
                    p=self.p, marker=self.marker, scratch_bytes=scratch,
                    out=out_views(host, b, padlen))
                ev = None
            else:
                with torch.cuda.device(device), torch.cuda.stream(stream):
                    dev = st.views(st.buf.to(device, non_blocking=True))
                    obuf = torch.empty(nbytes, dtype=torch.uint8,
                                       device=device)
                    offs, ints, floats, ref, qry = dev
                    talco_cuda.talco_align(
                        ints, floats, offs, ref, qry, matrix, p=self.p,
                        marker=self.marker, scratch_bytes=scratch,
                        out=out_views(obuf, b, padlen))
                    host = torch.empty(nbytes, dtype=torch.uint8,
                                       pin_memory=True)
                    host.copy_(obuf, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(stream)
                self.stats["launches"] += 1
        launch = _Launch(chunk, st, host, ev, padlen, s)
        launch.pack_s = pack.ns / 1e9
        launch.launch_s = issue.ns / 1e9
        return launch

    def _host_align(self, prep, meta, task):
        """The reference retry ladder on the native host kernel (the same
        bits as the device path)."""
        path, needs_fallback = ladder.align_prepared(prep, meta, task,
                                                     self.param, self.option)
        return path if not needs_fallback else None

    def _collect(self, launch, results, prepared, task, lock, claimed,
                 pending, flen_param, xdrop, note) -> None:
        with trace.span("batcher.wait", mark=False) as wait:
            launch.wait()
        launch.wait_s = wait.ns / 1e9
        b = len(launch.chunk)
        paths, tail = out_views(launch.host_out, b, launch.padlen)
        paths, tail = paths.numpy(), tail.numpy()
        self.stats["dp_cells"] += int(tail[:, 2].sum(dtype=np.int64))
        for bi, i in enumerate(launch.chunk):
            with lock:
                if i in claimed:
                    continue         # the host stole it
                claimed.add(i)
            ln, e = int(tail[bi, 0]), int(tail[bi, 1])
            if e == 0:
                results[i] = paths[bi, :ln].copy()
                self.stats["pairs_on_device"] += 1
                if is_long(prepared[i][4]):
                    trace.count("pairs_long_card")
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
                flen_param[i], xdrop[i] = ladder.step(
                    e, flen_param[i], xdrop[i], prepared[i][4])
                pending.append(i)

    def __call__(self, prepared, metas, database, option, param,
                 on_final=None) -> List[Optional[np.ndarray]]:
        with trace.span("batcher.call", mark=False) as call:
            results, done = self._align(prepared, metas, database, param,
                                        on_final)
        if done is not None:
            print(f"{done} wall={call.ns / 1e9:.3f}s", file=sys.stderr)
        return results

    def _align(self, prepared, metas, database, param, on_final):
        """The body of a call, a round at a time: plan, issue, drain.
        Returns (results, the start of the call's `[dev]` line, or None
        where the tracer is off)."""
        c = _Call(prepared, metas, database.current_task,
                  on_final or (lambda i, p: None), self.base_flen,
                  ladder.start(param)[1])
        pending: List[int] = []
        self.stats["pairs"] += len(prepared)
        for i, prep in enumerate(prepared):
            lens = prep[4]
            if lens[0] <= 0 or lens[1] <= 0:
                self.stats["zero_length"] += 1
                c.note(i, None)   # zero-length side: post handles it
            else:
                pending.append(i)
        profile = trace.on()
        on_device0 = self.stats["pairs_on_device"]
        stolen0 = self.stats["host_stolen"]
        launches0 = sum(self.stats["launches_by_device"])

        rounds = 0
        while pending and rounds < MAX_ROUNDS:
            rounds += 1
            plan = self._plan(c, self._routes(c, pending, rounds))
            launches = self._issue(c, plan)
            pending = self._drain(c, plan, launches)
            if profile:
                self._print_round(launches, [(p.route(len(self.devices)),
                                              p.width) for p in plan])
        for i in pending:
            c.note(i, None)
        if not profile:
            return c.results, None
        return c.results, (
            f"    [dev] call done: pairs={len(prepared)} "
            f"device={self.stats['pairs_on_device'] - on_device0} "
            f"host-stolen={self.stats['host_stolen'] - stolen0} "
            f"steal_dp={c.steal_ns / 1e9:.3f}s launches="
            f"{sum(self.stats['launches_by_device']) - launches0}")

    def _routes(self, c: _Call, pending, rounds: int):
        """A round's pairs by route, {(long, wide, leaf): [pair]} in
        `pending` order. A pair whose ladder width would pass max_window
        gives None: the host ladder aligns it."""
        routes, too_wide = {}, []
        for i in pending:
            lens = c.prepared[i][4]
            if min(c.flen[i], min(lens)) > self.max_window:
                # the JAX batcher's cap (its device_kernel.py:464-468)
                too_wide.append(i)
                continue
            # after the first round, every pending pair is a ladder step
            self.stats["ladder_relaunches"] += rounds > 1
            leaf = is_leaf_pair(c.prepared[i], c.metas[i], c.task,
                                c.flen[i], self.base_flen)
            routes.setdefault((is_long(lens), c.flen[i] > self.base_flen,
                               leaf), []).append(i)
        if too_wide:
            self.stats["host_wide"] += len(too_wide)
            print(f"{_TAG} {len(too_wide)} pairs need a ladder width "
                  f"above {self.max_window} columns: the host ladder "
                  "aligns them", file=sys.stderr)
            for i in too_wide:
                c.note(i, None)
        return routes

    def _plan(self, c: _Call, routes) -> List[_Planned]:
        """A round's launches in issue order. Each route's pairs, sorted
        by size so that a launch's blocks carry similar work, are cut into
        groups of every device's share, and a group is striped over the
        devices (device d takes group[d::n]), so that each device's launch
        holds pairs of similar sizes. Then `wave_plan` gives each device's
        long launches their first-wave flag and stream; a short launch is
        in no wave and takes the device's first stream."""
        n_dev = len(self.devices)
        plan = []
        for (long_, wide, leaf), idxs in routes.items():
            idxs.sort(key=lambda i: -(c.prepared[i][4][0]
                                      + c.prepared[i][4][1]))
            rows, esz = (1, 1) if leaf else (p8_of(self.p), 4)
            for group, _ in split_launches(
                    idxs, c.prepared, c.flen, rows, esz, self.batch * n_dev,
                    marker=self.marker,
                    staging_budget=STAGING_BUDGET * n_dev,
                    scratch_budget=SCRATCH_BUDGET * n_dev):
                for q in range(n_dev):
                    plan.extend(
                        _Planned(chunk, padlen, long_, wide, leaf, q,
                                 max(c.flen[i] for i in chunk))
                        for chunk, padlen in split_launches(
                            group[q::n_dev], c.prepared, c.flen, rows, esz,
                            self.batch, marker=self.marker))
        for q in range(n_dev):
            ks = [k for k, p in enumerate(plan) if p.long and p.device == q]
            first, streams = wave_plan(
                [len(plan[k].chunk) for k in ks],
                [self.capacity(q, plan[k].leaf) for k in ks])
            for k, f, s in zip(ks, first, streams):
                plan[k] = plan[k]._replace(first=f, stream=s)
        return plan

    def _issue(self, c: _Call, plan: List[_Planned]) -> List[_Launch]:
        """Issues the planned launches in order and counts them by route;
        on the long route also the launches issued while an earlier long
        launch of the round on another of the device's streams runs."""
        launches: List[_Launch] = []
        long_issued = [[] for _ in self.devices]
        for p in plan:
            ln = self._launch(p.chunk, p.padlen, c.prepared, c.metas, c.task,
                              p.leaf, c.flen, c.xdrop, p.stream, p.device)
            launches.append(ln)
            self.stats["leaf_launches"] += int(p.leaf)
            self.stats["long_launches"] += int(p.long)
            self.stats["wide_launches"] += int(p.wide)
            if p.long:
                trace.count("launches_long")
                trace.count("pairs_long_launched", len(p.chunk))
                if any(o.stream != p.stream and not o.ready()
                       for o in long_issued[p.device]):
                    trace.count("launches_long_beside")
                long_issued[p.device].append(ln)
        return launches

    def _drain(self, c: _Call, plan: List[_Planned],
               launches: List[_Launch]) -> List[int]:
        """Collects the round's launches as they finish, while the host
        steals pairs from the tail of the launches outside the first wave
        (of none under no_steal) onto the native kernel. Returns the pairs
        the ladder sends back to the card."""
        pending: List[int] = []
        claims = _Claims([] if self.no_steal else
                         [i for p in plan if not p.first for i in p.chunk])
        stealers = [threading.Thread(target=self._steal, args=(c, claims))
                    for _ in range(min(host_pool_size(self.option) - 1,
                                       len(claims.stack)))]
        for th in stealers:
            th.start()
        try:
            waiting = list(launches)
            while waiting:
                ready = next((ln for ln in waiting if ln.ready()), None)
                if ready is None:
                    if self._steal(c, claims, once=True):
                        continue
                    if all(i in claims.claimed for ln in waiting
                           for i in ln.chunk):
                        break    # every pair left was stolen
                    ready = waiting[0]
                waiting.remove(ready)
                self._collect(ready, c.results, c.prepared, c.task,
                              claims.lock, claims.claimed, pending, c.flen,
                              c.xdrop, c.note)
            self._steal(c, claims)
        finally:
            for th in stealers:
                th.join()
        return pending

    def _steal(self, c: _Call, claims: _Claims, once: bool = False) -> bool:
        """Aligns the pairs the host takes from the claims' stack on the
        host kernel, until the stack is empty or, with `once`, after one
        pair. Returns whether it took any."""
        took = False
        while (i := claims.take()) is not None:
            long_ = is_long(c.prepared[i][4])
            with trace.span("batcher.steal_long" if long_
                            else "batcher.steal", mark=False) as steal:
                c.results[i] = self._host_align(c.prepared[i], c.metas[i],
                                                c.task)
            with claims.lock:
                self.stats["host_stolen"] += 1
                c.steal_ns += steal.ns
            if long_:
                trace.count("pairs_long_host")
            c.note(i, c.results[i])
            took = True
            if once:
                break
        return took

    def _print_round(self, launches, routes) -> None:
        """The TWILIGHT_PROFILE lines of one round's launches (module
        doc)."""
        for ln, (route, width) in zip(launches, routes):
            wait = "-" if ln.wait_s is None else f"{ln.wait_s:.3f}s"
            print(f"    [dev] launch {route} p{ln.padlen} w{width} "
                  f"b{self.batch} n{len(ln.chunk)}: pack={ln.pack_s:.3f}s "
                  f"launch={ln.launch_s:.3f}s wait={wait}", file=sys.stderr)
        blocked = sum(ln.wait_s or 0.0 for ln in launches)
        if blocked > 1.0:
            print(f"    [dev] blocked {blocked:.1f}s on launches",
                  file=sys.stderr)


def cpu_device_count() -> int:
    """CPU devices --backend cpu offers (TWILIGHT_TORCH_CPU_DEVICES,
    default 1): the counterpart of the JAX package's virtual CPU devices,
    so that a host with no GPU runs the multi-device batcher."""
    raw = os.environ.get("TWILIGHT_TORCH_CPU_DEVICES", "1")
    if not raw.isdigit() or int(raw) < 1:
        raise ValueError(f"TWILIGHT_TORCH_CPU_DEVICES={raw!r}: want a "
                         "positive integer")
    return int(raw)


def make_device_kernel(option: Options, param: Params):
    """The batcher for --backend cuda (every selected GPU) or cpu (the
    plain version on CPU tensors, one queue a selected CPU device); None
    for the host backends."""
    backend = option.device_backend
    if backend in ("numpy", "native"):
        return None
    if backend == "cpu":
        chosen = select_devices(cpu_device_count(), option)
        return DeviceTalco(option, param, [torch.device("cpu")] * len(chosen))
    if backend != "cuda":
        raise ValueError(f"unknown backend {backend!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("--backend cuda needs a CUDA device, and "
                           "torch.cuda.is_available() is false")
    chosen = select_devices(torch.cuda.device_count(), option)
    return DeviceTalco(option, param,
                       [torch.device("cuda", i) for i in chosen])
