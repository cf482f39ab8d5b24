"""The port's tracer: named spans and counters at the boundaries of the
pipeline host and the batcher, one tracer for each `cli.run`.

`cli.run` starts a tracer on its own thread and decides there, once,
whether it is on: under `--profile-trace`, under TWILIGHT_PROFILE (read
here alone), or when torch is already imported and a torch.profiler is
active on that thread. Off, `span()` hands back one shared no-op and
`count()` returns at once, and the run leaves no record.

On, a span keeps its name, its `perf_counter_ns` start and end, its
parent on its thread, the thread's id and the run's id, in memory until
the run ends. On the run's thread, while a profiler is active, a span
opened with `mark=True` (once a run, a level or a subtree) is also a
`record_function("twilight.<name>")` range on the trace's clock; the
spans of other threads, and those opened once a pair, stay in memory.
As soon as a profiler is active the tracer opens one `twilight.clock`
range and keeps the `perf_counter_ns` readings around its two ends:
against that range's `ts` and `dur` in an exported trace, every span of
every thread lands on the trace's clock (`Tracer.export`, which
`--profile-trace` calls; `clock_shift`).

At the run's end, when the run has a batcher, the totals go into its
`stats` as integers: `span_ns.<name>`, the span's self time (its length
less what its children on its thread cover) summed over the run, and
`count.<name>`, for every name of `SPANS` and `COUNTS`.

| Span | Opened around | Thread |
|---|---|---|
| `run` | `cli.run`, first line to return | run |
| `run.setup` | argument checks, `Params.make`, the batcher's making | run |
| `io.tree`, `io.read`, `io.write` | the tree file (and prune); the FASTA reader; the writers | run |
| `subtree.store` | a divide-and-conquer subtree's store (profile, file, checkpoint) | run |
| `tree.partition`, `tree.subtree`, `schedule` | partition and meta-tree; `Tree.from_subtree` (reroot, weights); the level schedule and each level's node update | run |
| `level` | `aligner.align_pairs` | run |
| `level.prep` | profiles, consensus, gappy columns, gap scores | run |
| `level.dp_host` | host DP that the run's thread runs or waits on | run |
| `level.post`, `root_update` | a pair's post phase; the root's member update | run |
| `level.wait` | waiting for a pair's result from the batcher, and its join | run |
| `deferred`, `subtree`, `merge` | the realign pass; a D&C subtree; the meta-tree merge | run |
| `batcher.call`, `batcher.pack`, `batcher.launch`, `batcher.wait`, `batcher.steal` | `DeviceTalco.__call__`; packing a launch; issuing it; the wait on its event; a stolen short pair | batcher, stealers |
| `batcher.steal_long` | a stolen long pair (a side above the 2048-column bucket): its host DP | batcher, stealers |

Counters: `levels_card`, `levels_host` (the level gate's decision),
`pairs_card`, `pairs_host` (the pairs of those levels), `deferred`
(pairs sent to the realign pass), `bytes_written` (alignment bytes the
writer wrote), `pairs_prep_native`, `pairs_prep_py` (the pairs whose prep
ran in hostops' level prep, and in Python), and the batcher's long route:
`launches_long` (long launches issued, ladder relaunches included),
`pairs_long_launched` (the pairs in them), `pairs_long_card` (long pairs
whose final result came from the card), `pairs_long_host` (long pairs the
host stole), `launches_long_beside` (long launches issued while an earlier
long launch of the round, on another of the device's streams, had not
finished). Like every span, each counter records only while the tracer
is on.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time

SPANS = ("run", "run.setup", "io.tree", "io.read", "io.write",
         "subtree.store", "tree.partition", "tree.subtree", "schedule",
         "level", "level.prep", "level.dp_host", "level.post",
         "root_update", "level.wait", "deferred", "subtree", "merge",
         "batcher.call", "batcher.pack", "batcher.launch", "batcher.wait",
         "batcher.steal", "batcher.steal_long")
COUNTS = ("levels_card", "levels_host", "pairs_card", "pairs_host",
          "deferred", "bytes_written", "pairs_prep_native", "pairs_prep_py",
          "launches_long", "pairs_long_launched", "pairs_long_card",
          "pairs_long_host", "launches_long_beside")
CLOCK = "twilight.clock"

_current = None          # the tracer of the cli.run in flight
_run_ids = itertools.count(1)


def profile_requested() -> bool:
    """Whether TWILIGHT_PROFILE asks for the profile lines."""
    return bool(os.environ.get("TWILIGHT_PROFILE"))


def _profiler_active() -> bool:
    """A torch.profiler active on this thread; torch is not imported for
    the question."""
    torch = sys.modules.get("torch")
    enabled = getattr(getattr(torch, "autograd", None),
                      "_profiler_enabled", None)
    return bool(enabled is not None and enabled())


class _Off:
    """The span of a run whose tracer is off: no clock read, no record."""
    __slots__ = ()
    ns = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class Span:
    """One timed stretch of one thread (module doc)."""
    __slots__ = ("name", "run_id", "tid", "t0", "t1", "child_ns", "parent",
                 "_tracer", "_mark", "_range")

    def __init__(self, tracer: "Tracer", name: str, mark: bool):
        self.name = name
        self.run_id = tracer.run_id
        self.child_ns = 0
        self._tracer = tracer
        self._mark = mark
        self._range = None

    def __enter__(self):
        tr = self._tracer
        stack = tr._stack()
        self.parent = stack[-1] if stack else None
        self.tid = threading.get_native_id()
        stack.append(self)
        if self._mark and tr.marking and threading.get_ident() == tr.main:
            from torch.profiler import record_function
            self._range = record_function("twilight." + self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        tr = self._tracer
        tr._stack().pop()
        if self.parent is not None:
            self.parent.child_ns += self.t1 - self.t0
        tr.records.append(self)
        return False

    @property
    def ns(self) -> int:
        return self.t1 - self.t0


class Tracer:
    """The spans and counters of one run (module doc)."""

    def __init__(self, on: bool):
        self.on = on
        self.run_id = next(_run_ids)
        self.main = threading.get_ident()
        self.marking = False
        self.clock_ns = None
        self.records = []
        self.counts = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._run = None

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def profiler_started(self) -> None:
        """A profiler is now active on the run's thread: mark its spans
        and open the clock's range."""
        from torch.profiler import record_function
        self.marking = True
        rng = record_function(CLOCK)
        a = time.perf_counter_ns()
        rng.__enter__()
        b = c = time.perf_counter_ns()
        rng.__exit__(None, None, None)
        self.clock_ns = (a, b, c, time.perf_counter_ns())

    def totals(self) -> dict:
        """`span_ns.<name>` (self time, summed) and `count.<name>` of
        every name of SPANS and COUNTS, and of any other name used."""
        out = {f"span_ns.{n}": 0 for n in SPANS}
        for s in self.records:
            key = "span_ns." + s.name
            out[key] = out.get(key, 0) + s.t1 - s.t0 - s.child_ns
        out.update({f"count.{n}": 0 for n in COUNTS})
        for n, v in self.counts.items():
            out["count." + n] = v
        return out

    def export(self, path: str) -> None:
        """Adds every span of every thread to the chrome trace at `path`
        as an "X" event of cat `twilight` (the thread's own id as `tid`),
        placed by the clock's range; nothing where the trace has none."""
        with open(path) as f:
            data = json.load(f)
        events = data.setdefault("traceEvents", [])
        clock = next((e for e in events if e.get("name") == CLOCK
                      and "ts" in e), None)
        if clock is None or self.clock_ns is None:
            return
        shift = clock_shift(self.clock_ns, float(clock["ts"]),
                            float(clock.get("dur", 0.0)))
        pid = clock.get("pid", os.getpid())
        events.extend(
            {"ph": "X", "cat": "twilight", "name": s.name, "pid": pid,
             "tid": s.tid, "ts": round(s.t0 / 1e3 + shift, 3),
             "dur": round((s.t1 - s.t0) / 1e3, 3),
             "args": {"run": s.run_id}}
            for s in self.records)
        with open(path, "w") as f:
            json.dump(data, f)


def clock_shift(clock_ns, ts: float, dur: float) -> float:
    """Microseconds to add to perf_counter_ns / 1e3 to reach the trace's
    clock. The clock's range began between clock_ns[0] and [1] and ended
    between [2] and [3] (perf_counter_ns) and spans ts to ts + dur in the
    trace: the middle of the shifts both ends allow, else of the end's
    (a range's first opening in a process is slow to stamp)."""
    a, b, c, d = (t / 1e3 for t in clock_ns)
    lo, hi = ts + dur - d, ts + dur - c
    if max(lo, ts - b) <= min(hi, ts - a):
        lo, hi = max(lo, ts - b), min(hi, ts - a)
    return (lo + hi) / 2


def start(profile_trace: bool, t0_ns: int) -> Tracer:
    """The tracer of a run that began at `t0_ns` (perf_counter_ns), on
    and made current as the module doc says, with its `run` span open."""
    global _current
    profiling = _profiler_active()
    tr = Tracer(profile_trace or profile_requested() or profiling)
    _current = tr
    if tr.on:
        if profiling:
            tr.profiler_started()
        tr._run = Span(tr, "run", True).__enter__()
        tr._run.t0 = min(tr._run.t0, t0_ns)
    return tr


def finish(tr: Tracer, kernel=None) -> None:
    """Closes the run's span, ends the run and, where the tracer is on and
    the run has a batcher, adds the totals to its stats."""
    global _current
    if tr._run is not None:
        tr._run.__exit__(None, None, None)
    _current = None
    if tr.on and kernel is not None:
        kernel.stats.update(tr.totals())


def on() -> bool:
    """The one switch of the profile lines: the run's tracer, and outside
    a run TWILIGHT_PROFILE."""
    tr = _current
    return tr.on if tr is not None else profile_requested()


def span(name: str, mark: bool = True):
    """A span of the run in flight (module doc); `mark=False` for spans
    opened once a pair, which never become profiler ranges."""
    tr = _current
    if tr is None or not tr.on:
        return OFF
    return Span(tr, name, mark)


def count(name: str, n: int = 1) -> None:
    """Adds n to the run's counter `name`."""
    tr = _current
    if tr is None or not tr.on:
        return
    with tr._lock:
        tr.counts[name] = tr.counts.get(name, 0) + n
