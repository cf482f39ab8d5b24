"""Reduction of the traced window's torch.profiler chrome trace.

Device time is the union of every kernel, copy and memset interval (a
frozen copy of `tools/talco_inputs.trace_device_ms`, counting every
kernel by name, so a renamed kernel still counts). The window is the
union of the benchmark's `msabench.cli_run` annotations, one around each
timed `cli.run`; only device time inside it counts. Idle gaps are the
stretches of the window in which the device ran nothing, each labelled by
the benchmark's host span open at its middle: inside a call into the
batcher, or inside `cli.run` outside it.
"""
from __future__ import annotations

import json

DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
RUN_SPAN = "msabench.cli_run"


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _clip(intervals, windows):
    """Parts of sorted disjoint `intervals` inside sorted disjoint
    `windows`."""
    out, j = [], 0
    for a, b in intervals:
        while j < len(windows) and windows[j][1] <= a:
            j += 1
        k = j
        while k < len(windows) and windows[k][0] < b:
            lo, hi = max(a, windows[k][0]), min(b, windows[k][1])
            if hi > lo:
                out.append([lo, hi])
            k += 1
    return out


def reduce(path: str, run_starts, batcher_spans) -> dict:
    """{busy_s, window_s, kernel_s, device_ops, idle_gaps} of the trace at
    `path`. `run_starts` are the host clock's starts of the timed
    `cli.run` calls and `batcher_spans` the seam's (t0, t1), in seconds of
    `time.perf_counter`: the median gap between a run's start and its
    annotation's puts them on the trace's clock."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    runs = _union((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and "dur" in e
                  and e.get("name", "").startswith(RUN_SPAN))
    dev = [e for e in events if e.get("cat") in DEVICE_EVENTS and "dur" in e]
    busy = _clip(_union((e["ts"], e["ts"] + e["dur"]) for e in dev), runs)
    kern = _clip(_union((e["ts"], e["ts"] + e["dur"]) for e in dev
                        if e["cat"] == "kernel"), runs)
    by_name = {}
    for e in dev:
        part = _clip([[e["ts"], e["ts"] + e["dur"]]], runs)
        if part:
            name = e.get("name", e["cat"])
            by_name[name] = by_name.get(name, 0.0) + sum(
                b - a for a, b in part) / 1e6
    gaps = []
    for lo, hi in runs:
        t = lo
        for a, b in busy:
            if b <= lo or a >= hi:
                continue
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
    starts = sorted(a for a, _ in runs)
    shifts = sorted(t - h * 1e6 for t, h in zip(starts, sorted(run_starts)))
    shift = shifts[len(shifts) // 2] if shifts else 0.0
    spans = _union((a * 1e6 + shift, b * 1e6 + shift)
                   for a, b in batcher_spans)
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        inside = any(s <= mid < e for s, e in spans)
        labelled.append(["host: batcher call" if inside
                         else "host: cli.run outside the batcher",
                         (b - a) / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": sum(b - a for a, b in busy) / 1e6,
            "window_s": sum(b - a for a, b in runs) / 1e6,
            "kernel_s": sum(b - a for a, b in kern) / 1e6,
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": labelled}
