"""Loop-cost probes on an NVIDIA GPU: per-step cost of the five loop
programs of `tools/probe_loop_costs.py` (K6-K10), through the port's CUDA
kernels (`ops/probe_loop.py`, `ops/csrc/probe_loop_costs.cu`).

Usage:
    python -m twilight_tpu_torch.tools.probe_loop_costs \\
        [carcass|body|scalar0d|deadcode|nested|all] [--device cuda|cpu] \\
        [--trips N1 N2] [--cluster-exchange async|barrier]

Each variant runs the same program at N1 and N2 loop steps (4000 and
40000 by default) and reports (t(N2) - t(N1)) / (N2 - N1) per step
(/ 2 (N2 - N1) for `nested`, whose outer loop runs twice), so the launch
cost cancels. Each time is the best of 6 runs after one warm-up, taken
with CUDA events on the current stream. `--device cpu` runs the plain
PyTorch versions instead, timed by the host clock: a check of the tool,
not a measurement of any device. The variants and their order are the
JAX tool's; the first line names the device. Every variant prints two
lines: its cluster instance (one cluster of 8 CTAs, the default) under
the JAX tool's label, then its one-block instance, the label followed by
" [one block]". `--cluster-exchange barrier` builds the cluster
instances with scalar0d's per-body exchange waiting at a cluster barrier
instead of on st.async stores' mbarrier (`async`, the default; the card
only).
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time

import torch

from ..ops import build, probe_loop

WHAT = ("carcass", "body", "scalar0d", "deadcode", "nested", "all")
# scalar0d's cluster exchange, by PROBE_CLUSTER_EXCHANGE (probe_loop_costs.cu)
EXCHANGES = ("async", "barrier")
REPS = 6


def exchange_flags(exchange: str) -> tuple:
    """The extra nvcc flags (build.variant) of the kernels whose cluster
    instances exchange scalar0d's row maxima by `exchange`."""
    k = EXCHANGES.index(exchange)
    return (f"-DPROBE_CLUSTER_EXCHANGE={k}",) if k else ()


def _time(fn, device) -> float:
    """Best of REPS runs of fn after one warm-up, in seconds."""
    fn()
    best = float("inf")
    for _ in range(REPS):
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            best = min(best, e0.elapsed_time(e1) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def ns_per_step(name: str, trips=(4000, 40000), device="cuda",
                layout="cluster") -> float:
    """Per-step cost of one variant (a name of probe_loop.KERNEL_ID) in
    `layout`."""
    device = torch.device(device)
    out = torch.empty((probe_loop.GRP, probe_loop.W), dtype=torch.float32,
                      device=device)
    lo, hi = trips
    t_lo = _time(lambda: probe_loop.run(name, lo, out, layout), device)
    t_hi = _time(lambda: probe_loop.run(name, hi, out, layout), device)
    steps = (hi - lo) * (2 if name.startswith("nested") else 1)
    return 1e9 * (t_hi - t_lo) / steps


LABELS = {"carcass": "carcass rows=8 cols=20",
          "nested": "nested(2 tiles)", "nested+walk": "nested(2 tiles)+walk"}
BLOCK_SUFFIX = " [one block]"


def layouts(name: str):
    """(label, layout) of each instance the tool times for a variant."""
    label = LABELS.get(name, name)
    return [(label, "cluster"), (label + BLOCK_SUFFIX, "block")]


def variants(what: str):
    """The variants the JAX tool runs for argv `what`, in its order (a
    same-phase body/carried baseline before scalar0d, deadcode and
    nested)."""
    out = []
    if what in ("carcass", "all"):
        out.append("carcass")
    if what in ("body", "all"):
        out += ["body/carried", "body/scratch"]
    if what in ("scalar0d", "all"):
        out += ["body/carried", "scalar0d/cond", "scalar0d/body",
                "scalar0d/both"]
    if what == "deadcode":
        out += ["body/carried", "deadcode"]
    if what == "nested":
        out += ["body/carried", "nested", "nested+walk"]
    return out


def device_line(device) -> str:
    if device.type != "cuda":
        return f"# device: {device.type} (plain versions, host clock)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (f"# device: {torch.cuda.get_device_name(device)} "
            f"({smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else 'nvidia-smi failed'})")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="probe_loop_costs")
    p.add_argument("what", nargs="?", default="all", choices=WHAT)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--trips", type=int, nargs=2, default=(4000, 40000),
                   metavar=("N1", "N2"))
    p.add_argument("--cluster-exchange", choices=EXCHANGES,
                   help="how scalar0d's cluster instances exchange the row "
                   "maxima every body (default async; the card only)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_loop_costs: no CUDA device (torch.cuda.is_available() "
              "is false); --device cpu runs the plain versions",
              file=sys.stderr)
        return 2
    if args.cluster_exchange and args.device != "cuda":
        p.error("--cluster-exchange: with --device cuda")
    flags = exchange_flags(args.cluster_exchange or "async")
    device = torch.device(args.device)
    print(device_line(device), flush=True)
    if flags:
        print("# cluster instances built with " + " ".join(flags), flush=True)
    with build.variant(*flags) if flags else contextlib.nullcontext():
        for name in variants(args.what):
            for label, layout in layouts(name):
                print(f"{label}: "
                      f"{ns_per_step(name, args.trips, device, layout):.1f}"
                      " ns/step", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
