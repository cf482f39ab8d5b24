"""Times the TALCO-XDrop kernel of two checkouts of this repository on one
GPU, in turns, on the same inputs.

    python3 -m twilight_tpu_torch.tools.talco_ab --checkout OLD_DIR \\
        --checkout NEW_DIR [--order ABBA] [--out FILE.jsonl]

Each turn runs in a process of its own with its checkout first on
sys.path, so it imports and builds that checkout's package (packer,
batcher, kernel); the inputs and the round trip's measurement are this
tool's own (tools/talco_inputs.py, loaded from beside this file), so both
checkouts see the same pairs. A turn measures:

- us per diagonal of each launch shape chip_smoke.py times: short (batch
  128, padlen 2048: nt freq 900-1200 columns, nt leaf, protein freq
  250-450), long (the batcher's launch size: nt freq and nt leaf at 29-30
  kb, protein freq at 2.9-3 kb) and wide (7 nt freq pairs of 4300-5200
  columns at ladder widths 8192/16384, X-drop 60000): the launch's kernel
  time (CUDA events, resident inputs) over its longest pair's diagonals;
- the launch round trip of the level gate (talco_inputs.gate_round_trip);
- the wall of s20 (20 x 30 kb) and sim2k (2000 x 1 kb, --rooted) through
  the command line with the device forced and no host stealing, and
  sim2k's kernel time on the card from a torch.profiler trace.

Inputs come from fixed seeds, so both checkouts see the same pairs and
sets. The order ABBA (the default) puts each checkout first and last once,
so that a drift of the card or the host over the call falls on both. Each
turn prints one JSON line; the caller prints them and a summary of the
means by checkout. Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

SHORT = [("short nt freq", 6, False, 900, 1200),
         ("short nt leaf", 6, True, 900, 1200),
         ("short protein freq", 22, False, 250, 450)]
LONG = [("long nt freq", 6, False, 29000, 30000),
        ("long nt leaf", 6, True, 29000, 30000),
        ("long protein freq", 22, False, 2900, 3000)]


def _kernel_ms(torch, talco_cuda, st, p, reps):
    """(ms per launch, tail) of one packed batch, inputs resident, at the
    checkout's own launch configuration."""
    mat = torch.from_numpy(st.params.scoring_matrix).cuda()
    d = st.views(st.buf.to("cuda"))
    fn = lambda: talco_cuda.talco_align(  # noqa: E731
        d[1], d[2], d[0], d[3], d[4], mat, p=p,
        scratch_bytes=int(st.offs[-1]))
    _, tail = fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps, tail.cpu().numpy()


def _shapes(torch, inputs):
    import numpy as np
    from twilight_tpu_torch.ops import device_kernel as dk
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.config import Params
    out = {}

    def run(name, p, leaf, prepared, metas, flen, xdrop, padlen, reps):
        param = Params.make("n" if p == 6 else "p")
        b = len(prepared)
        st = inputs.pack(list(range(b)), prepared, metas, 0, p, leaf, param,
                     flen, xdrop, 1024, padlen=padlen)
        st.params = param
        ms, tail = _kernel_ms(torch, talco_cuda, st, p, reps)
        if not (tail[:, 1] == 0).all():
            raise SystemExit(f"{name}: kernel errors {set(tail[:, 1])}")
        diags = int(tail[:, 3].max())
        out[name] = {"pairs": b, "padlen": padlen, "ms_per_launch": ms,
                     "max_diagonals": diags, "us_per_diagonal": 1e3 * ms / diags,
                     "dp_cells": int(tail[:, 2].astype(np.int64).sum())}

    rng = np.random.default_rng(7)
    for name, p, leaf, lo, hi in SHORT:
        prepared, metas = zip(*[inputs.make_pair(rng, p, leaf,
                                             int(rng.integers(lo, hi)))
                                for _ in range(128)])
        run(name, p, leaf, prepared, metas, [4096] * 128, [5000] * 128,
            2048, 5)
    rng = np.random.default_rng(8)
    for name, p, leaf, lo, hi in LONG:
        rows, esz = (1, 1) if leaf else (talco_cuda.p8_of(p), 4)
        b = len(dk.split_launches(
            list(range(128)), [(None,) * 4 + ((hi, hi),)] * 128,
            [4096] * 128, rows, esz, 128)[0][0])
        prepared, metas = zip(*[inputs.make_pair(rng, p, leaf,
                                             int(rng.integers(lo, hi)),
                                             cap=hi) for _ in range(b)])
        padlen = dk.launch_padlen(max(max(pp[4]) for pp in prepared))
        run(name, p, leaf, prepared, metas, [4096] * b, [5000] * b, padlen, 3)
    rng = np.random.default_rng(20261018)
    prepared, metas = zip(*[
        inputs.make_pair(rng, 6, False, int(rng.integers(4300, 5200)),
                     related=t < 4, cap=6000) for t in range(7)])
    padlen = dk.launch_padlen(max(max(pp[4]) for pp in prepared))
    run("wide nt freq", 6, False, prepared, metas,
        [8192 if t % 2 else 16384 for t in range(7)], [inputs.WIDE_XDROP] * 7,
        padlen, 2)
    return out


def _cli(torch, argv, trace_dir=None):
    """(wall s, kernel ms from the trace or None) of one forced run."""
    from twilight_tpu_torch import cli
    os.environ["TWILIGHT_FORCE_DEVICE"] = "1"
    os.environ["TWILIGHT_NO_STEAL"] = "1"
    if trace_dir:
        argv = argv + ["--profile-trace", trace_dir]
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"{argv}: exit code {rc}")
    kernel_ms = None
    if trace_dir:
        kernel_ms = _inputs().trace_device_ms(
            os.path.join(trace_dir, "trace.json"))["talco_ms"]
    return wall, kernel_ms


def _inputs():
    """This tool's talco_inputs module, loaded by path: its package imports
    resolve to the checkout first on sys.path."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "talco_inputs.py")
    spec = importlib.util.spec_from_file_location("talco_ab_inputs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(checkout: str, sets: str) -> dict:
    sys.path.insert(0, os.path.abspath(checkout))
    import torch
    import twilight_tpu_torch
    if not os.path.abspath(twilight_tpu_torch.__file__).startswith(
            os.path.abspath(checkout)):
        raise SystemExit(f"imported {twilight_tpu_torch.__file__}, not "
                         f"{checkout}'s")
    inputs = _inputs()
    from twilight_tpu_torch.ops import build
    build.load()
    res = {"checkout": checkout, "shapes": _shapes(torch, inputs)}
    res["gate_round_trip_ms"] = inputs.gate_round_trip(torch)["round_trip_ms"]
    with tempfile.TemporaryDirectory() as td:
        s20 = ["-t", f"{sets}/s20.nwk", "-i", f"{sets}/s20.fa"]
        sim = ["-t", f"{sets}/sim2k.nwk", "-i", f"{sets}/sim2k.fa",
               "--rooted"]
        _cli(torch, ["--backend", "cuda", "-o", f"{td}/w.aln"] + s20)
        res["s20_forced_wall_s"], _ = _cli(
            torch, ["--backend", "cuda", "-o", f"{td}/s20.aln"] + s20)
        res["sim2k_forced_wall_s"], res["sim2k_kernel_ms"] = _cli(
            torch, ["--backend", "cuda", "-o", f"{td}/sim.aln"] + sim,
            trace_dir=f"{td}/trace")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkout", action="append", default=[],
                    help="a checkout of the repository (give two: A, B)")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--out", help="append each turn's JSON line here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--sets", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("talco_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.worker:
        print(json.dumps(worker(args.worker, args.sets)), flush=True)
        return 0
    if len(args.checkout) != 2:
        ap.error("give two --checkout directories")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    here = os.path.abspath(__file__)
    turns = []
    with tempfile.TemporaryDirectory() as sets:
        for name, extra in (("s20", ["-n", "20", "-l", "30000", "--seed",
                                     "5"]),
                            ("sim2k", ["-n", "2000", "-l", "1000", "--seed",
                                       "0"])):
            subprocess.run([sys.executable, "-m",
                            "twilight_tpu_torch.tools.simulate", *extra,
                            "-o", os.path.join(sets, name)],
                           cwd=os.path.abspath(args.checkout[1]), check=True)
        for label in args.order:
            checkout = os.path.abspath(args.checkout["AB".index(label)])
            r = subprocess.run([sys.executable, here, "--worker", checkout,
                                "--sets", sets], capture_output=True,
                               text=True, cwd=checkout)
            if r.returncode != 0:
                print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
                return 1
            line = r.stdout.strip().splitlines()[-1]
            rec = dict(json.loads(line), turn=label, card=smi)
            turns.append(rec)
            print(json.dumps(rec), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    summary = {}
    for label in "AB":
        recs = [t for t in turns if t["turn"] == label]
        if not recs:
            continue
        mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
        s = {f"{k} us/diag": mean([t["shapes"][k]["us_per_diagonal"]
                                   for t in recs])
             for k in recs[0]["shapes"]}
        for k in ("gate_round_trip_ms", "s20_forced_wall_s",
                  "sim2k_forced_wall_s", "sim2k_kernel_ms"):
            s[k] = mean([t[k] for t in recs])
        summary[f"{label} ({args.checkout['AB'.index(label)]})"] = s
    print("[summary] means by checkout, card " + smi + ": "
          + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
