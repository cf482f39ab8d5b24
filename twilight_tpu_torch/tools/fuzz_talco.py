"""Fuzzes the TALCO-XDrop CUDA kernel against the oracle: the port's
counterpart of tools/fuzz_g8.py (the invariant "fuzz them against the
oracle after any change").

    python -m twilight_tpu_torch.tools.fuzz_talco [--n 32] [--seed 0]
        [--paths nt,protein] [--modes freq,leaf] [--marker 1024]
        [--route short|long|wide] [--device cuda|cpu] [--workers 8]

Seeded random pairs of each path (nt, protein) and mode (freq: weighted
profiles with position-specific gap rows, half of them at task 1 where
gap_char is 0; leaf: letter codes) go through the kernel in launches packed
as the batcher packs them (tools/talco_inputs.py). The port has no groups
and no fixed window, so --route takes the place of fuzz_g8's
--padlen/--flen/--wide/--grp:

- short: pairs of 30-2048 columns at padlen 2048 (the TPU's K1/K2);
- long: pairs of 2049-32768 columns, cut into launches as the batcher cuts
  them (K4);
- wide: freq pairs of 4300-5200 columns at X-drop 60000, each at ladder
  width 4096 (the band overflows it: error 2) and again at 8192 or 16384
  (K5). Leaf pairs never take a wider width (device_kernel.is_leaf_pair),
  so this route runs freq pairs only.

On the short and long routes the fourth pair of every ten is unrelated and
has a tight X-drop (error 1) and the eighth a narrow ladder width (error
2), as chip_smoke.py's parity phases have them.

The oracle is talco_np.align_freq for short pairs. Long and wide pairs are
held to the native host kernel (talco_host.align_freq), which the repo's
tests hold bit-equal to talco_np: the NumPy oracle takes minutes a 30 kb
pair. Each pair's error code must equal the oracle's and, where both give a
path, its length and every byte. Every mismatch is printed with its seed,
route, mode and index. Exit 0 when every pair matches, 1 otherwise.

--device cpu runs the kernel's plain PyTorch version (the wrapper on CPU
tensors) in its place and says so; short pairs are then at most 200
columns (fuzz_g8 caps its --interpret runs likewise: the plain version
takes seconds a pair at 2048). The default, cuda, exits 1 without a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROUTES = ("short", "long", "wide")
CPU_SHORT_MAX = 200          # short pairs' columns on --device cpu
WIDE_WIDTHS = (8192, 16384)
_TAG = "[fuzz_talco]"


def _cases(rng, route, p, leaf, n, short_max):
    """(prepared, metas, ladder widths, X-drops) of n pairs of the route."""
    from twilight_tpu_torch.tools import talco_inputs as ti
    prepared, metas, flen, xdrop = [], [], [], []
    for t in range(n):
        kind = t % 10
        if route == "wide":
            prep, meta = ti.make_pair(rng, p, False,
                                      int(rng.integers(4300, 5200)),
                                      related=t % 3 != 2, cap=6000)
            xd, fl = ti.WIDE_XDROP, 4096
        else:
            if route == "short":
                length = int(np.exp(rng.uniform(np.log(30),
                                                np.log(short_max))))
                prep, meta = ti.make_pair(rng, p, leaf, length,
                                          related=kind != 3)
            else:
                prep, meta = ti.long_pair(rng, p, leaf, 2049, 32768,
                                          related=kind != 3)
            # unrelated pairs with a tight X-drop collapse the band (error
            # 1); a narrow ladder width overflows it (error 2)
            xd = int(rng.integers(60, 200)) if kind == 3 else 5000
            fl = int(rng.integers(4, 24)) if kind == 7 else 4096
        prepared.append(prep)
        metas.append(meta)
        flen.append(fl)
        xdrop.append(xd)
    return prepared, metas, flen, xdrop


def fuzz(route="short", n=32, seed=0, paths=("nt", "protein"),
         modes=("freq", "leaf"), marker=1024, device="cuda", pool=None):
    """Runs the fuzz; returns its summary (the pairs, their runs through
    the kernel, mismatches, error codes by count, launches). `pool` holds
    the oracle's workers (None: in this process). Needs a CUDA device on
    "cuda"."""
    import torch
    from twilight_tpu_torch.config import Params
    from twilight_tpu_torch.ops import device_kernel as dk
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.tools import talco_inputs as ti
    if route not in ROUTES:
        raise ValueError(f"route {route!r}: want one of {ROUTES}")
    rng = np.random.default_rng(seed)
    short_max = 2048 if device == "cuda" else CPU_SHORT_MAX
    jobs, kern = [], []
    launches = pairs = 0
    t0 = time.time()
    for path in paths:
        p = 6 if path == "nt" else 22
        param = Params.make("n" if p == 6 else "p")
        for mode in modes:
            leaf = mode == "leaf"
            if leaf and route == "wide":
                continue
            prepared, metas, flen, xdrop = _cases(rng, route, p, leaf, n,
                                                  short_max)
            pairs += n
            widths = [flen]
            if route == "wide":
                widths.append([WIDE_WIDTHS[i % 2] for i in range(n)])
            # freq pairs: the first half at task 0, the rest at task 1
            half = n - n // 2
            tasks = [(0, list(range(n)))] if leaf else [
                (0, list(range(half))), (1, list(range(half, n)))]
            rows, esz = (1, 1) if leaf else (talco_cuda.p8_of(p), 4)
            for task, idxs in tasks:
                idxs = sorted(idxs, key=lambda i: -sum(prepared[i][4]))
                for fl in widths:
                    for chunk, padlen in dk.split_launches(
                            idxs, prepared, fl, rows, esz, 128,
                            marker=marker):
                        st = ti.pack(chunk, prepared, metas, task, p, leaf,
                                     param, fl, xdrop, marker, padlen=padlen)
                        out, tail = ti.launch(torch, st, p, marker, device)
                        launches += 1
                        for bi, i in enumerate(chunk):
                            jobs.append({
                                "p": p, "leaf": leaf, "marker": marker,
                                "task": task, "prep": prepared[i],
                                "meta": metas[i], "flen": fl[i],
                                "xdrop": xdrop[i], "plain": False,
                                "native": route != "short"})
                            rl, ql = prepared[i][4]
                            key = (f"seed {seed} route {route} {path} {mode} "
                                   f"task {task} marker {marker} pair {i} "
                                   f"({rl} x {ql}, width {fl[i]}, X-drop "
                                   f"{xdrop[i]})")
                            kern.append((out[bi, :tail[bi, 0]].copy(),
                                         tail[bi].copy(), key))
    t_launch = time.time() - t0
    t0 = time.time()
    bad, _, errs, _ = ti.hold(kern, ti.host_refs(pool, jobs), "fuzz_talco")
    return {"route": route, "seed": seed, "marker": marker,
            "device": device,
            "engine": "CUDA kernel" if device == "cuda" else
            "plain version on CPU tensors",
            "oracle": "the NumPy oracle (talco_np)" if route == "short"
            else "the native host kernel (talco_host)",
            "pairs": pairs, "runs": len(jobs), "launches": launches,
            "mismatches": bad,
            "errors": {str(k): v for k, v in sorted(errs.items())},
            "launch_s": t_launch, "oracle_s": time.time() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fuzz the TALCO-XDrop kernel against the oracle (module "
                    "doc)")
    ap.add_argument("--n", type=int, default=32,
                    help="pairs per path and mode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paths", default="nt,protein",
                    help="comma list of nt and protein")
    ap.add_argument("--modes", default="freq,leaf",
                    help="comma list of freq and leaf")
    ap.add_argument("--marker", type=int, default=None,
                    help="convergence marker (tile span; default "
                         "talco_cuda.MARKER); small values make short "
                         "pairs span many tiles")
    ap.add_argument("--route", choices=ROUTES, default="short")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the kernel; cpu: its plain version")
    ap.add_argument("--workers", type=int,
                    default=max(1, min(8, os.cpu_count() or 1)),
                    help="processes for the oracle (1: this process)")
    args = ap.parse_args(argv)
    paths = [x for x in args.paths.split(",") if x]
    modes = [x for x in args.modes.split(",") if x]
    if not set(paths) <= {"nt", "protein"} or not set(modes) <= {"freq",
                                                                 "leaf"}:
        ap.error("--paths takes nt,protein and --modes freq,leaf")

    import torch
    from twilight_tpu_torch.ops import talco_cuda
    marker = talco_cuda.MARKER if args.marker is None else args.marker
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print(f"{_TAG} no CUDA device (torch.cuda.is_available() is "
                  "false); --device cpu runs the kernel's plain version",
                  file=sys.stderr)
            return 1
        print(f"{_TAG} device: {torch.cuda.get_device_name(0)}",
              file=sys.stderr)
    else:
        print(f"{_TAG} device: cpu: the kernel's plain PyTorch version "
              "(talco_align_reference) in place of the kernel; short pairs "
              f"of at most {CPU_SHORT_MAX} columns", file=sys.stderr)
    if args.route == "wide" and "leaf" in modes:
        print(f"{_TAG} wide route: leaf pairs never take a wider width; "
              "freq pairs only", file=sys.stderr)

    def run(pool):
        return fuzz(args.route, args.n, args.seed, paths, modes, marker,
                    args.device, pool)

    if args.workers > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                max_workers=args.workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            res = run(pool)
    else:
        res = run(None)
    print(json.dumps(res), flush=True)
    if res["mismatches"]:
        print(f"{_TAG} FAILED: {res['mismatches']} of {res['runs']} runs "
              f"differ from {res['oracle']}", file=sys.stderr)
        return 1
    print(f"{_TAG} OK: {res['runs']} runs of {res['pairs']} pairs "
          f"({args.route} route, "
          f"{res['engine']}) match {res['oracle']}; error codes "
          f"{res['errors']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
