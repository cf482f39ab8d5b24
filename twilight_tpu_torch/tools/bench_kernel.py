"""Kernel pairs per second on the card, by route: the port's counterpart of
tools/bench_kernel.py.

    python -m twilight_tpu_torch.tools.bench_kernel [--batch 128]
        [--len 1700] [--iters 5] [--leaf] [--protein]
        [--route short|long|wide] [--json] [--device cuda|cpu]

Packs --batch related pairs of about --len columns (tools/talco_inputs.py:
nt or protein, freq profiles or leaf letters) as the batcher packs them,
and times their launch with CUDA events (talco_inputs.timed: the mean of
--iters launches after a warm-up), once with the launch's one H2D copy of
its staging buffer and one D2H copy of its results (`ms_per_pair`; `value`
is pairs/s of it) and once resident (the kernel alone on inputs already on
the card). Routes:

- short: padlen 2048 (the TPU's K1/K2); --len defaults to 1700, the RNASim
  shape the JAX tool times, and to 400 with --protein;
- long: padlen above 2048 (K4); --len defaults to 30000 (the sars_20
  shape), 3000 with --protein; the batch is cut to the first launch the
  batcher makes of it (its staging and scratch budgets);
- wide: freq pairs of about --len columns (default 4750) at X-drop 60000
  and ladder widths 8192 and 16384 (K5).

Prints one JSON line (--json) or a summary on stderr. Its keys are the JAX
tool's where they mean the same thing (metric, value, unit, batch, len,
padlen, err_rate, ms_per_pair, ms_per_pair_resident, h2d_share,
us_per_diag: the resident launch over its longest pair's diagonals,
cells_per_s: DP cells in Mcells/s resident). In place of the TPU's
est_pct_vpu_peak it gives the H100's bound per pair (`bound_ms`, the larger
of the f32 operations over the f32 peak and the bytes over the memory
rate: talco_inputs.talco_bound) and its share of the resident time
(`bound_share`), with the card's name (`device`) and power limit
(`power_limit_w`, from nvidia-smi).

The JAX tool's --ablate, --compare, --compare-grp and --no-g8 name Pallas
variants that the port does not have and are not ported: two builds of the
kernel are timed in turns by tools/talco_ab.py, and the cost of each step
of a diagonal by tools/talco_profile.py.

--device cpu times the kernel's plain PyTorch version on CPU tensors by the
host clock under the metric plain_pairs_per_s_cpu, prints "device": "cpu",
and leaves every figure of a device (resident time, H2D share, bound,
power limit) null. The default, cuda, exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

ROUTES = ("short", "long", "wide")
WIDE_WIDTHS = (8192, 16384)
_TAG = "[bench_kernel]"


def default_len(route, protein):
    return {"short": 400 if protein else 1700,
            "long": 3000 if protein else 30000, "wide": 4750}[route]


def power_limit_w():
    """Card 0's power limit in W (nvidia-smi), None where it cannot say."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=60)
        return float(r.stdout.split()[0]) if r.returncode == 0 else None
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def bench(route="short", batch=128, length=None, iters=5, leaf=False,
          protein=False, device="cuda", seed=0):
    """Builds, warms and times one launch; returns the result line (module
    doc). Needs a CUDA device on "cuda"."""
    import torch
    from twilight_tpu_torch.config import Params
    from twilight_tpu_torch.ops import device_kernel as dk
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.tools import talco_inputs as ti
    if route not in ROUTES:
        raise ValueError(f"route {route!r}: want one of {ROUTES}")
    if route == "wide" and leaf:
        raise ValueError("leaf pairs never take a wide width")
    length = length or default_len(route, protein)
    if (route == "short") != (length <= 2048):
        raise ValueError(f"--len {length} is not on the {route} route")
    p = 22 if protein else 6
    param = Params.make("p" if protein else "n")
    rng = np.random.default_rng(seed)
    prepared, metas = [], []
    for _ in range(batch):
        if route == "long":
            prep, meta = ti.long_pair(rng, p, leaf, length - 40,
                                      length + 40)
        else:
            prep, meta = ti.make_pair(
                rng, p, leaf, int(rng.integers(max(30, length - 40),
                                               length + 40)),
                cap=2048 if route == "short" else 2 * length)
        prepared.append(prep)
        metas.append(meta)
    if route == "wide":
        flen = [WIDE_WIDTHS[i % 2] for i in range(batch)]
        xdrop = [ti.WIDE_XDROP] * batch
    else:
        flen, xdrop = [4096] * batch, [5000] * batch
    rows, esz = (1, 1) if leaf else (talco_cuda.p8_of(p), 4)
    idxs = sorted(range(batch), key=lambda i: -sum(prepared[i][4]))
    chunk, padlen = dk.split_launches(idxs, prepared, flen, rows, esz,
                                      batch)[0]
    b = len(chunk)
    st = ti.pack(chunk, prepared, metas, 0, p, leaf, param, flen, xdrop,
                 talco_cuda.MARKER, pin=device == "cuda", padlen=padlen)
    if device == "cuda":
        prod, resid, _, tail = ti.launch_times(torch, st, p, b, padlen,
                                               iters)
    else:
        walls = []
        for _ in range(iters):
            t0 = time.perf_counter()
            _, tail = ti.launch(torch, st, p, talco_cuda.MARKER, "cpu")
            walls.append(time.perf_counter() - t0)
        prod, resid = float(np.mean(walls)) * 1e3, None
    cells = int(tail[:, 2].astype(np.int64).sum())
    diags = int(tail[:, 3].max())
    timed_ms = prod if resid is None else resid
    res = {"metric": "kernel_pairs_per_s_chip" if device == "cuda"
           else "plain_pairs_per_s_cpu",
           "value": b / (prod * 1e-3), "unit": "pairs/s", "route": route,
           "leaf": leaf, "protein": protein, "batch": b, "len": length,
           "padlen": padlen, "iters": iters,
           "err_rate": float(np.mean(tail[:, 1] != 0)),
           "ms_per_pair": prod / b,
           "ms_per_pair_resident": None if resid is None else resid / b,
           "h2d_share": None if resid is None else 1.0 - resid / prod,
           "us_per_diag": 1e3 * timed_ms / max(diags, 1),
           "cells_per_s": cells / (timed_ms * 1e-3) / 1e6,
           "cells_unit": "Mcells/s", "dp_cells": cells,
           "bound_ms": None, "bound_by": None, "bound_share": None,
           "device": "cpu", "power_limit_w": None}
    if device == "cuda":
        bound = {"dp_cells": cells, "h2d_bytes": int(st.buf.numel()),
                 "ms_per_pair_resident": resid / b}
        ti.talco_bound(bound, f"{'protein' if protein else 'nt'} "
                              f"{'leaf' if leaf else 'freq'}", b, padlen)
        res.update(bound_ms=bound["bound_ms_per_pair"],
                   bound_by=bound["bound_by"],
                   bound_share=bound["roofline_share"],
                   device=torch.cuda.get_device_name(0),
                   power_limit_w=power_limit_w())
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="TALCO-XDrop kernel pairs/s by route (module doc)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--len", type=int, dest="length", default=None,
                    help="columns a pair (default by route: module doc)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--leaf", action="store_true",
                    help="the leaf route (letter codes)")
    ap.add_argument("--protein", action="store_true",
                    help="protein pairs (BLOSUM62, 24 rows a freq profile)")
    ap.add_argument("--route", choices=ROUTES, default="short")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the kernel; cpu: its plain version")
    args = ap.parse_args(argv)
    if args.batch < 1 or args.iters < 1:
        ap.error("--batch and --iters must be positive")
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print(f"{_TAG} no CUDA device (torch.cuda.is_available() is "
              "false); --device cpu times the kernel's plain version",
              file=sys.stderr)
        return 1
    try:
        res = bench(args.route, args.batch, args.length, args.iters,
                    args.leaf, args.protein, args.device)
    except ValueError as e:
        ap.error(str(e))
    if args.json:
        print(json.dumps(res), flush=True)
    else:
        print(f"{_TAG} {res['route']} route on {res['device']}: "
              f"{res['value']:.1f} pairs/s ({res['ms_per_pair']:.4f} "
              f"ms/pair, batch {res['batch']}, ~{res['len']} columns, "
              f"padlen {res['padlen']}); {res['us_per_diag']:.3f} us a "
              f"diagonal; {res['cells_per_s']:.1f} Mcells/s", file=sys.stderr)
        if res["bound_ms"] is not None:
            print(f"{_TAG} resident {res['ms_per_pair_resident']:.4f} "
                  f"ms/pair, H2D share {res['h2d_share']:.3f}; bound "
                  f"{res['bound_ms']:.6f} ms/pair ({res['bound_by']}), "
                  f"{100 * res['bound_share']:.2f}% of it; power limit "
                  f"{res['power_limit_w']} W", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
