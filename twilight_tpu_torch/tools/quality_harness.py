"""SP score of the port's user paths against the simulator's true tree: the
port's counterpart of tools/quality_harness.py.

    python -m twilight_tpu_torch.tools.quality_harness [-n 600] [-l 600]
        [--seed 2] [--backbone-frac 0.8] [--iters 2] [--backend auto]
        [--type n] [-d DIR] [--json]

Simulates sequences along a known tree (tools/simulate.py) and scores each
strategy's alignment of the same sequences by its sum-of-pairs score per
pair of rows (tools/sp_score.py), so that the columns compare directly:

  true-tree     the command line with the simulator's tree (the ceiling)
  place-w-tree  a backbone (all rows but every step-th, step from
                --backbone-frac) aligned on the true tree; the other rows
                added with -a backbone -t tree (PLACE_W_TREE)
  graft         the same backbone; the other rows placed by the workflow's
                nearest-leaf grafting (workflow/placement.run_placement),
                no tree given
  iterative     the iterative workflow from the raw sequences
                (workflow/iterative.run_iterative, built-in guide trees)
  iterative-<tool>  the same with an external tree tool (fasttree,
                rapidnj, iqtree) when it is on PATH

Each strategy also reports the md5 of its output and the kernel launches
of its own runs (the backbone's alignment is reported once, as
"backbone"), so that a run on the card can be held to a --backend native
run byte for byte and not only by its score.

--backend defaults to auto, which is the card; without one the harness
exits 1 with the command line's message (cli.resolve_backend). native,
numpy and cpu (the kernel's plain version on CPU tensors) ask for the
host. The JAX tool defaults to native.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time

from .. import cli
from ..config import Params
from ..seqio.fasta import iter_fasta
from . import simulate
from .sp_score import sp_score

TREE_TOOLS = ("fasttree", "FastTree", "rapidnj", "iqtree")


def _read(path):
    return [(n, s) for n, _, s in iter_fasta(path)]


def _write(path, records):
    with open(path, "w") as f:
        for n, s in records:
            f.write(f">{n}\n{s}\n")


def _sp(path, type_):
    """SP score per pair of rows."""
    rows = [s for _, s in _read(path)]
    n = len(rows)
    return sp_score(rows, type_, Params.make(type_)) / (n * (n - 1) / 2)


def _md5(path):
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def _twilight(argv):
    """One run of the port's command line; its kernel launches."""
    rc, kernel = cli.run(argv)
    if rc != 0:
        raise RuntimeError(f"twilight-tpu-torch failed: {' '.join(argv)}")
    return kernel.stats["launches"] if kernel else 0


def _launches(steps):
    return sum(s.get("launches", 0) for s in steps)


def run(n=600, length=600, seed=2, backbone_frac=0.8, iters=2,
        backend="auto", type_="n", workdir=None):
    """Runs every strategy; returns the result (module doc). auto without a
    CUDA device raises RuntimeError."""
    from ..workflow.iterative import run_iterative
    from ..workflow.placement import run_placement
    backend = cli.resolve_backend(backend)
    with contextlib.ExitStack() as stack:
        wd = workdir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="twq_"))
        os.makedirs(wd, exist_ok=True)
        prefix = os.path.join(wd, "sim")
        simulate.main(["-n", str(n), "-l", str(length), "--seed", str(seed),
                       "--type", type_, "-o", prefix])
        all_fa, true_nwk = prefix + ".fa", prefix + ".nwk"
        records = _read(all_fa)
        step = max(2, int(round(1.0 / max(1e-9, 1.0 - backbone_frac))))
        backbone = [r for i, r in enumerate(records) if i % step != 0]
        query = [r for i, r in enumerate(records) if i % step == 0]
        bb_fa = os.path.join(wd, "backbone.fa")
        q_fa = os.path.join(wd, "query.fa")
        _write(bb_fa, backbone)
        _write(q_fa, query)
        common = ["--overwrite", "--backend", backend]
        if type_ == "p":
            common += ["--type", "p"]
        outs, walls, launches = {}, {}, {}

        # the ceiling: the true tree, all sequences
        t0 = time.time()
        outs["true-tree"] = os.path.join(wd, "true.aln")
        launches["true-tree"] = _twilight(
            ["-t", true_nwk, "-i", all_fa, "-o", outs["true-tree"]] + common)
        walls["true-tree"] = time.time() - t0

        # the backbone MSA on the true (auto-pruned) tree
        bb_aln = os.path.join(wd, "backbone.aln")
        bb_launches = _twilight(["-t", true_nwk, "-i", bb_fa, "-o", bb_aln]
                                + common)

        # the queries added with the true tree (PLACE_W_TREE)
        t0 = time.time()
        outs["place-w-tree"] = os.path.join(wd, "pwt.aln")
        launches["place-w-tree"] = _twilight(
            ["-a", bb_aln, "-i", q_fa, "-t", true_nwk, "-o",
             outs["place-w-tree"]] + common)
        walls["place-w-tree"] = time.time() - t0

        # nearest-leaf grafting, no tree given
        t0 = time.time()
        outs["graft"] = os.path.join(wd, "graft.aln")
        launches["graft"] = _launches(run_placement(
            q_fa, bb_aln, outs["graft"], None, iters,
            os.path.join(wd, "graft_tmp"), type_, backend, [], False))
        walls["graft"] = time.time() - t0

        # the iterative workflow from raw sequences, built-in trees
        t0 = time.time()
        outs["iterative"] = os.path.join(wd, "iter.aln")
        launches["iterative"] = _launches(run_iterative(
            all_fa, outs["iterative"], iters, os.path.join(wd, "iter_tmp"),
            type_, backend, [], False, tree_tool="builtin"))
        walls["iterative"] = time.time() - t0

        # external tree tools, where present
        for tool in TREE_TOOLS:
            if shutil.which(tool):
                key = f"iterative-{tool.lower()}"
                t0 = time.time()
                outs[key] = os.path.join(wd, key + ".aln")
                launches[key] = _launches(run_iterative(
                    all_fa, outs[key], iters,
                    os.path.join(wd, key + "_tmp"), type_, backend, [],
                    False, tree_tool=tool.lower()))
                walls[key] = time.time() - t0

        scores = {k: _sp(path, type_) for k, path in outs.items()}
        ceiling = scores["true-tree"]
        table = {k: {"sp_per_pair": round(v, 2),
                     "pct_of_true_tree": round(100.0 * v / ceiling, 2),
                     "wall_s": walls[k], "md5": _md5(outs[k]),
                     "launches": launches[k]}
                 for k, v in scores.items()}
        return {"n": n, "l": length, "seed": seed, "backend": backend,
                "backbone_rows": len(backbone), "query_rows": len(query),
                "backbone": {"md5": _md5(bb_aln), "launches": bb_launches},
                "results": table}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="SP score of each strategy against the true tree "
                    "(module doc)")
    ap.add_argument("-n", type=int, default=600)
    ap.add_argument("-l", type=int, default=600)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--backbone-frac", type=float, default=0.8)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--backend", choices=cli.BACKENDS, default="auto")
    ap.add_argument("--type", choices=["n", "p"], default="n")
    ap.add_argument("-d", "--workdir", default=None,
                    help="keep the sets and alignments here (default: a "
                         "temporary directory, removed at the end)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    try:
        res = run(args.n, args.l, args.seed, args.backbone_frac, args.iters,
                  args.backend, args.type, args.workdir)
    except RuntimeError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(res), flush=True)
    else:
        print(f"n={res['n']} l={res['l']} seed={res['seed']} backend="
              f"{res['backend']} backbone={res['backbone_rows']} query="
              f"{res['query_rows']}", file=sys.stderr)
        for k, v in res["results"].items():
            print(f"  {k:18s} SP/pair {v['sp_per_pair']:10.2f}  "
                  f"{v['pct_of_true_tree']:6.2f}% of true-tree  "
                  f"({v['wall_s']:.3f} s, md5 {v['md5']}, {v['launches']} "
                  "launches)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
