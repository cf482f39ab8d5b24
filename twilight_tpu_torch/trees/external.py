"""External tree-tool adapters with built-in fallback.

The reference workflow shells out to 9 tree tools through Snakemake rules
(TWILIGHT workflow/rules/{fasttree,rapidnj,iqtree,...}.smk), with
scripts/reduceLen.py masking gappy columns first and
scripts/resolveTree.py binarizing polytomies afterwards. This module is
the same capability as a library: probe PATH for a known tool, reproduce
its rule's invocation, binarize the result; callers fall back to the
built-in k-mer/NJ/PartTree estimator (trees/estimate.py) when no tool is
installed.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
from typing import List, Optional, Sequence

import numpy as np
import torch

_TAG = "[twilight-tpu-torch]"

# Probe order mirrors the reference's iter_tree/final_tree options
# (workflow/config.yaml:9-10); each entry lists the executables that
# count as that tool.
TOOL_BINARIES = {
    "fasttree": ["FastTreeMP", "fasttree", "FastTree", "veryfasttree",
                 "VeryFastTree"],
    "rapidnj": ["rapidnj"],
    "iqtree": ["iqtree2", "iqtree"],
    "raxml": ["raxmlHPC-PTHREADS", "raxmlHPC", "raxml"],
    "mafft": ["mafft"],          # rules/maffttree.smk (unaligned input)
    "parttree": ["mafft"],       # rules/parttree.smk (unaligned input)
    "mashtree": ["mashtree"],    # rules/mashtree.smk (unaligned input)
    "dipper": ["dipper"],        # rules/dipper_{init,iter}.smk
}
PROBE_ORDER = ["fasttree", "rapidnj", "iqtree", "raxml", "dipper"]
# tools that consume RAW sequences (initial-tree rules); the rest need an
# alignment. dipper is dual-mode: raw input for the initial tree
# (rules/dipper_init.smk, `-i r`) and MSA input between iterations
# (rules/dipper_iter.smk, `-i m`), so it appears in both probe orders.
UNALIGNED_TOOLS = {"mafft", "parttree", "mashtree", "dipper"}
UNALIGNED_PROBE_ORDER = ["mafft", "mashtree", "dipper"]
DUAL_MODE_TOOLS = {"dipper"}


def find_tool(preference: Optional[str] = None
              ) -> Optional[tuple]:
    """(tool_name, exe_path) for the preferred (or first) tool on PATH."""
    order = [preference] if preference and preference != "auto" \
        else PROBE_ORDER
    for tool in order:
        for exe in TOOL_BINARIES.get(tool, [tool]):
            path = shutil.which(exe)
            if path:
                return tool, path
    return None


def mask_gappy_columns(rows: Sequence[str], threshold: float = 0.95
                       ) -> List[str]:
    """Drop columns whose gap fraction >= threshold before tree inference
    (reference workflow/scripts/reduceLen.py)."""
    mat = np.frombuffer("".join(rows).encode("latin-1"),
                        dtype=np.uint8).reshape(len(rows), -1)
    is_gap = (mat == ord("-")) | (mat == ord("."))
    keep = is_gap.mean(axis=0) < threshold
    kept = mat[:, keep]
    return [bytes(r).decode("latin-1") for r in kept]


def _mafft_tree_to_newick(tree_file: str, names: Sequence[str],
                          parttree: bool = False) -> str:
    """MAFFT --treeout numeric-id tree -> Newick with sequence names
    (reference workflow/scripts/mafft2nwk.py semantics: default mode
    labels leaves `N_name`, parttree mode uses bare 1-based numbers)."""
    by_order = {i + 1: n for i, n in enumerate(names)}
    parts: List[str] = []
    with open(tree_file) as f:
        lines = f.read().splitlines()
    if parttree:
        for line in lines:
            if line.isdigit():
                parts.append(by_order[int(line)])
                continue
            num = ""
            for ch in line:
                if ch.isdigit():
                    num += ch
                else:
                    if num:
                        parts.append(by_order[int(num)])
                        num = ""
                    parts.append(ch)
            if num:
                parts.append(by_order[int(num)])
        return "".join(parts) + ";"
    for line in lines:
        cut = line.find("_")
        if cut == -1:
            parts.append(line)
        else:
            parts.append(by_order[int(line[:cut])])
    return "".join(parts)


def run_external_tree(tool: str, exe: str, names: Sequence[str],
                      rows: Sequence[str], type_: str = "n",
                      mask_gappy: float = 0.95, threads: int = 1,
                      aligned: Optional[bool] = None) -> str:
    """Run one aligned-MSA tree inference exactly like the reference's
    Snakemake rule for `tool`, returning a binarized Newick string."""
    from ..phylo.tree import Tree

    with tempfile.TemporaryDirectory(prefix="twtree_") as td:
        masked = os.path.join(td, "msa.mask.fa")
        use_rows = mask_gappy_columns(rows, mask_gappy) \
            if tool in ("fasttree", "iqtree", "raxml") else rows
        with open(masked, "w") as f:
            for n, s in zip(names, use_rows):
                f.write(f">{n}\n{s}\n")
        tree_path = os.path.join(td, "out.nwk")
        env = dict(os.environ, OMP_NUM_THREADS=str(threads))
        if tool == "fasttree":
            # rules/fasttree.smk: {exe} {model} -fastest masked > tree
            cmd = [exe] + (["-nt", "-gtr"] if type_ == "n" else []) \
                + ["-fastest", masked]
            with open(tree_path, "w") as out:
                subprocess.run(cmd, stdout=out, stderr=subprocess.DEVNULL,
                               env=env, check=True)
        elif tool == "rapidnj":
            # rules/rapidnj.smk: {exe} msa -i fa -o t -x tree -c threads
            subprocess.run([exe, masked, "-i", "fa", "-o", "t",
                            "-x", tree_path, "-c", str(threads)],
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, env=env, check=True)
        elif tool == "iqtree":
            # rules/iqtree.smk: {exe} -s masked {model} --threads-max n
            subprocess.run([exe, "-s", masked,
                            "--threads-max", str(threads)],
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, env=env, check=True)
            shutil.move(masked + ".treefile", tree_path)
        elif tool == "raxml":
            # rules/raxml.smk: reduceLen.py -> {exe} -s masked -m model
            #   -n raxml.tree -T n -p 235813 -> RAxML_bestTree.raxml.tree
            model = "GTRGAMMA" if type_ == "n" else "PROTGAMMABLOSUM62"
            subprocess.run([exe, "-s", masked, "-m", model,
                            "-n", "raxml.tree", "-T", str(threads),
                            "-p", "235813", "-w", td],
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, env=env, check=True)
            shutil.move(os.path.join(td, "RAxML_bestTree.raxml.tree"),
                        tree_path)
        elif tool in ("mafft", "parttree"):
            # rules/{maffttree,parttree}.smk: mafft --retree 0 --treeout
            #   [--parttree] --reorder --quiet; the numeric-id .tree file
            #   is converted to Newick with names (scripts/mafft2nwk.py)
            cmd = [exe, "--retree", "0", "--treeout"]
            if tool == "parttree":
                cmd.append("--parttree")
            cmd += ["--reorder", "--quiet", "--thread", str(threads),
                    masked]
            subprocess.run(cmd, stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, env=env, check=True)
            newick = _mafft_tree_to_newick(masked + ".tree", names,
                                           parttree=(tool == "parttree"))
            with open(tree_path, "w") as f:
                f.write(newick)
        elif tool == "mashtree":
            # rules/mashtree.smk: split into one FASTA per sequence, then
            #   mashtree --numcpus n --outtree out dir/*.fa
            split_dir = os.path.join(td, "split")
            os.makedirs(split_dir)
            fa_files = []
            for n, s in zip(names, rows):
                p = os.path.join(split_dir, f"{n}.fa")
                with open(p, "w") as f:
                    f.write(f">{n}\n{s}\n")
                fa_files.append(p)
            subprocess.run([exe, "--numcpus", str(threads),
                            "--outtree", tree_path] + fa_files,
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, env=env, check=True)
        elif tool == "dipper":
            # rules/dipper_{init,iter}.smk: -i r (raw) / m (MSA) -o t -m 1
            if aligned is None:
                aligned = bool(rows) and any("-" in r for r in rows[:64])
            mode = "m" if aligned else "r"
            subprocess.run([exe, "-i", mode, "-o", "t", "-m", "1",
                            "-I", masked, "-O", tree_path],
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, env=env, check=True)
        else:
            raise ValueError(f"unknown tree tool: {tool}")
        with open(tree_path) as f:
            newick = f.read().strip()

    # resolveTree.py equivalent: binarize polytomies
    t = Tree()
    t.parse_newick(newick)
    got = {n.identifier for n in t.root.collect_post_order()
           if n.is_leaf()}
    if got != set(names):
        # a tool that returns the wrong leaf set (crash, truncated
        # output, name mangling) must not silently drive an alignment
        # of the wrong sequences — raise so auto mode falls back to the
        # built-in estimator and an explicit request errors loudly
        missing = len(set(names) - got)
        raise RuntimeError(
            f"{tool} returned a tree over {len(got)} leaves, expected "
            f"{len(names)} ({missing} missing)")
    t.convert_to_binary()
    return t.get_newick_string()


def guide_tree_auto(names: Sequence[str], seqs: Sequence[str],
                    aligned: bool, type_: str = "n",
                    tool: str = "auto", threads: int = 1,
                    seed: int = 0,
                    device: Optional[torch.device] = None,
                    steps: Optional[list] = None) -> str:
    """Guide tree via an external tool when available, else the built-in
    estimator. Aligned input probes the MSA tools (fasttree/rapidnj/
    iqtree/raxml); unaligned input probes the initial-tree tools
    (mafft/mashtree/dipper — reference rules/{maffttree,parttree,
    mashtree,dipper_init}.smk). tool: 'auto' | 'builtin' | a
    TOOL_BINARIES key. device: where the built-in estimator's distance
    products may run (None: the host); steps: a list that gets its
    (name, seconds) steps."""
    from .estimate import build_guide_tree

    if tool != "builtin":
        if tool == "auto":
            order = PROBE_ORDER if aligned else UNALIGNED_PROBE_ORDER
        else:
            order = [tool]
        compatible = [t for t in order
                      if t in DUAL_MODE_TOOLS
                      or (t in UNALIGNED_TOOLS) != aligned]
        found = None
        for t in compatible:
            found = find_tool(t)
            if found:
                break
        if found:
            tname, exe = found
            try:
                print(f"{_TAG} tree inference via {tname} "
                      f"({exe})", file=sys.stderr)
                return run_external_tree(tname, exe, names, seqs, type_,
                                         threads=threads, aligned=aligned)
            except Exception as e:
                print(f"{_TAG} {tname} failed ({e}); using "
                      "built-in estimator", file=sys.stderr)
        elif tool != "auto":
            if tool in TOOL_BINARIES and not compatible:
                raise RuntimeError(
                    f"tree tool '{tool}' needs "
                    f"{'unaligned' if tool in UNALIGNED_TOOLS else 'aligned'}"
                    " input")
            raise RuntimeError(f"requested tree tool '{tool}' not on PATH")
    return build_guide_tree(names, seqs, aligned=aligned, seed=seed,
                            device=device, steps=steps)
