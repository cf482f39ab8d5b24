"""Placement workflow: align to backbone -> place -> realign with tree.

Replicates the reference workflow's placement mode with NO external
binaries (TWILIGHT workflow/Snakefile:102-104, rules/placement.smk,
rules/twilight.smk twilight_place_at_root/_at_tips):

  iter 1   twilight PLACE_WO_TREE: align new sequences to the backbone
           MSA (reference rule twilight_place_at_root).
  place    native phylogenetic placement replacing epa-ng + gappa graft:
           for each placed sequence, the nearest backbone leaf by
           p-distance over shared alignment columns (one-hot matmuls — on
           the GPU under --backend cuda), grafted as a sibling of
           that leaf with split branch lengths (reference
           rules/placement.smk runs epa-ng then `gappa examine graft`).
  iter 2+  twilight PLACE_W_TREE with the grafted tree (reference rule
           twilight_place_at_tips), re-placing between iterations.

The reference rules shuttle separate placed/backbone FASTAs through the
work dir and `cat` them at the end; here each iteration's combined engine
output is split by sequence name in memory, which removes the dependence
on temp-file naming while producing the same row set.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..phylo.tree import Node, Tree
from ..seqio.fasta import iter_fasta
from ..trees import estimate
from .iterative import align, resolve

_TAG = "[twilight-tpu-torch]"


def _read_rows(path: str, keep=None) -> Tuple[List[str], np.ndarray]:
    names, rows = [], []
    for n, _, s in iter_fasta(path):
        if keep is not None and n not in keep:
            continue
        names.append(n)
        rows.append(np.frombuffer(s.upper().encode("latin-1"),
                                  dtype=np.uint8))
    return names, (np.stack(rows) if rows
                   else np.zeros((0, 0), dtype=np.uint8))


def _one_hot_valid(mat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[n, cols] bytes -> ([n, cols, 4] one-hot f32, [n, cols] valid f32).
    Gap ('-'), insertion fill ('.') and ambiguity letters are invalid."""
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    oh = (mat[:, :, None] == letters[None, None, :]).astype(np.float32)
    valid = oh.sum(axis=2)
    return oh, valid


def placement_counts(placed: np.ndarray, backbone: np.ndarray,
                     max_cols: int = 4096,
                     device: Optional[torch.device] = None):
    """(matches, both) f32 [q, b]: the columns where a query row and a
    backbone row hold the same letter of ACGT, and where both hold one,
    over at most max_cols subsampled columns. Two matmuls ([q, cols*4] @
    [b, cols*4]^T and [q, cols] @ [b, cols]^T) of 0/1 matrices: exact
    integers, on the card (`estimate.pair_counts_on`) when `device` is a
    CUDA device and the host estimate passes the gate, NumPy otherwise."""
    cols = placed.shape[1]
    if cols > max_cols:
        step = cols // max_cols + 1
        placed = placed[:, ::step]
        backbone = backbone[:, ::step]
    host_est_s = estimate.host_estimate_s(len(placed), len(backbone),
                                          placed.shape[1] * 5)
    if estimate.on_card(device, host_est_s):
        return estimate.pair_counts_on(placed, backbone, b"ACGT", device)
    q_oh, q_valid = _one_hot_valid(placed)
    b_oh, b_valid = _one_hot_valid(backbone)
    qf = q_oh.reshape(len(placed), -1)
    bf = b_oh.reshape(len(backbone), -1)
    return qf @ bf.T, q_valid @ b_valid.T


def nearest_backbone_leaves(placed_names: List[str], placed: np.ndarray,
                            backbone_names: List[str],
                            backbone: np.ndarray,
                            max_cols: int = 4096,
                            device: Optional[torch.device] = None
                            ) -> Dict[str, str]:
    """query name -> nearest backbone leaf name by p-distance over columns
    where both rows hold a concrete letter (`placement_counts`)."""
    matches, both = placement_counts(placed, backbone, max_cols, device)
    dist = 1.0 - matches / np.maximum(both, 1.0)
    dist[both < 1.0] = 2.0  # no shared columns: worst
    nearest = np.argmin(dist, axis=1)
    return {placed_names[i]: backbone_names[int(nearest[i])]
            for i in range(len(placed_names))}


def graft_queries(tree: Tree, placements: Dict[str, str]) -> None:
    """Attach each query as a sibling of its nearest backbone leaf (the
    native analogue of `gappa examine graft`): the leaf edge is split by a
    new internal node whose children are the leaf and the query, each with
    half the original branch length. Queries mapped to the same leaf chain
    below it (deterministic, insertion order)."""
    leaves: Dict[str, Node] = {}
    for node in tree.root.collect_post_order():
        if node.is_leaf():
            leaves[node.identifier] = node
    for query, leaf_name in placements.items():
        leaf = leaves[leaf_name]
        parent = leaf.parent
        bl = max(float(leaf.branch_length) / 2.0, 1e-9)
        # Node() auto-appends to a given parent; build detached and wire up
        joint = Node(tree.new_internal_id(), bl, None)
        qnode = Node(query, bl, None)
        qnode.parent = joint
        leaf.parent = joint
        leaf.branch_length = np.float32(bl)
        joint.children = [leaf, qnode]
        joint.parent = parent
        if parent is None:
            tree.root = joint
        else:
            parent.children = [joint if c is leaf else c
                               for c in parent.children]


def run_placement(seq_file: str, backbone_aln: str, out_file: str,
                  backbone_tree: Optional[str] = None, iterations: int = 2,
                  temp_dir: Optional[str] = None,
                  type_: Optional[str] = None, backend: str = "auto",
                  extra_args: Optional[List[str]] = None,
                  keep_temp: bool = False,
                  final_tool: Optional[str] = None) -> list:
    """Returns the steps, as run_iterative does: each alignment with its
    wall and kernel launches."""
    from ..trees import build_guide_tree

    if iterations < 1:
        raise ValueError("iterations must be >= 1")
    backend, device = resolve(backend)
    temp_dir = temp_dir or (os.path.splitext(out_file)[0] + "_place")
    os.makedirs(temp_dir, exist_ok=True)
    query_names = {n for n, _, _ in iter_fasta(seq_file)}
    steps: list = []

    common = ["--overwrite", "--backend", backend] + list(extra_args or [])
    if type_:
        common += ["--type", type_]

    # iteration 1: place at root (PLACE_WO_TREE)
    out1 = out_file if iterations == 1 else os.path.join(temp_dir,
                                                         "iter1.aln")
    align(["-i", seq_file, "-a", backbone_aln, "-o", out1,
           "-d", os.path.join(temp_dir, "iter1_tmp")] + common, steps,
          "align 1")
    if iterations == 1:
        _maybe_final_tree(out_file, final_tool, type_, device)
        return steps
    combined = out1

    # backbone tree: given (binarized like scripts/resolveTree.py), or
    # estimated from the backbone MSA with the built-in estimator
    if backbone_tree:
        tree = Tree.from_newick_file(backbone_tree)
        tree.convert_to_binary()
    else:
        bb_names, bb_rows = _read_rows(backbone_aln)
        newick = build_guide_tree(
            bb_names, [r.tobytes().decode("latin-1") for r in bb_rows],
            aligned=True, device=device)
        tree = Tree()
        tree.parse_newick(newick)
        tree.convert_to_binary()

    for it in range(2, iterations + 1):
        names, rows = _read_rows(combined)
        is_q = np.asarray([n in query_names for n in names])
        p_names = [n for n, q in zip(names, is_q) if q]
        b_names = [n for n, q in zip(names, is_q) if not q]
        t0 = time.time()
        placements = nearest_backbone_leaves(
            p_names, rows[is_q], b_names, rows[~is_q], device=device)
        steps.append({"step": f"place {it}", "s": time.time() - t0})
        grafted = Tree()
        grafted.parse_newick(tree.get_newick_string())
        graft_queries(grafted, placements)
        tree_path = os.path.join(temp_dir, f"tree_iter{it - 1}.nwk")
        with open(tree_path, "w") as f:
            f.write(grafted.get_newick_string() + "\n")
        print(f"{_TAG} placement iter {it}: grafted "
              f"{len(placements)} queries -> {tree_path}", file=sys.stderr)

        out_k = out_file if it == iterations else os.path.join(
            temp_dir, f"iter{it}.aln")
        align(["-i", seq_file, "-a", backbone_aln, "-t", tree_path,
               "-o", out_k] + common, steps, f"align {it}")
        combined = out_k

    _maybe_final_tree(out_file, final_tool, type_, device)
    if not keep_temp:
        import shutil
        shutil.rmtree(temp_dir, ignore_errors=True)
    return steps


def _maybe_final_tree(out_file: str, final_tool: Optional[str],
                      type_: Optional[str],
                      device: Optional[torch.device] = None) -> None:
    """Snakefile FINALTREE: a tree inferred from the final MSA, written
    to <out>.tree (workflow/Snakefile checkFiles target)."""
    if not final_tool:
        return
    from ..trees.external import guide_tree_auto
    names, rows = _read_rows(out_file)
    newick = guide_tree_auto(
        names, [r.tobytes().decode("latin-1") for r in rows],
        aligned=True, type_=type_ or "n", tool=final_tool, device=device)
    with open(out_file + ".tree", "w") as f:
        f.write(newick + "\n")
    print(f"{_TAG} final tree -> {out_file}.tree",
          file=sys.stderr)
