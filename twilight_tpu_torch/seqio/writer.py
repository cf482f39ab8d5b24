"""Alignment writers, including the transitivity expansion of subalignments.

Reference: TWILIGHT src/io.cpp:313-566.
"""
from __future__ import annotations

import os
import shutil
import sys
from typing import List, Tuple

import numpy as np

from .. import trace
from ..config import DEFAULT_ALN, PLACE_WO_TREE, Options
from ..core.seqdb import SequenceDB
from .fasta import iter_fasta, write_fasta


def write_pruned_tree(tree, option: Options) -> None:
    out_dir = os.path.dirname(option.out_file)
    base = os.path.basename(option.tree_file) + ".pruned.nwk"
    path = base if out_dir == "" else os.path.join(out_dir, base)
    with open(path, "w") as f:
        f.write(tree.get_newick_string() + "\n")


def write_subtrees(tree, partition, option: Options) -> None:
    """One Newick per partition (reference io.cpp:328-345)."""
    from ..phylo.tree import Tree
    for name, (node, _) in partition.partitions_root.items():
        subtree_idx = tree.all_nodes[name].grp_id
        sub = Tree.from_subtree(node, reroot=False)
        path = os.path.join(option.temp_dir, f"subtree-{subtree_idx}.nwk")
        with open(path, "w") as f:
            f.write(sub.get_newick_string() + "\n")


def write_alignment_db(file_name: str, database: SequenceDB, aln_len: int,
                       compressed: bool) -> None:
    """All non-low-quality sequences, input order (reference io.cpp:490-528)."""
    records = [(s.name, s.aln_str(aln_len)) for s in database.sequences
               if not s.low_quality]
    write_fasta(file_name, records, compressed)


def write_sub_alignments(database: SequenceDB, option: Options,
                         subtree_idx: int, aln_len: int) -> None:
    file_name = os.path.join(option.temp_dir,
                             f"subtree-{subtree_idx}.subalignment.aln")
    database.sub_aln_files.append((file_name, subtree_idx))
    write_alignment_db(file_name, database, aln_len, option.compressed)
    print(f"Subalignment Length: {aln_len}", file=sys.stderr)


def update_and_write_alignment(database: SequenceDB, option: Options,
                               file_name: str, subtree_idx: int) -> int:
    """Transitivity expansion: stream a subalignment file through its final
    merge path, inserting gaps (reference io.cpp:356-449). Returns the
    number of sequences written."""
    out_buff = 10000
    gap = "." if option.aln_mode == PLACE_WO_TREE else "-"
    if option.aln_mode == DEFAULT_ALN and option.compressed:
        file_name += ".gz"
    # fs::path::stem strips only the last extension
    stem = os.path.splitext(os.path.basename(file_name))[0]
    final_path = os.path.join(option.temp_dir, stem + ".final.aln")

    path = database.subtree_aln[subtree_idx]
    path_len = len(path)
    keep = np.asarray(path, dtype=np.int8) == 0
    pos = np.nonzero(keep)[0]

    total = 0
    nochange = False
    batch: List[Tuple[str, str]] = []

    def flush(first: bool):
        nonlocal total
        out = []
        gap_row = np.full(path_len, ord(gap), dtype=np.uint8)
        for name, seq in batch:
            row = gap_row.copy()
            src = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
            row[pos] = src[:len(pos)]
            out.append((name, row.tobytes().decode("latin-1")))
        write_fasta(final_path, out, option.compressed, append=not first)
        total += len(out)
        batch.clear()

    first = True
    for name, _, seq in iter_fasta(file_name):
        if len(seq) == path_len:
            nochange = True
            break
        batch.append((name, seq))
        if len(batch) == out_buff:
            flush(first)
            first = False
    if not nochange:
        flush(first)
    if option.aln_mode == PLACE_WO_TREE:
        print(f"Final Alignment Length: {path_len}", file=sys.stderr)
    database.subtree_aln[subtree_idx] = np.zeros(0, dtype=np.int8)
    if nochange:
        shutil.copy(file_name, final_path)
    if option.delete_temp and option.aln_mode == DEFAULT_ALN \
            and not option.resume:
        # under --resume the subalignment doubles as the subtree's
        # checkpoint payload (_load_subtree_checkpoint needs it): keep it
        # until the final concatenation so a crash during this merge
        # phase resumes without realigning finished subtrees; the temp
        # dir is removed wholesale at the end either way
        os.remove(file_name)
    return total


def update_and_write_alignments(database: SequenceDB, option: Options) -> int:
    import time
    total = 0
    proceeded = 0
    for file_name, subtree_idx in database.sub_aln_files:
        t0 = time.time()
        proceeded += 1
        total += update_and_write_alignment(database, option, file_name,
                                            subtree_idx)
        print(f"Finish writing alignment of subtree No. {subtree_idx}. "
              f"({proceeded}/{len(database.sub_aln_files)}) in "
              f"{(time.time() - t0) * 1e3:.0f} ms.", file=sys.stderr)
    return total


def write_final_msa(database: SequenceDB, option: Options, aln_len: int
                    ) -> None:
    """Reference io.cpp:465-488."""
    file_name = option.out_file
    if database.current_task == 2:
        if option.compressed:
            file_name += ".gz"
        # concatenate temp/*.final.aln* in glob (lexicographic) order
        parts = sorted(
            os.path.join(option.temp_dir, f)
            for f in os.listdir(option.temp_dir) if ".final.aln" in f)
        with open(file_name, "wb") as out:
            for p in parts:
                with open(p, "rb") as src:
                    shutil.copyfileobj(src, out)
                if option.delete_temp:
                    # the temp dir is removed right below anyway; freeing
                    # each part as it is consumed halves peak disk on
                    # million-sequence runs (output ~= sum of parts)
                    os.remove(p)
            trace.count("bytes_written", out.tell())
        if option.delete_temp:
            shutil.rmtree(option.temp_dir, ignore_errors=True)
        return
    if option.aln_mode != PLACE_WO_TREE:
        write_alignment_db(file_name, database, aln_len, option.compressed)
