"""Top-level mode drivers: default, merge, placement (with/without tree).

Reference: TWILIGHT src/twilight-main.cpp:121-312.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

from .. import trace
from ..config import (DEFAULT_ALN, MERGE_MSA, PLACE_W_TREE, PLACE_WO_TREE,
                      Options, Params)
from ..core.seqdb import SequenceDB
from ..phylo.partition import (PartitionInfo, construct_tree_from_partitions,
                               update_subroot_info)
from ..phylo.stdorder import OrderedStrSet
from ..phylo.tree import Tree
from ..seqio import reader, writer
from ..seqio.fasta import iter_fasta
from . import progressive
from .placement import get_placement_tree


def run(option: Options, param: Params, kernel=None,
        prune: bool = False, write_prune: bool = False) -> None:
    database = SequenceDB()
    if option.aln_mode == DEFAULT_ALN:
        run_default(database, option, param, kernel, prune, write_prune)
    elif option.aln_mode == MERGE_MSA:
        run_merge(database, option, param, kernel)
    elif option.aln_mode == PLACE_WO_TREE:
        run_place_wo_tree(database, option, param, kernel)
    elif option.aln_mode == PLACE_W_TREE:
        run_place_w_tree(database, option, param, kernel)


def _ckpt_paths(option: Options, subtree: int):
    sub = os.path.join(option.temp_dir,
                       f"subtree-{subtree}.subalignment.aln")
    state = os.path.join(option.temp_dir, f"subtree-{subtree}.state.npz")
    return sub, state


def _save_subtree_checkpoint(option: Options, meta_node, subtree: int
                             ) -> None:
    """Persist the merge-phase state of one finished subtree: root profile
    + lengths (the subalignment FASTA in temp_dir is the other half — the
    reference's temp files are only a de-facto restart point, SURVEY §5;
    here they become a real checkpoint)."""
    import numpy as np
    _, state = _ckpt_paths(option, subtree)
    np.savez(state,
             msa_freq=meta_node.msa_freq,
             aln_len=meta_node.aln_len,
             aln_num=meta_node.aln_num,
             aln_weight=meta_node.aln_weight)


def _register_subtree_state(database: SequenceDB, option: Options,
                            meta_node, subtree: int, state: dict) -> None:
    """Attach a finished subtree's root state (computed elsewhere — another
    host, or a previous run's checkpoint) to the merge meta-tree."""
    import numpy as np
    sub, _ = _ckpt_paths(option, subtree)
    meta_node.seqs_included.append(subtree)
    meta_node.msa_freq = np.asarray(state["msa_freq"])
    meta_node.aln_len = int(state["aln_len"])
    meta_node.aln_num = int(state["aln_num"])
    meta_node.aln_weight = float(state["aln_weight"])
    database.subtree_aln[subtree] = np.zeros(meta_node.aln_len,
                                             dtype=np.int8)
    database.sub_aln_files.append((sub, subtree))


def _load_subtree_checkpoint(database: SequenceDB, option: Options,
                             meta_node, subtree: int) -> bool:
    import numpy as np
    sub, state = _ckpt_paths(option, subtree)
    if option.compressed and not os.path.exists(sub):
        sub += ".gz"
    if not (os.path.exists(sub) and os.path.exists(state)):
        return False
    _register_subtree_state(database, option, meta_node, subtree,
                            np.load(state))
    return True


def _partition(tree, option: Options):
    """(tree, its partition under --max-subtree, the meta-tree of the
    partitions, whether there is more than one)."""
    with trace.span("tree.partition"):
        partition = PartitionInfo(option.max_subtree)
        partition.partition_tree(tree.root)
        sub_root_t = construct_tree_from_partitions(tree.root, partition)
    multi = len(partition.partitions_root) > 1
    if multi:
        print(f"Decomposed the tree into "
              f"{len(partition.partitions_root)} subtrees.", file=sys.stderr)
    return tree, partition, sub_root_t, multi


def _store_subtree(database: SequenceDB, option: Options, sub_t, sub_root_t,
                   subtree: int, checkpoint_node=None) -> None:
    """A finished subtree's root profile into the meta-tree (and into its
    checkpoint, given the meta-tree's node) and its rows into its
    subalignment file; the rows then leave memory."""
    database.store_subtree_profile(sub_t, option.type, subtree)
    writer.write_sub_alignments(database, option, subtree,
                                sub_t.root.aln_len)
    update_subroot_info(sub_root_t.all_nodes[sub_t.root.identifier],
                        sub_t, subtree)
    if checkpoint_node is not None:
        _save_subtree_checkpoint(option, checkpoint_node, subtree)
    database.clean_subtree_db()


def _write_final(database: SequenceDB, option: Options, aln_len: int
                 ) -> None:
    """The output file of a run without subtrees."""
    t_out0 = time.time()
    with trace.span("io.write"):
        writer.write_final_msa(database, option, aln_len)
    out_name = option.out_file + ".gz" if option.compressed \
        else option.out_file
    print(f"Wrote alignment to {out_name} in "
          f"{(time.time() - t_out0) * 1e3:.0f} ms", file=sys.stderr)


def _write_merged(database: SequenceDB, option: Options, aln_len: int
                  ) -> int:
    """The output file of the merged subalignments; the sequences it
    holds."""
    with trace.span("io.write"):
        total_seqs = writer.update_and_write_alignments(database, option)
        writer.write_final_msa(database, option, aln_len)
    return total_seqs


def run_default(database: SequenceDB, option: Options, param: Params,
                kernel=None, prune: bool = False,
                write_prune: bool = False) -> None:
    with trace.span("io.tree"):
        tree = Tree.from_newick_file(option.tree_file)
        if prune:
            names = OrderedStrSet()
            for n, _, _ in iter_fasta(option.seq_file):
                names.add(n)
            tree = tree.prune(set(iter(names)))
    if prune and write_prune:
        with trace.span("io.write"):
            writer.write_pruned_tree(tree, option)
    tree, partition, sub_root_t, multi = _partition(tree, option)
    if multi and option.host_id == 0:
        with trace.span("io.write"):
            writer.write_subtrees(tree, partition, option)

    # multi-host: deterministic balanced assignment of subtrees to hosts
    # (the reference runs them serially — twilight-main.cpp:139-176)
    my_subtrees = None
    if multi and option.n_hosts > 1:
        from ..parallel.distributed import assign_subtrees
        sizes = [(name, cnt)
                 for name, (_, cnt) in partition.partitions_root.items()]
        my_subtrees = set(
            assign_subtrees(sizes, option.n_hosts)[option.host_id])
        print(f"Host {option.host_id}/{option.n_hosts}: "
              f"{len(my_subtrees)} subtrees.", file=sys.stderr)

    t_all0 = time.time()
    proceeded = 0
    n_parts = len(partition.partitions_root)
    for name, (node, _) in partition.partitions_root.items():
        t_sub0 = time.time()
        proceeded += 1
        subtree = tree.all_nodes[name].grp_id if multi else -1
        if my_subtrees is not None and name not in my_subtrees:
            continue
        if multi and option.resume:
            with trace.span("io.read"):
                resumed = _load_subtree_checkpoint(
                    database, option, sub_root_t.all_nodes[name], subtree)
            if resumed:
                print(f"Resumed subtree {subtree} from checkpoint.",
                      file=sys.stderr)
                continue
        if multi:
            print(f"Start processing subalignment No. {subtree}. "
                  f"({proceeded}/{n_parts})", file=sys.stderr)
        with trace.span("subtree") if multi else contextlib.nullcontext():
            with trace.span("tree.subtree"):
                sub_t = Tree.from_subtree(node, option.reroot)
            with trace.span("io.read"):
                sub_t = reader.read_sequences(option.seq_file, database,
                                              option, sub_t, subtree)
            progressive.msa_on_subtree(sub_t, database, option, param,
                                       kernel=kernel, subtree=subtree)
            if option.debug:
                database.debug_check()
            if multi:
                t_store0 = time.time()
                with trace.span("subtree.store"):
                    _store_subtree(database, option, sub_t, sub_root_t,
                                   subtree, sub_root_t.all_nodes[name])
                print(f"Stored the subalignments in "
                      f"{(time.time() - t_store0) * 1e3:.0f} ms.",
                      file=sys.stderr)
            else:
                _write_final(database, option, sub_t.root.aln_len)
        if multi:
            print(f"Finished subalignment No.{subtree} in "
                  f"{int(time.time() - t_sub0)} s", file=sys.stderr)
        else:
            print(f"Finished the alignment in {int(time.time() - t_sub0)} s",
                  file=sys.stderr)

    if multi:
        print(f"Finished all subalignments in {int(time.time() - t_all0)} "
              "s.", file=sys.stderr)
        with trace.span("merge"):
            _merge_subtrees(database, option, param, kernel, tree,
                            partition, sub_root_t, my_subtrees)


def _merge_subtrees(database: SequenceDB, option: Options, param: Params,
                    kernel, tree, partition, sub_root_t, my_subtrees
                    ) -> None:
    """The meta-tree merge of run_default's subtrees, on host 0 once the
    other hosts' root states are in."""
    if option.n_hosts > 1:
        from ..parallel import distributed
        if distributed.distributed_live():
            # a torch.distributed group: all-gather root states over
            # gloo instead of polling the shared filesystem
            # (collective — every host participates, then non-zero
            # hosts exit)
            local = {}
            for name in (my_subtrees or ()):
                meta = sub_root_t.all_nodes[name]
                local[tree.all_nodes[name].grp_id] = dict(
                    msa_freq=meta.msa_freq, aln_len=meta.aln_len,
                    aln_num=meta.aln_num, aln_weight=meta.aln_weight)
            print(f"Host {option.host_id}: exchanging "
                  f"{len(local)} subtree states by all-gather.",
                  file=sys.stderr)
            gathered = distributed.exchange_subtree_states_collective(
                local)
            if option.host_id != 0:
                return  # host 0 runs the merge
            for name in partition.partitions_root:
                subtree = tree.all_nodes[name].grp_id
                meta = sub_root_t.all_nodes[name]
                if not meta.seqs_included:  # another host's subtree
                    if subtree not in gathered:
                        raise RuntimeError(
                            f"no host produced subtree {subtree}")
                    _register_subtree_state(database, option, meta,
                                            subtree, gathered[subtree])
        else:
            if option.host_id != 0:
                return  # host 0 runs the merge
            all_ids = [tree.all_nodes[name].grp_id
                       for name in partition.partitions_root]
            print(f"Host 0: waiting for {len(all_ids)} subtree "
                  "checkpoints in the shared temp dir.",
                  file=sys.stderr)
            distributed.exchange_subtree_states(option, all_ids)
            for name in partition.partitions_root:
                subtree = tree.all_nodes[name].grp_id
                meta = sub_root_t.all_nodes[name]
                if not meta.seqs_included:  # processed on another host
                    ok = _load_subtree_checkpoint(database, option,
                                                  meta, subtree)
                    if not ok:
                        raise RuntimeError(
                            f"missing checkpoint for subtree {subtree}")
    database.current_task = 2
    progressive.msa_on_subtree(sub_root_t, database, option, param,
                               kernel=kernel)
    t_out0 = time.time()
    total_seqs = _write_merged(database, option, sub_root_t.root.aln_len)
    out_name = option.out_file + ".gz" if option.compressed \
        else option.out_file
    print(f"Wrote {len(sub_root_t.all_nodes)} subalignments (total "
          f"{total_seqs} sequences) to {out_name} in "
          f"{(time.time() - t_out0) * 1e3:.0f} ms", file=sys.stderr)


def run_merge(database: SequenceDB, option: Options, param: Params,
              kernel=None) -> None:
    with trace.span("io.read"):
        tree = reader.read_alignments_and_build_tree(database, option)
    database.current_task = 2
    with trace.span("merge"):
        progressive.msa_on_subtree(tree, database, option, param,
                                   kernel=kernel)
    t_out0 = time.time()
    total_seqs = _write_merged(database, option, tree.root.aln_len)
    out_name = option.out_file + ".gz" if option.compressed \
        else option.out_file
    print(f"Wrote {len(tree.all_nodes)} Alignments (total {total_seqs} "
          f"sequences) to {out_name} in {(time.time() - t_out0) * 1e3:.0f} "
          "ms", file=sys.stderr)


def run_place_wo_tree(database: SequenceDB, option: Options, param: Params,
                      kernel=None) -> None:
    database.current_task = 2
    with trace.span("io.read"):
        names = OrderedStrSet()
        for n, _, _ in iter_fasta(option.seq_file):
            names.add(n)
        tree = Tree.star_tree(names)
        reader.read_sequences(option.seq_file, database, option, tree)
        reader.read_backbone_alignment(tree, database, option)
    progressive.msa_on_subtree(tree, database, option, param, kernel=kernel)
    if option.debug:
        database.debug_check()
    t_bb0 = time.time()
    with trace.span("io.write"):
        writer.update_and_write_alignment(database, option,
                                          option.backbone_aln_file, -1)
    print(f"Updated and wrote backbone alignment in "
          f"{(time.time() - t_bb0) * 1e3:.0f} ms", file=sys.stderr)
    t_out0 = time.time()
    stem = os.path.splitext(os.path.basename(option.seq_file))[0]
    placed_path = os.path.join(option.temp_dir, stem + ".final.aln")
    with trace.span("io.write"):
        writer.write_alignment_db(placed_path, database, tree.root.aln_len,
                                  option.compressed)
        writer.write_final_msa(database, option, tree.root.aln_len)
    out_name = option.out_file + ".gz" if option.compressed \
        else option.out_file
    print(f"Wrote placed sequences and backbone alignment (total "
          f"{tree.root.aln_num} sequences) to {out_name} in "
          f"{(time.time() - t_out0) * 1e3:.0f} ms", file=sys.stderr)


def run_place_w_tree(database: SequenceDB, option: Options, param: Params,
                     kernel=None) -> None:
    with trace.span("io.tree"):
        tree = Tree.from_newick_file(option.tree_file)
    tree, partition, sub_root_t, multi = _partition(tree, option)
    if multi:
        with trace.span("io.write"):
            writer.write_subtrees(tree, partition, option)

    t_all0 = time.time()
    proceeded = 0
    n_parts = len(partition.partitions_root)
    for name, (node, _) in partition.partitions_root.items():
        t_sub0 = time.time()
        proceeded += 1
        subtree = tree.all_nodes[name].grp_id
        if multi:
            print(f"Start processing subalignment No. {subtree}. "
                  f"({proceeded}/{n_parts})", file=sys.stderr)
        with trace.span("subtree") if multi else contextlib.nullcontext():
            with trace.span("tree.subtree"):
                sub_t = Tree.from_subtree(node, reroot=False)
            with trace.span("io.read"):
                sub_t = reader.read_sequences(option.backbone_aln_file,
                                              database, option, sub_t)
                sub_t = reader.read_sequences(option.seq_file, database,
                                              option, sub_t)
            with trace.span("tree.subtree"):
                if option.reroot:
                    sub_t.reroot(placement=True)
                placement_t = get_placement_tree(sub_t, database)
            progressive.msa_on_subtree(placement_t, database, option, param,
                                       kernel=kernel)
            with trace.span("root_update"):
                sub_t.extract_result(placement_t)
            if option.debug:
                database.debug_check()
            if multi:
                t_store0 = time.time()
                with trace.span("subtree.store"):
                    _store_subtree(database, option, sub_t, sub_root_t,
                                   subtree)
                print(f"Stored the subalignments in "
                      f"{(time.time() - t_store0) * 1e3:.0f} ms.",
                      file=sys.stderr)
            else:
                _write_final(database, option, sub_t.root.aln_len)
        if multi:
            print(f"Finished subalignment No.{subtree} in "
                  f"{int(time.time() - t_sub0)} s", file=sys.stderr)
        else:
            print(f"Finished the alignment in {int(time.time() - t_sub0)} s",
                  file=sys.stderr)

    if multi:
        print(f"Finished all subalignments in {int(time.time() - t_all0)} "
              "s.", file=sys.stderr)
        database.current_task = 2
        with trace.span("merge"):
            progressive.msa_on_subtree(sub_root_t, database, option, param,
                                       kernel=kernel)
        t_out0 = time.time()
        total_seqs = _write_merged(database, option, sub_root_t.root.aln_len)
        out_name = option.out_file + ".gz" if option.compressed \
            else option.out_file
        print(f"Wrote {len(sub_root_t.all_nodes)} subalignments (total "
              f"{total_seqs} sequences) to {out_name} in "
              f"{(time.time() - t_out0) * 1e3:.0f} ms", file=sys.stderr)
