"""Progressive-alignment executor: level loop, root push, deferred realign.

Reference: TWILIGHT src/progressive.cpp:174-299.
"""
from __future__ import annotations

import os
import sys
import time
import numpy as np

from .. import trace
from ..config import DEFAULT_ALN, PLACE_W_TREE, PLACE_WO_TREE, Options, Params
from ..core.seqdb import SequenceDB, GAP
from ..phylo.tree import Tree
from . import aligner, helpers, schedule


def progressive_alignment(tree: Tree, database: SequenceDB, option: Options,
                          levels, param: Params, kernel=None) -> None:
    if option.print_detail:
        print(f"Total {len(levels)} levels.", file=sys.stderr)
    for lvl, pairs in enumerate(levels):
        t0 = time.time()
        with trace.span("schedule"):
            schedule.update_node(pairs, database)
        aligner.align_pairs(pairs, database, option, param, kernel=kernel)
        if os.environ.get("TW_DEBUG_LENS"):
            # parity-debug stream; format matches the patched reference
            for ref, qry in pairs:
                print(f"DBGLEN L{lvl} {ref.identifier} {qry.identifier} "
                      f"{ref.aln_len} {ref.aln_num} "
                      f"{len(ref.seqs_included)}", file=sys.stderr)
        if option.print_detail:
            print(f"Level {lvl + 1}, aligned {len(pairs)} pair"
                  f"{'s' if len(pairs) != 1 else ''} in "
                  f"{(time.time() - t0) * 1e3:.0f} ms", file=sys.stderr)


def _ready_after(flat) -> list:
    """For each pair g = (a, b) in the global (level-major, in-level
    order) list, the largest global index of any pair it depends on:
    every pair in the subtrees rooted at a and b (their members' rows,
    profiles and adoption sources are written by exactly those pairs,
    and scheduling guarantees they all sit at lower levels, i.e. lower
    global indices). Supersedes the reference's per-level barrier
    (progressive.cpp:174-192): a pair may START as soon as index
    ready_after[g] has committed, not when its whole level opens."""
    from bisect import bisect_left
    touch: dict = {}
    for g, (a, b) in enumerate(flat):
        touch.setdefault(id(a), []).append(g)
        touch.setdefault(id(b), []).append(g)

    memo: dict = {}

    def sub_max(root) -> int:
        """Max pair index touching any node in root's subtree."""
        stack = [(root, False)]
        while stack:
            node, expanded = stack.pop()
            if id(node) in memo:
                continue
            if expanded:
                m = touch[id(node)][-1] if id(node) in touch else -1
                for ch in node.children:
                    m = max(m, memo.get(id(ch), -1))
                memo[id(node)] = m
            else:
                stack.append((node, True))
                for ch in node.children:
                    if id(ch) not in memo:
                        stack.append((ch, False))
        return memo[id(root)]

    out = []
    for g, (a, b) in enumerate(flat):
        ra = -1
        for node in (a, b):
            lst = touch[id(node)]
            i = bisect_left(lst, g)
            if i > 0:
                ra = max(ra, lst[i - 1])   # node's own earlier pair
            for ch in node.children:
                ra = max(ra, sub_max(ch))
        # a subtree pair can never sit at or after g (levels are
        # 1 + max(children levels)); guard anyway
        out.append(min(ra, g - 1))
    return out


def progressive_alignment_crosslevel(tree: Tree, database: SequenceDB,
                                     option: Options, levels, param: Params,
                                     kernel=None) -> None:
    """Cross-level dependency scheduling (TWILIGHT_CROSS_LEVEL=1).

    Replaces the per-level barrier with rounds over a ready frontier:
    round r batches EVERY not-yet-aligned pair whose dependencies have
    committed, regardless of level — so a straggler level no longer
    serializes pairs whose subtrees are already final, and device batches
    mix levels (bigger launches, fewer round trips). Byte parity is
    preserved because (1) ready pairs touch disjoint node/member state,
    so their post phases commute, and (2) the deferral list — the one
    order-sensitive artifact (it feeds the reference's unstable sort,
    progressive.cpp:281-285) — is recorded per global index and
    materialized in (level, index) order at the end. Verbose per-level
    stderr lines become per-round lines under this flag (documented
    divergence)."""
    flat = []
    for pairs in levels:
        flat.extend(pairs)
    n = len(flat)
    if n == 0:
        return
    ra = _ready_after(flat)
    done = [False] * n
    deferred: list = []          # global indices, appended per round
    materialized = 0             # prefix of `deferred` already applied
    cursor = 0                   # all g < cursor are committed
    rnd = 0
    while cursor < n:
        frontier = [g for g in range(cursor, n)
                    if not done[g] and ra[g] < cursor]
        t0 = time.time()
        pairs = [flat[g] for g in frontier]
        with trace.span("schedule"):
            schedule.update_node(pairs, database)
        fb: list = []
        aligner.align_pairs(pairs, database, option, param, kernel=kernel,
                            fallback_out=fb)
        deferred.extend(frontier[i] for i in fb)
        for g in frontier:
            done[g] = True
        while cursor < n and done[cursor]:
            cursor += 1
        # fallback_to_deferred SWAPS the deferred pair's node state (the
        # bigger profile survives on ref, alignment-helper.cpp:541-591) —
        # state that dependent pairs read. Materialize it in global order
        # as soon as the commit cursor passes the pair, BEFORE the next
        # frontier is scheduled; pairs beyond the cursor cannot depend on
        # an unmaterialized deferral (ready_after gates them behind it).
        deferred.sort()
        ready_def = [g for g in deferred[materialized:] if g < cursor]
        if ready_def:
            helpers.fallback_to_deferred(ready_def, flat, database,
                                         option.no_filter)
            materialized += len(ready_def)
        rnd += 1
        if option.print_detail:
            print(f"Round {rnd}, aligned {len(pairs)} pair"
                  f"{'s' if len(pairs) != 1 else ''} in "
                  f"{(time.time() - t0) * 1e3:.0f} ms", file=sys.stderr)
    if materialized < len(deferred):
        helpers.fallback_to_deferred(deferred[materialized:], flat,
                                     database, option.no_filter)


def update_alignment_root(node, database: SequenceDB) -> None:
    """Expand collapsed sub-MSA members through their subtree paths and
    rebuild the root's member list (reference progressive.cpp:194-230)."""
    for seq in database.sequences:
        if seq.subtree_idx < -1:
            path = database.subtree_aln[seq.subtree_idx]
            pos = np.nonzero(np.asarray(path) == 0)[0]
            new = np.full(len(path), GAP, dtype=np.uint8)
            new[pos] = seq.aln[:len(pos)]
            seq.aln = new
            seq.len = len(path)
    new_included = [s for s in node.seqs_included if s >= 0]
    for seq in database.sequences:
        if seq.subtree_idx < 0:
            new_included.append(seq.id)
    node.seqs_included = new_included


def msa_on_subtree(tree: Tree, database: SequenceDB, option: Options,
                   param: Params, kernel=None, subtree: int = -1) -> None:
    """Reference msaOnSubtree (progressive.cpp:232-299)."""
    t_prog0 = time.time()
    print("============================", file=sys.stderr)
    mode = 2 if option.aln_mode == PLACE_WO_TREE else \
        (0 if database.current_task == 0 else 1)
    with trace.span("schedule"):
        levels = schedule.scheduling(tree.root, mode)
    if option.print_detail:
        print(f"Scheduling in {(time.time() - t_prog0) * 1e6:.0f} us",
              file=sys.stderr)

    if mode == 0 and os.environ.get("TWILIGHT_CROSS_LEVEL"):
        progressive_alignment_crosslevel(tree, database, option, levels,
                                         param, kernel=kernel)
    else:
        progressive_alignment(tree, database, option, levels, param,
                              kernel=kernel)
    if option.aln_mode == PLACE_WO_TREE:
        with trace.span("root_update"):
            helpers.merge_insertions(database, tree.root)

    if database.current_task == 0:
        last = levels[-1][0][0]
        tree.root.seqs_included = last.seqs_included
        if last.msa_freq is not None and len(last.msa_freq):
            tree.root.msa_freq = last.msa_freq
        tree.root.aln_len = last.aln_len
        tree.root.aln_num = last.aln_num
        tree.root.aln_weight = last.aln_weight
        last.seqs_included = []
        last.msa_freq = None

    if (option.aln_mode in (DEFAULT_ALN, PLACE_W_TREE)
            and not database.fallback_nodes):
        with trace.span("root_update"):
            update_alignment_root(tree.root, database)

    prog_s = time.time() - t_prog0
    if option.aln_mode == PLACE_WO_TREE:
        placed = sum(1 for s in database.sequences if not s.low_quality)
        tree.root.aln_num += placed
        print(f"Placed {placed} sequences in {int(prog_s)} s",
              file=sys.stderr)
    elif database.current_task != 2:
        print(f"Alignment (length: {tree.root.aln_len}) completed in "
              f"{int(prog_s)} s", file=sys.stderr)
    else:
        print(f"Alignment on {len(tree.all_nodes)} subalignments (length: "
              f"{tree.root.aln_len}) in {prog_s * 1e3:.0f} ms",
              file=sys.stderr)

    if not database.fallback_nodes:
        return

    # deferred/bad-profile realign pass (progressive.cpp:276-297)
    with trace.span("deferred"):
        _realign_deferred(tree, database, option, param, kernel)


def _realign_deferred(tree: Tree, database: SequenceDB, option: Options,
                      param: Params, kernel=None) -> None:
    """The realign pass of the deferred profiles: each against the root,
    one level each (progressive.cpp:276-297)."""
    t_bad0 = time.time()
    database.current_task = 1
    bad = list(database.fallback_nodes)
    bad = helpers.sort_fallback(bad)
    if os.environ.get("TW_DEBUG_LENS"):
        for b in bad:
            print(f"DBGBAD {b.identifier} {b.aln_num} {b.aln_len}",
                  file=sys.stderr)
    levels = [[(tree.root, b)] for b in bad]
    print(f"Realign profiles that have been deferred. Total "
          f"profiles/sequences: {len(bad)} / "
          f"{sum(len(b.seqs_included) for b in bad)}", file=sys.stderr)
    database.fallback_nodes = []
    progressive_alignment(tree, database, option, levels, param, kernel=kernel)
    if option.aln_mode in (DEFAULT_ALN, PLACE_W_TREE):
        with trace.span("root_update"):
            update_alignment_root(tree.root, database)
    database.current_task = 0
    print(f"Realigned profiles/sequences in {int(time.time() - t_bad0)} s",
          file=sys.stderr)
