"""The comparison that decides `correct`, run once the window has closed
(reference.py and pipeline_ref.py say what each number compares). The
program's answers are judged; so are, by the same comparison, the
control's (control.py): the plain reference computed in bfloat16 put in
the program's place. Counts have the limit 0; the two residuals have
limits set between the program's readings and the control's (PERF.md).
"""
from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from . import pipeline_ref, reference
from .talco_ref import to_bf16

# Limits of the two residuals, from the readings in PERF.md.
PROFILE_LIMIT = 0.1
PSGP_LIMIT = 1e-4
NO_MATCH = 1e6          # a residual where the shapes already differ


def reference_paths(jobs):
    """align_job over the jobs, on worker processes (spawned, and all
    ended before this returns)."""
    if not jobs:
        return []
    n = min(len(jobs), os.cpu_count() or 1, 8)
    order = sorted(range(len(jobs)), key=lambda j: -_cost(jobs[j]))
    with ProcessPoolExecutor(
            max_workers=n,
            mp_context=multiprocessing.get_context("spawn")) as ex:
        done = list(ex.map(reference.align_job, [jobs[j] for j in order]))
    out = [None] * len(jobs)
    for j, r in zip(order, done):
        out[j] = r
    return out


def _cost(job) -> int:
    if job["kind"] == "leaf":
        return len(job["ref_seq"]) * len(job["qry_seq"])
    return len(job["fr"]) * len(job["fq"]) * job["fr"].shape[1]


def jobs_of(bench, win, bf16=False):
    """(items, jobs): the sampled pairs the program answered, and the
    reference's job for each."""
    scoring = bench.cfg["scoring"]
    inputs = {}
    items, jobs = [], []
    for kind in ("leaf", "freq"):
        for item in win.rec.samples[kind]:
            if "path" not in item:
                continue          # its call raised
            job = {"kind": kind, "type": bench.type, "scoring": scoring,
                   "bf16": bf16}
            if kind == "leaf":
                k = item["k"]
                if k not in inputs:
                    inputs[k] = reference.read_fasta(win.inputs[k][0])[0]
                a, b = item["names"]
                job.update(ref_seq=inputs[k][a], qry_seq=inputs[k][b])
            else:
                job.update(fr=item["fr"], fq=item["fq"], go=item["go"],
                           ge=item["ge"], num=item["num"], task=item["task"])
            items.append(item)
            jobs.append(job)
    return items, jobs


def same(path, ref_path) -> bool:
    return (path is None) == (ref_path is None) and (
        path is None or np.array_equal(path, ref_path))


class Written:
    """What the reference reads of alignment k: its input, the rows the
    program wrote, the input tree's cherries and its leaf weights."""

    def __init__(self, win):
        self.win, self.cache = win, {}

    def __getitem__(self, k):
        if k not in self.cache:
            inputs = reference.read_fasta(self.win.inputs[k][0])[0]
            with open(self.win.inputs[k][1]) as f:
                nwk = f.read()
            out = self.win.outputs[k]
            rows, dups = (reference.read_fasta(out) if os.path.exists(out)
                          else ({}, []))
            self.cache[k] = {
                "inputs": inputs, "rows": rows, "dups": dups,
                "written": os.path.exists(out),
                "nbr": reference.tree_neighbours(nwk),
                "weights": pipeline_ref.weight_sets(nwk)}
        return self.cache[k]


def program_answer(item, w):
    """The program's answers for a sampled pair: the batcher's path, the
    card's first launch, and what the written file says of the pair."""
    ans = {"path": item["path"], "card_err": item.get("card_err"),
           "card_path": item.get("card_path"), "cells": item.get("cells")}
    if item["path"] is None:
        return ans
    f = w[item["k"]]
    if item["kind"] == "leaf":
        a, b = item["names"]
        rows = f["rows"]
        ok = (a in rows and b in rows and len(rows[a]) == len(rows[b])
              and f["nbr"].get(a, -2) == f["nbr"].get(b, -3))
        ans["written"] = (reference.projection(rows[a], rows[b]) if ok
                          else None)
    elif "sides" in item:
        ans["merge"] = pipeline_ref.merge_projection(f["rows"],
                                                     *item["sides"])
        ans["profiles"] = (item["fr"], item["fq"])
        ans["psgp"] = (item["go"], item["ge"])
    return ans


def control_answer(item, low, w, type_, scoring):
    """The control's answers for the same pair: the reference in
    bfloat16 (its ladder's path, first step and cells; the profiles and
    gap scores it works out from the written rows), where the program
    answered."""
    path, cells, err = low
    answered = item["path"] is not None or item["task"] == 0
    ans = {"path": path if answered else None,
           "card_err": err if item.get("card_err") is not None else None,
           "card_path": path if err == 0 else None, "cells": cells}
    if item["path"] is None:
        return ans
    if item["kind"] == "leaf":
        ans["written"] = path
    elif "sides" in item:
        ans["merge"] = path
        profs, gaps = [], ([], [])
        for names, num in zip(item["sides"], item["num"]):
            side = _side(w[item["k"]], names, num, type_, 0, to_bf16)
            exact = _side(w[item["k"]], names, num, type_, 0)
            if side is None or exact is None:
                return ans
            # over the columns the float32 reference keeps, so that the
            # residual reads the rounding and not a column count
            prof = side[0][exact[1]]
            profs.append(prof)
            op, ex = pipeline_ref.psgp(prof, num, type_,
                                       scoring["gap_open"],
                                       scoring["gap_extend"], to_bf16)
            gaps[0].append(op)
            gaps[1].append(ex)
        ans["profiles"] = tuple(profs)
        ans["psgp"] = gaps
    return ans


def _side(f, names, num, type_, wi, rnd=None):
    """(profile over the side's columns, columns the DP keeps, lightest
    row weight) of one side with weight set `wi`, or None."""
    codes, ok = pipeline_ref.side_rows(f["rows"], names, type_)
    if not ok or wi >= len(f["weights"]):
        return None
    ws = pipeline_ref.side_weights(names, f["weights"][wi], rnd)
    prof = pipeline_ref.profile(codes, ws, 6 if type_ == "n" else 22, rnd)
    return prof, pipeline_ref.gappy_keep(prof, num), float(ws.min())


def profile_residual(item, ans, f, type_) -> float:
    """The widest gap between a side's DP profile as answered and the
    reference's, in units of the side's lightest row weight (the least
    weight, over the centres the tree may be rerooted at)."""
    best = NO_MATCH
    for wi in range(len(f["weights"])):
        worst = 0.0
        for names, num, ln, got in zip(item["sides"], item["num"],
                                       item["lens"], ans["profiles"]):
            side = _side(f, names, num, type_, wi)
            if side is None or len(side[0]) != ln \
                    or int(side[1].sum()) != len(got):
                worst = NO_MATCH
                break
            prof, keep, light = side
            worst = max(worst, float(np.abs(prof[keep] - got).max()
                                     / light))
        best = min(best, worst)
    return best


def psgp_residual(item, ans, type_, scoring) -> float:
    """The widest gap between the gap scores as answered and those the
    reference works out from the answered profiles, over the gap score's
    own size."""
    worst = 0.0
    for s in range(2):
        prof, num = ans["profiles"][s], item["num"][s]
        op, ex = pipeline_ref.psgp(np.asarray(prof, dtype=np.float64), num,
                                   type_, scoring["gap_open"],
                                   scoring["gap_extend"])
        got_op, got_ex = ans["psgp"][0][s], ans["psgp"][1][s]
        if len(got_op) != len(op):
            return NO_MATCH
        worst = max(worst,
                    float(np.abs(op - got_op).max() / -scoring["gap_open"]),
                    float(np.abs(ex - got_ex).max()
                          / -scoring["gap_extend"]))
    return worst


def _merge_differs(ans, ref_path, item, f, type_) -> bool:
    """Whether the merge as written (or, for the control, its path) is
    not the reference's path."""
    merge = ans["merge"]
    if merge is None or isinstance(merge, np.ndarray):
        return not same(merge, ref_path)
    keeps = []
    for names, num in zip(item["sides"], item["num"]):
        side = _side(f, names, num, type_, 0)
        if side is None:
            return True
        keeps.append(side[1])
    return not same(pipeline_ref.compact_path(merge, *keeps), ref_path)


def judge(bench, win, refs=None, low=None):
    """(checks {name: (value, limit)}, info {name: count}) of a window:
    of the program's answers, or, given `low` (the reference's answers in
    bfloat16 to jobs_of's jobs), of the control's; `refs`, the float32
    reference's answers, if already made."""
    items, jobs = jobs_of(bench, win)
    if refs is None:
        refs = reference_paths(jobs)
    w = Written(win)
    scoring = bench.cfg["scoring"]
    n = {k: 0 for k in ("kernel", "cells", "leaf", "merge", "profile",
                        "kernel_j", "cells_j", "leaf_j", "merge_j",
                        "profile_j")}
    prof_res = psgp_res = 0.0
    for i, (item, ref) in enumerate(zip(items, refs)):
        ans = (program_answer(item, w) if low is None else
               control_answer(item, low[i], w, bench.type, scoring))
        ref_path, ref_cells, ref_err = ref
        if ans["path"] is not None or item["task"] == 0 \
                or item.get("card_err") is not None:
            n["kernel_j"] += 1
            bad = False
            if ans["path"] is not None or item["task"] == 0:
                bad = not same(ans["path"], ref_path)
            if item.get("card_err") is not None:
                bad |= ans["card_err"] != ref_err or (
                    ref_err == 0 and not same(ans["card_path"], ref_path))
            n["kernel"] += bad
        if item.get("card_err") is not None:
            n["cells_j"] += 1
            n["cells"] += ans["cells"] != ref_cells
        if "written" in ans and ref_path is not None:
            n["leaf_j"] += 1
            n["leaf"] += not same(ans["written"], ref_path)
        f = w[item["k"]] if "merge" in ans else None
        if f is not None and ref_path is not None:
            n["merge_j"] += 1
            n["merge"] += _merge_differs(ans, ref_path, item, f, bench.type)
        if "profiles" in ans:
            n["profile_j"] += 2
            prof_res = max(prof_res, profile_residual(item, ans, f,
                                                      bench.type))
            psgp_res = max(psgp_res, psgp_residual(item, ans, bench.type,
                                                   scoring))
    rows_bad = 0
    if low is None:
        for k in range(len(win.outputs)):
            f = w[k]
            if not f["written"]:
                rows_bad += len(f["inputs"])
            else:
                rows_bad += reference.rows_wrong(f["rows"], f["dups"],
                                                 f["inputs"])
    checks = {"kernel_pairs_differ": (n["kernel"], 0),
              "dp_cells_differ": (n["cells"], 0),
              "leaf_pairs_differ": (n["leaf"], 0),
              "merge_paths_differ": (n["merge"], 0),
              "profile_residual": (prof_res, PROFILE_LIMIT),
              "psgp_residual": (psgp_res, PSGP_LIMIT),
              "rows_wrong": (rows_bad, 0),
              "failed_alignments": (win.failed, 0)}
    info = {"kernel_pairs_judged": n["kernel_j"],
            "dp_cells_judged": n["cells_j"],
            "leaf_pairs_judged": n["leaf_j"],
            "merge_pairs_judged": n["merge_j"],
            "profile_sides_judged": n["profile_j"],
            "leaf_sampled": len(win.rec.samples["leaf"]),
            "freq_sampled": len(win.rec.samples["freq"]),
            "alignments_judged": len(win.outputs)}
    return checks, info


def all_judged(info) -> bool:
    """Whether the window gave every layer something to judge."""
    return all(info[k] > 0 for k in (
        "kernel_pairs_judged", "dp_cells_judged", "leaf_pairs_judged",
        "merge_pairs_judged", "profile_sides_judged"))
