"""The plain reference that decides `correct`, and what it compares.

It imports nothing of the port and nothing of the JAX package: NumPy, the
frozen oracle (`talco_ref`) and the configuration file's own scores.

- Kernel layer: a pair the timed window handed the DP batcher is aligned
  again by the reference retry ladder of TWILIGHT (alignment-cpu.cpp:
  95-130) over the frozen oracle. A pair of two raw sequences (a leaf
  pair) is rebuilt from the input FASTA: its one-hot profiles and flat gap
  scores are worked out here. A pair of profiles (a freq pair) takes the
  profiles and position-specific gap scores the program packed: the
  reference follows the program from its own state there. The path, or
  the deferral at task 0, must be the program's; and the card's own
  answer in the pair's first launch (also where the host stole the pair)
  must be the ladder's first step: its error, its path, and the DP cells
  the kernel counted in its tail.
- Pipeline layer: every row of every written alignment must be its input
  sequence with gaps, under its own name, all rows one width; and for a
  leaf pair, the two leaves must be a cherry of the input tree and the
  written rows, projected onto the pair, must be the reference path
  (progressive alignment never re-aligns residues once paired, so the
  final file keeps the pair's path).
"""
from __future__ import annotations

import numpy as np

from . import talco_ref

GAP = ord("-")
BASE_FLEN = 1 << 12
AA_ORDER = "ACDEFGHIKLMNPQRSTVWY"   # BLOSUM's row order


def letter_codes(seq: bytes, type_: str) -> np.ndarray:
    """Profile row of each letter: nucleotides A C G T(U) = 0-3, anything
    else 4; amino acids in the order of `AA_ORDER`, anything else 20."""
    lut = np.full(256, 4 if type_ == "n" else 20, dtype=np.int64)
    letters = "ACGT" if type_ == "n" else AA_ORDER
    for i, ch in enumerate(letters):
        lut[ord(ch)] = lut[ord(ch.lower())] = i
    if type_ == "n":
        lut[ord("U")] = lut[ord("u")] = 3
    return lut[np.frombuffer(seq, dtype=np.uint8)]



def scoring_matrix(scoring: dict) -> np.ndarray:
    """The configuration's substitution matrix: nucleotides from match,
    mismatch and transition (A<->G, C<->T) with a zero row and column for
    N; amino acids as `scale` times the 20 x 20 table with a zero row and
    column for X (TWILIGHT scoring-matrix.cpp:81-137, no wildcard)."""
    if "table" in scoring:
        t = np.asarray(scoring["table"], dtype=np.float32)
        m = np.zeros((21, 21), dtype=np.float32)
        m[:20, :20] = np.float32(scoring["scale"]) * t
        return m
    m = np.zeros((5, 5), dtype=np.float32)
    for i in range(4):
        for j in range(4):
            m[i, j] = (scoring["match"] if i == j else scoring["transition"]
                       if abs(i - j) == 2 else scoring["mismatch"])
    return m


def leaf_inputs(ref: bytes, qry: bytes, type_: str, scoring: dict):
    """(freq_ref, freq_qry, gap_op, gap_ex) of two raw sequences: one-hot
    profiles with unit weight, and the flat gap scores (no column of a
    single sequence holds a gap)."""
    p = 6 if type_ == "n" else 22
    out = []
    for s in (ref, qry):
        f = np.zeros((len(s), p), dtype=np.float32)
        f[np.arange(len(s)), letter_codes(s, type_)] = 1.0
        out.append(f)
    go, ge = np.float32(scoring["gap_open"]), np.float32(scoring["gap_extend"])
    return (out[0], out[1], (np.full(len(ref), go), np.full(len(qry), go)),
            (np.full(len(ref), ge), np.full(len(qry), ge)))


def ladder(fr, fq, go, ge, num, task, gap_char, scoring, rnd=None):
    """The reference retry ladder: (path, or None for a pair deferred at
    task 0 or an index error; the first step's DP cells and error)."""
    lens = (len(fr), len(fq))
    tp = talco_ref.TalcoRunParams(
        scoring_matrix(scoring), scoring["gap_open"], scoring["gap_extend"],
        gap_char, int(1000 * -1 * scoring["gap_extend"]), flen=BASE_FLEN,
        rnd=rnd)
    first = None
    while True:
        aln, err, cells = talco_ref.align_freq(tp, fr, fq, go, ge, num)
        first = (cells, err) if first is None else first
        if err == 0 and len(aln):
            return (aln, *first)
        if (task == 0 and err != 0) or err == 3:
            return (None, *first)
        if err == 2:
            tp.flen = min(int(tp.flen * 1.2) << 1, min(lens))
        elif err == 1:
            tp.xdrop = int(tp.xdrop * 2)
            tp.flen = min(int(tp.xdrop * 4) << 1, min(lens))
        else:
            return (aln, *first)


def gap_char(task: int, num, gap_extend: float) -> float:
    """TWILIGHT's score of a residue against a gap: 0 when realigning or
    merging (tasks 1, 2) or for a side of more than 10000 sequences."""
    return 0.0 if task in (1, 2) or max(num) > 10000 else gap_extend


def align_job(job: dict):
    """The reference of one sampled pair (runs in a worker process):
    ladder's (path or None, first-step DP cells, first-step error)."""
    sc = job["scoring"]
    rnd = talco_ref.to_bf16 if job.get("bf16") else None
    if job["kind"] == "leaf":
        fr, fq, go, ge = leaf_inputs(job["ref_seq"], job["qry_seq"],
                                     job["type"], sc)
        return ladder(fr, fq, go, ge, (1.0, 1.0), 0, sc["gap_extend"], sc,
                      rnd)
    num = job["num"]
    return ladder(job["fr"], job["fq"], job["go"], job["ge"], num,
                  job["task"], gap_char(job["task"], num, sc["gap_extend"]),
                  sc, rnd)


def read_fasta(path: str):
    """{name: sequence bytes} of a FASTA file, in file order, and the
    names that appear more than once."""
    seqs, dups, name, parts = {}, [], None, []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    seqs[name] = b"".join(parts)
                name, parts = line[1:].split()[0].decode(), []
                if name in seqs:
                    dups.append(name)
            else:
                parts.append(line.strip())
    if name is not None:
        seqs[name] = b"".join(parts)
    return seqs, dups


def rows_wrong(rows: dict, dups: list, inputs: dict) -> int:
    """Rows of a written alignment (read_fasta's rows and repeated names)
    that are not their input sequence with gaps: a name missing, added or
    repeated, a row whose letters differ, and every row when the rows
    differ in width."""
    bad = len(dups) + len(set(rows) ^ set(inputs))
    widths = {len(r) for r in rows.values()}
    if len(widths) > 1:
        return bad + len(rows)
    for name, row in rows.items():
        if name in inputs and row.replace(b"-", b"") != inputs[name]:
            bad += 1
    return bad


def projection(ref_row: bytes, qry_row: bytes) -> np.ndarray:
    """The pairwise path two rows of an alignment spell, columns where
    both are gaps dropped: 0 both letters, 2 the reference's alone, 1 the
    query's alone."""
    a = np.frombuffer(ref_row, dtype=np.uint8) != GAP
    b = np.frombuffer(qry_row, dtype=np.uint8) != GAP
    keep = a | b
    return np.where(a & b, 0, np.where(a, 2, 1))[keep].astype(np.int8)


def tree_neighbours(newick: str) -> dict:
    """{leaf: its one neighbour in the unrooted tree}, the neighbour being
    an internal node's number. A root of two children is not a node of
    the unrooted tree: its children are each other's neighbour. Two leaves
    are a cherry when they share their neighbour."""
    s = newick.strip().rstrip(";")
    if not s.startswith("("):
        raise ValueError("a tree of one leaf")
    root_kids, stack, nbr = [], [0], {}
    nxt, i, label = 1, 1, ""       # s[0] is the root's parenthesis
    while i < len(s):
        c = s[i]
        if c == "(":
            if stack[-1] == 0:
                root_kids.append(nxt)
            stack.append(nxt)
            nxt += 1
        elif c in ",)":
            name, label = label.split(":")[0].strip(), ""
            if name:
                nbr[name] = stack[-1]
                if stack[-1] == 0:
                    root_kids.append(name)
            if c == ")":
                stack.pop()
                # an internal node's own label and length follow its ")"
                while i + 1 < len(s) and s[i + 1] not in ",)":
                    i += 1
        else:
            label += c
        i += 1
    if len(root_kids) == 2:
        for a, b in (root_kids, root_kids[::-1]):
            if isinstance(a, str):
                nbr[a] = -1 if isinstance(b, str) else b
    return nbr
