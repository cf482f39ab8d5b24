"""The benchmark's generator of alignment inputs, in plain NumPy, after the
port's simulator (`tools/simulate.py`): sequences evolve along a random
binary tree, and the true tree is written as Newick.

Three changes from the port's simulator, each a parameter of the
workload file's `generator` (PERF.md gives the readings each was fitted
to):

- the tree's shape: a node of n leaves splits into i and n - i leaves
  with Aldous's beta-splitting weights (`split_beta`; 0 is the port's
  uniform split, lower is less balanced);
- branch times: uniform in [0.05, 0.5) for a branch to an internal
  node, as in the port's simulator, and in `leaf_time` for a branch to
  a leaf;
- indel lengths: drawn with the weights `indel_lengths` of lengths 1,
  2, ... (the port's simulator draws 1-7 uniformly).

The tree (its splits and branch times) is drawn from a stream of its own,
seeded by the cell's name alone, and the letters (the root and every
branch's substitutions and indels) from a stream seeded by `--seed` and
the alignment's index. So every alignment of a cell, in every run, has
the same tree and the same sizes, with other letters: a seed changes the
letters and not the amount of work, and a window's mean does not depend
on how many alignments fitted into it.
"""
from __future__ import annotations

import math
import sys
import zlib

import numpy as np

ALPHABETS = {"n": b"ACGT", "p": b"ACDEFGHIKLMNPQRSTVWY"}
DEFAULTS = {"mut_rate": 0.05, "indel_rate": 0.005,
            "indel_lengths": [1] * 7, "leaf_time": [0.05, 0.5],
            "split_beta": 0.0}
INNER_TIME = (0.05, 0.5)


def _stream(*keys) -> np.random.Generator:
    words = []
    for k in keys:
        k = int(k) % (1 << 64)
        words += [k & 0xFFFFFFFF, k >> 32]
    return np.random.default_rng(words)


def split_weights(n: int, beta: float) -> np.ndarray:
    """Aldous's beta-splitting: the chance that a node of n leaves splits
    into i and n - i leaves, i = 1 .. n - 1, for beta > -2."""
    lg = np.array([math.lgamma(beta + k + 1) - math.lgamma(k + 1)
                   for k in range(1, n)])
    w = lg + lg[::-1]
    w = np.exp(w - w.max())
    return w / w.sum()


def simulate(gen: dict, type_: str, shape_key: str, index: int, seed: int):
    """(names, sequences, newick) of alignment `index` of the cell
    `shape_key`, from the workload's `generator` (`n` leaves S1..Sn
    evolved from a random root of `length` letters; per branch of time t,
    substitutions at `mut_rate` * t a letter, and indels at
    `indel_rate` * t a letter, half insertions and half deletions)."""
    g = {**DEFAULTS, **gen}
    n_seqs, length = int(g["n"]), int(g["length"])
    mut, indel = float(g["mut_rate"]), float(g["indel_rate"])
    lens = np.asarray(g["indel_lengths"], dtype=np.float64)
    lens = np.cumsum(lens / lens.sum())
    leaf = tuple(g["leaf_time"])
    beta = float(g["split_beta"])
    table = {}

    tree_rng = _stream(zlib.crc32(shape_key.encode()))
    seq_rng = _stream(seed, index)
    alpha = np.frombuffer(ALPHABETS[type_], dtype=np.uint8)
    nletters = len(alpha)
    root = seq_rng.integers(0, nletters, size=length).astype(np.uint8)

    def split(n):
        if beta == 0.0:
            return int(tree_rng.integers(1, n))
        if n not in table:
            table[n] = np.cumsum(split_weights(n, beta))
        c = table[n]
        return 1 + min(int(np.searchsorted(c, tree_rng.random(),
                                           side="right")), n - 2)

    def evolve(seq, t):
        out = seq.copy()
        m = seq_rng.random(len(out)) < mut * t
        out[m] = seq_rng.integers(0, nletters, int(m.sum()))
        for _ in range(int(seq_rng.poisson(indel * t * len(out)))):
            pos = int(seq_rng.integers(0, len(out)))
            ln = 1 + int(np.searchsorted(lens, seq_rng.random(),
                                         side="right"))
            if seq_rng.random() < 0.5 and len(out) > ln + 1:
                out = np.concatenate([out[:pos], out[pos + ln:]])
            else:
                ins = seq_rng.integers(0, nletters, ln).astype(np.uint8)
                out = np.concatenate([out[:pos], ins, out[pos:]])
        return out

    names, seqs = [], []

    def grow(seq, budget, n_target):
        if n_target == 1:
            names.append(f"S{len(names) + 1}")
            seqs.append(seq)
            return f"{names[-1]}:{budget:.4f}"
        left_n = split(n_target)
        kids = []
        for k in (left_n, n_target - left_n):
            lo, hi = leaf if k == 1 else INNER_TIME
            kids.append((k, float(tree_rng.uniform(lo, hi))))
        parts = [grow(evolve(seq, t), t, k) for k, t in kids]
        return f"({parts[0]},{parts[1]}):{budget:.4f}"

    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 10000, 4 * n_seqs))
    try:
        nwk = grow(root, 0.1, n_seqs)[:-7] + ";"   # no root branch length
    finally:
        sys.setrecursionlimit(limit)
    return names, [alpha[s].tobytes().decode() for s in seqs], nwk


def write_input(prefix: str, names, seqs, nwk) -> tuple:
    """Writes prefix.fa and prefix.nwk; returns their paths."""
    with open(prefix + ".fa", "w") as f:
        f.writelines(f">{n}\n{s}\n" for n, s in zip(names, seqs))
    with open(prefix + ".nwk", "w") as f:
        f.write(nwk + "\n")
    return prefix + ".fa", prefix + ".nwk"
