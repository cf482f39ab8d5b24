"""The plain reference of the pipeline layer: what the host pipeline
derives from the inputs before and after each DP pair, worked out again
from the input tree and the written alignment (TWILIGHT's rules; nothing
of the port is imported).

- Sequence weights: the input tree is rerooted at its centre by edge
  counts (the middle of a longest leaf-to-leaf path, tree.cpp:588-696;
  where that path has an odd number of edges the centre is two nodes, and
  both are tried), and each leaf weighs the sum, over the edges from it
  to the root, of the edge's length over the leaves below it, over the
  heaviest leaf's (ClustalW; tree.cpp:317-341). Zero lengths take the
  least positive length (tree.cpp:204-219).
- A side's profile: the side's rows of the written alignment, the
  columns that are gaps in all of them dropped (later merges only insert
  such columns), each letter and gap weighed by weight / the side's total
  weight x the side's count (alignment-helper.cpp:8-72).
- Gappy columns: those whose gap weight over the count exceeds the
  threshold are left out of the DP (alignment-helper.cpp:74-166).
- Position-specific gap scores from a profile's gap row (ClustalW;
  alignment-helper.cpp:168-219).
- A merge: the union of the two sides' rows, all-gap columns dropped,
  spells the pair's path column by column (both sides, one side or the
  other); the columns a side left out as gappy are cut from it, and what
  stays must be the reference's DP path.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from .reference import GAP, letter_codes

GAPPY = 0.95        # TWILIGHT's default -r (gappy column threshold)


def parse_tree(newick: str):
    """(neighbours, lengths, leaf names): node 0 is the Newick root; an
    edge's length is keyed by its lower node."""
    s = newick.strip().rstrip(";")
    nbr, length, names = [[]], [0.0], {}
    stack, i = [0], 1              # s[0] is the root's parenthesis

    def add(parent, ln):
        nbr.append([parent])       # a node's first neighbour: its parent
        nbr[parent].append(len(nbr) - 1)
        length.append(ln)
        return len(nbr) - 1

    while i < len(s):
        c = s[i]
        if c == "(":
            stack.append(add(stack[-1], 0.0))
            i += 1
        elif c == ",":
            i += 1
        elif c == ")":
            node = stack.pop()
            j = i = i + 1
            while i < len(s) and s[i] not in ",)":
                i += 1
            if ":" in s[j:i]:      # an internal node's label and length
                length[node] = float(s[j:i].split(":")[1])
        else:
            j = i
            while i < len(s) and s[i] not in ",)":
                i += 1
            name, _, ln = s[j:i].partition(":")
            names[add(stack[-1], float(ln) if ln else 0.0)] = name.strip()
    lens = np.array(length)
    pos = lens[1:][lens[1:] > 0]
    if len(pos) == 0:
        lens[1:] = 1.0
    else:
        lens[1:][lens[1:] == 0] = pos.min()
    return nbr, lens, names


def _bfs(nbr, start):
    dist = {start: 0}
    prev = {start: None}
    q = deque([start])
    far = start
    while q:
        u = q.popleft()
        for v in nbr[u]:
            if v not in dist:
                dist[v] = dist[u] + 1
                prev[v] = u
                q.append(v)
                if dist[v] > dist[far]:
                    far = v
    return far, prev


def centres(nbr, names) -> list:
    """The one or two nodes in the middle of every longest path."""
    a, _ = _bfs(nbr, next(iter(names)))
    b, prev = _bfs(nbr, a)
    path = [b]
    while prev[path[-1]] is not None:
        path.append(prev[path[-1]])
    d = len(path) - 1
    return [path[d // 2]] if d % 2 == 0 else [path[d // 2],
                                              path[d // 2 + 1]]


def leaf_weights(nbr, lens, names, root) -> dict:
    """{leaf name: ClustalW weight} with the tree rooted at `root`."""
    parent = {root: None}
    order = [root]
    for u in order:
        for v in nbr[u]:
            if v not in parent:
                parent[v] = u
                order.append(v)
    below = {}
    for u in reversed(order):
        kids = [v for v in nbr[u] if parent.get(v) == u]
        below[u] = 1 if not kids else sum(below[v] for v in kids)
    edge = {}
    for u in order[1:]:
        p = parent[u]
        # an edge's length sits on its lower node in the Newick, which
        # rerooting may have turned upside down
        ln = lens[u] if u != 0 and nbr[u][0] == p else lens[p]
        edge[u] = ln / below[u]
    acc = {root: 0.0}
    for u in order[1:]:
        acc[u] = acc[parent[u]] + edge[u]
    w = {names[u]: acc[u] for u in names}
    top = max(w.values())
    return {k: v / top for k, v in w.items()}


def weight_sets(newick: str) -> list:
    """One {name: weight} a centre the program may have rerooted at."""
    nbr, lens, names = parse_tree(newick)
    return [leaf_weights(nbr, lens, names, c) for c in centres(nbr, names)]


def side_rows(rows: dict, names, type_: str):
    """(codes n x L, True) of a side's rows with its all-gap columns
    dropped, or (None, False) when a row is missing or widths differ."""
    if any(n not in rows for n in names) or \
            len({len(rows[n]) for n in names}) != 1:
        return None, False
    mat = np.stack([np.frombuffer(rows[n], dtype=np.uint8) for n in names])
    keep = (mat != GAP).any(axis=0)
    mat = mat[:, keep]
    p = 6 if type_ == "n" else 22
    codes = letter_codes(mat.tobytes(), type_).reshape(mat.shape)
    codes[mat == GAP] = p - 1
    return codes, True


def profile(codes, weights, p: int, rnd=None) -> np.ndarray:
    """L x p weighted letter counts of a side (`rnd` rounds every sum,
    for the lower-precision control)."""
    n, length = codes.shape
    if rnd is None:
        return np.stack([(codes == a).T.astype(np.float64) @ weights
                         for a in range(p)], axis=1)
    out = np.zeros((length, p), dtype=np.float32)
    cols = np.arange(length)
    for i in range(n):
        out[cols, codes[i]] = rnd(out[cols, codes[i]] + weights[i])
    return out.astype(np.float64)


def side_weights(names, weights: dict, rnd=None) -> np.ndarray:
    """Each row's weight in the side's profile: weight / the side's total
    x the side's count."""
    w = np.array([weights[n] for n in names])
    out = w / w.sum() * len(w)
    return rnd(out) if rnd is not None else out


def gappy_keep(prof: np.ndarray, num: float, threshold: float = GAPPY):
    """The columns the DP keeps."""
    if threshold >= 1.0:
        return np.ones(len(prof), dtype=bool)
    return ~(prof[:, -1] / num > threshold)


def psgp(prof: np.ndarray, num: float, type_: str, gap_open: float,
         gap_extend: float, rnd=None):
    """(gap open, gap extend) a column of a side's DP profile."""
    scale = 0.5 if type_ == "n" else 1.0
    ratio = prof[:, -1]
    frac = (num - ratio) / num
    op = np.where(ratio > 0, np.minimum(gap_open * 0.1,
                                        gap_open * scale * frac), gap_open)
    ex = np.where(ratio > 0, np.minimum(gap_extend * 0.2,
                                        gap_extend * frac), gap_extend)
    if rnd is not None:
        op, ex = rnd(op), rnd(ex)
    return op, ex


def merge_projection(rows: dict, names_r, names_q):
    """(path, ref column, query column) a column of the union of the two
    sides' rows, all-gap columns dropped; None when a row is missing."""
    names = list(names_r) + list(names_q)
    if any(n not in rows for n in names) or \
            len({len(rows[n]) for n in names}) != 1:
        return None

    def has(names):
        m = np.stack([np.frombuffer(rows[n], dtype=np.uint8)
                      for n in names])
        return (m != GAP).any(axis=0)

    r, q = has(names_r), has(names_q)
    keep = r | q
    r, q = r[keep], q[keep]
    path = np.where(r & q, 0, np.where(r, 2, 1)).astype(np.int8)
    return path, np.cumsum(r) - 1, np.cumsum(q) - 1


def compact_path(proj, keep_r, keep_q):
    """The merge's path with the columns the DP left out cut, or None
    where the sides' column counts differ from their profiles' or a step
    pairs a kept column with one left out."""
    path, rc, qc = proj
    if int(rc[-1]) + 1 != len(keep_r) or int(qc[-1]) + 1 != len(keep_q):
        return None
    kr = keep_r[np.maximum(rc, 0)]
    kq = keep_q[np.maximum(qc, 0)]
    both = path == 0
    if (both & (kr != kq)).any():
        return None
    return path[np.where(path == 1, kq, kr)]
