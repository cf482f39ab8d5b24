"""Neighbor joining (Saitou & Nei 1987, Studier & Keppler 1988 O(n^3) form),
vectorized over NumPy rows.

Produces the same tree family the reference workflow gets from its external
tools (rapidnj/maffttree; TWILIGHT workflow/rules/twilight.smk) so the
iterative mode can run self-contained.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def neighbor_joining(dist: np.ndarray, names: Sequence[str]) -> str:
    """Return a Newick string (rooted at the final 3-way join) for the given
    symmetric distance matrix. Ties break toward the lowest index pair, so
    output is deterministic."""
    n = dist.shape[0]
    if n == 0:
        raise ValueError("empty distance matrix")
    if n == 1:
        return f"({names[0]}:0);"
    if n == 2:
        d = max(float(dist[0, 1]), 0.0) / 2.0
        return f"({names[0]}:{d:.6f},{names[1]}:{d:.6f});"

    D = dist.astype(np.float64).copy()
    np.fill_diagonal(D, 0.0)
    # subtree Newick fragment per active node
    labels: List[str] = list(names)
    active = list(range(n))

    while len(active) > 2:
        m = len(active)
        sub = D[np.ix_(active, active)]
        r = sub.sum(axis=1)
        q = (m - 2) * sub - r[:, None] - r[None, :]
        np.fill_diagonal(q, np.inf)
        flat = int(np.argmin(q))
        i, j = flat // m, flat % m
        if i > j:
            i, j = j, i
        dij = sub[i, j]
        li = 0.5 * dij + (r[i] - r[j]) / (2.0 * (m - 2))
        lj = dij - li
        li = max(li, 0.0)
        lj = max(lj, 0.0)
        ai, aj = active[i], active[j]
        new_label = f"({labels[ai]}:{li:.6f},{labels[aj]}:{lj:.6f})"

        # distances of the new node u to every other active node k
        du = 0.5 * (sub[i, :] + sub[j, :] - dij)
        # reuse slot ai for u
        for idx, k in enumerate(active):
            D[ai, k] = D[k, ai] = du[idx]
        D[ai, ai] = 0.0
        labels[ai] = new_label
        active.pop(j)

    ai, aj = active
    d = max(float(D[ai, aj]), 0.0)
    return f"({labels[ai]}:{d / 2.0:.6f},{labels[aj]}:{d / 2.0:.6f});"
