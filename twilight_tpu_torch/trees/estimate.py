"""Sequence -> guide tree estimation.

Two distance modes:
  - unaligned sequences: hashed k-mer count profiles; distance is the
    cosine-angle metric d = -ln(max(cos, eps)) (Mash-like). The Gram matrix
    X @ X.T is one large f32 matmul, always on the host (NumPy): the card
    sums its contraction in another order, its low bits reach the tree's
    branch lengths, and the workflow's output must be the host route's.
  - aligned sequences (iterative re-estimation, replacing the workflow's
    FastTree step): normalized Hamming p-distance over non-gap columns,
    with gappy columns masked first (the reference workflow's reduceLen.py
    does the same masking before tree inference). The match and valid
    counts are exact integers, on the GPU (`pair_counts_on`) or in NumPy.

Scaling: PartTree-style recursion (MAFFT PartTree; the reference workflow
exposes it as the `parttree` tool option): when n > nj_cap, sample seeds,
NJ the seeds, assign every sequence to its nearest seed, recurse per group,
and graft subtrees onto the seed tree.

Routing: a count product goes to the GPU only when the caller's device is
a CUDA device and the product's host estimate (2 n m k flops at
HOST_FLOPS) exceeds GATE_ROUND_TRIPS round trips of the card route. A product on the
card either runs or raises: there is no host fallback behind it. Without a
device the NumPy code below runs, operation for operation the JAX
package's host code.
"""
from __future__ import annotations

import contextlib
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import trace
from ..pipeline.aligner import GATE_ROUND_TRIPS
from .nj import neighbor_joining

_TAG = "[twilight-tpu-torch]"
# the host estimate's sgemm rate (flop/s), the JAX package's figure for
# one core
HOST_FLOPS = 3e10
# One round trip of the card route: chip_smoke.py's `products` phase
# (pair_counts_on of a [64, 1024] letter block, 4 letters: upload, the
# one-hots, both products, download; the median of 50 by the host clock)
# on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit: 0.213 ms.
PRODUCT_ROUND_TRIP_S = 0.213e-3
CARD_MIN_EST_S = GATE_ROUND_TRIPS * PRODUCT_ROUND_TRIP_S
# bytes of one block of a product's output on the card
OUT_BLOCK_BYTES = 1 << 30
# the JAX package's cut-off (seconds of host estimate) above which its
# host Gram product runs in row blocks; kept so the bytes stay its bytes
_HOST_ROW_BLOCK_EST_S = 20.0


def _profile(line: str) -> None:
    """One of the JAX estimator's TWILIGHT_PROFILE lines (its
    estimate.py:148, 392, 401): the k-mer time, the distance matrix's
    path (the Gram product always on the host; the msa counts on the
    card or the host) and the NJ/PartTree time; printed under the
    tracer's switch (`trace.on`)."""
    if trace.on():
        print(f"  [profile] {line}", file=sys.stderr)


def host_estimate_s(n: int, m: int, k: int) -> float:
    """Seconds of host BLAS for an [n, k] x [k, m] product."""
    return 2.0 * n * m * k / HOST_FLOPS


def on_card(device: Optional[torch.device], est_s: float) -> bool:
    """Whether a product of host estimate `est_s` runs on `device`."""
    return (device is not None and device.type == "cuda"
            and est_s > CARD_MIN_EST_S)


@contextlib.contextmanager
def ieee_f32():
    """f32 products in full f32 (no TF32) inside the block; the previous
    setting comes back after it."""
    prev = torch.backends.cuda.matmul.fp32_precision
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    try:
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("TF32 still on for f32 matmuls")
        yield
    finally:
        torch.backends.cuda.matmul.fp32_precision = prev


def _block_rows(n_rows: int, out_cols: int, outputs: int = 1) -> int:
    return max(1, min(n_rows, OUT_BLOCK_BYTES // (4 * outputs
                                                   * max(out_cols, 1))))


def one_hots_on(mat: np.ndarray, letters, device: torch.device):
    """The letter bytes [n, cols] uploaded to `device` and expanded there:
    (the 0/1 one-hots with the letters folded into the columns, f32
    [n, cols * L]; the 0/1 mask of columns holding one of them, f32
    [n, cols])."""
    codes = torch.tensor([int(v) for v in letters], dtype=torch.long)
    lut_oh = torch.zeros(256, len(codes), dtype=torch.float32)
    lut_oh[codes, torch.arange(len(codes))] = 1.0
    lut_oh = lut_oh.to(device)
    m = torch.from_numpy(np.require(mat, np.uint8, ["C", "W"])) \
        .to(device).long()
    oh = lut_oh[m]
    return oh.reshape(m.shape[0], -1), oh.sum(dim=2)


def pair_counts_on(a: np.ndarray, b: Optional[np.ndarray], letters,
                   device: torch.device):
    """Exact pair counts of two letter matrices ([n, cols] and [m, cols]
    uint8; b None means a): match[i, j], the columns where a[i] and b[j]
    hold the same letter of `letters`, and valid[i, j], the columns where
    both hold one. Each f32 [n, m] on the host. The letter bytes go to
    `device`; there the 0/1 one-hots are built with the letters folded
    into the contraction (`one_hots_on`) and multiplied in f32 with TF32
    off, in row blocks of the output under OUT_BLOCK_BYTES: every count
    is an integer below 2^24, so exact in any order. On a CPU device this
    is the card route's plain version."""
    if device.type == "cuda":
        pair_counts_on.calls += 1
    oh_a, va = one_hots_on(a, letters, device)
    oh_b, vb = (oh_a, va) if b is None else one_hots_on(b, letters, device)
    n, m = oh_a.shape[0], oh_b.shape[0]
    match = np.empty((n, m), dtype=np.float32)
    valid = np.empty((n, m), dtype=np.float32)
    rows = _block_rows(n, m, outputs=2)
    with ieee_f32():
        for i0 in range(0, n, rows):
            torch.from_numpy(match[i0:i0 + rows]).copy_(
                oh_a[i0:i0 + rows] @ oh_b.T)
            torch.from_numpy(valid[i0:i0 + rows]).copy_(
                va[i0:i0 + rows] @ vb.T)
    return match, valid


pair_counts_on.calls = 0


def kmer_profiles(seqs: Sequence[str], k: int = 8,
                  dim: int = 4096) -> np.ndarray:
    """Hashed k-mer count profile per sequence, L2-normalized f32 [n, dim].
    Byte-polynomial rolling hash — alphabet-agnostic (nucleotide or
    protein); windows containing gaps/ambiguity bytes ('-', '.', 'N', 'X')
    are dropped."""
    out = np.zeros((len(seqs), dim), dtype=np.float32)
    bad = np.zeros(256, dtype=bool)
    for b in b"-.NXnx*? ":
        bad[b] = True
    with np.errstate(over="ignore"):
        for si, s in enumerate(seqs):
            codes = np.frombuffer(s.upper().encode(), dtype=np.uint8)
            n = len(codes)
            if n < k:
                out[si, 0] = 1.0
                continue
            c = codes.astype(np.int64)
            invalid = bad[codes]
            h = np.zeros(n - k + 1, dtype=np.int64)
            ok = np.ones(n - k + 1, dtype=bool)
            for off in range(k):
                h = h * np.int64(131) + c[off:off + n - k + 1]
                ok &= ~invalid[off:off + n - k + 1]
            h = h[ok]
            if len(h) == 0:
                out[si, 0] = 1.0
                continue
            h = (h.astype(np.uint64)
                 * np.uint64(0x9E3779B97F4A7C15)).astype(np.int64)
            h &= np.int64(2**63 - 1)
            idx = (h >> np.int64(20)) % dim
            np.add.at(out[si], idx, 1.0)
            norm = np.linalg.norm(out[si])
            if norm > 0:
                out[si] /= norm
    return out


def _gram(x: np.ndarray) -> np.ndarray:
    """x @ x.T on the host, whatever the device: host BLAS, in row blocks
    above the JAX package's 20 s estimate (its host route's own
    blocking)."""
    n, dim = x.shape
    if host_estimate_s(n, n, dim) > _HOST_ROW_BLOCK_EST_S:
        g = np.empty((n, n), dtype=np.float32)
        blk = max(512, n // 8)
        for i0 in range(0, n, blk):
            g[i0:i0 + blk] = x[i0:i0 + blk] @ x.T
        return g
    return x @ x.T


def pairwise_distances(profiles: np.ndarray) -> np.ndarray:
    """Cosine-angle distance matrix from L2-normalized profiles (on the
    host)."""
    cos = np.clip(_gram(profiles), 1e-6, 1.0)
    d = -np.log(cos)
    np.fill_diagonal(d, 0.0)
    return d.astype(np.float64)


def msa_columns(rows: Sequence[str], max_cols: int = 4096,
                gappy: float = 0.9):
    """(letter matrix [n, cols] uint8, its gap mask) of aligned rows:
    upper-cased, gappy columns masked, columns subsampled past
    max_cols."""
    n = len(rows)
    mat = np.frombuffer("".join(rows).upper().encode(),
                        dtype=np.uint8).reshape(n, -1)
    is_gap = (mat == ord("-")) | (mat == ord("."))
    keep = is_gap.mean(axis=0) < gappy
    mat = mat[:, keep]
    is_gap = is_gap[:, keep]
    if mat.shape[1] > max_cols:
        step = mat.shape[1] // max_cols
        mat = mat[:, ::step]
        is_gap = is_gap[:, ::step]
    return mat, is_gap


def msa_letters(mat: np.ndarray) -> List[int]:
    return [int(v) for v in np.unique(mat) if v not in (ord("-"), ord("."))]


def host_msa_counts(mat: np.ndarray, is_gap: np.ndarray, letters):
    """(match, valid) pair counts on the host: one sgemm per letter and
    one for the valid mask, f32 [n, n]."""
    n = mat.shape[0]
    valid = (~is_gap).astype(np.float32)
    m = np.zeros((n, n), dtype=np.float32)
    for l in letters:
        a = ((mat == l) & ~is_gap).astype(np.float32)
        m += a @ a.T
    return m, valid @ valid.T


def msa_distances(rows: Sequence[str], max_cols: int = 4096,
                  gappy: float = 0.9,
                  device: Optional[torch.device] = None) -> np.ndarray:
    """p-distances from aligned rows: mask gappy columns, subsample columns,
    then mismatch fraction over mutually non-gap positions.

    From 256 rows the match/valid pair counts are products of 0/1
    matrices (exact integers in f32): on the card (`pair_counts_on`) when
    `device` is a CUDA device and the host estimate passes the gate, else
    one host sgemm per letter; below 256 rows a per-row NumPy loop."""
    n = len(rows)
    mat, is_gap = msa_columns(rows, max_cols, gappy)
    if n >= 256:
        letters = msa_letters(mat)
        host_est_s = host_estimate_s(n, n,
                                     mat.shape[1] * (len(letters) + 1))
        card = on_card(device, host_est_s)
        if card:
            m, b = pair_counts_on(mat, None, letters, device)
        else:
            m, b = host_msa_counts(mat, is_gap, letters)
        _profile(f"distance matrix: {'card' if card else 'host'} path")
        d = (b.astype(np.float64) - m.astype(np.float64)) \
            / np.maximum(b.astype(np.float64), 1.0)
        np.fill_diagonal(d, 0.0)
        return d
    _profile("distance matrix: host path")
    d = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        both = ~(is_gap[i] | is_gap)          # [n, cols]
        diff = (mat[i] != mat) & both
        denom = np.maximum(both.sum(axis=1), 1)
        d[i] = diff.sum(axis=1) / denom
    np.fill_diagonal(d, 0.0)
    return d


def _nj_or_recurse(dist: np.ndarray, names: List[str], nj_cap: int,
                   rng: np.random.Generator) -> str:
    n = len(names)
    if n <= nj_cap:
        return neighbor_joining(dist, names)
    # PartTree-style: seeds -> NJ -> assign -> recurse
    n_seeds = max(2, int(np.sqrt(n)))
    seeds = rng.choice(n, size=n_seeds, replace=False)
    assign = np.argmin(dist[:, seeds], axis=1)
    groups = [np.nonzero(assign == gi)[0] for gi in range(n_seeds)]
    sub_newicks: List[Optional[str]] = [None] * n_seeds
    kept_seeds: List[int] = []
    for gi, grp in enumerate(groups):
        if len(grp) == 0:
            continue
        kept_seeds.append(gi)
        sub = dist[np.ix_(grp, grp)]
        nw = _nj_or_recurse(sub, [names[i] for i in grp], nj_cap, rng)
        sub_newicks[gi] = nw[:-1].rstrip()  # strip ';'
    if len(kept_seeds) == 1:
        return sub_newicks[kept_seeds[0]] + ";"
    seed_idx = seeds[kept_seeds]
    seed_dist = dist[np.ix_(seed_idx, seed_idx)]
    # the grafting below splices sub-newicks over placeholder leaf labels
    # via str.replace; grow the tag until no sequence name contains it so a
    # name like "x__G1__y" can never be rewritten (every placeholder
    # contains the tag, so tag-free names are replace-safe)
    tag = "__G"
    while any(tag in nm for nm in names):
        tag = "_" + tag
    placeholder = [f"{tag}{gi}__" for gi in kept_seeds]
    skeleton = neighbor_joining(seed_dist, placeholder)
    for gi in kept_seeds:
        skeleton = skeleton.replace(f"{tag}{gi}__", sub_newicks[gi])
    return skeleton


def build_guide_tree(names: Sequence[str], seqs: Sequence[str],
                     aligned: bool = False, k: int = 8,
                     nj_cap: int = 2000, seed: int = 0,
                     device: Optional[torch.device] = None,
                     steps: Optional[list] = None) -> str:
    """Estimate a Newick guide tree for the given sequences.

    aligned=False: k-mer sketch distances (initial iteration).
    aligned=True: MSA p-distances (re-estimation between iterations).
    device: where the msa count products may run (see the module's
    docstring); None keeps them on the host. The Gram product of the
    k-mer profiles always runs on the host. steps: a list that gets one
    (name, seconds) a step: "kmer", "gram" or "msa distances", "nj".
    """
    steps = [] if steps is None else steps
    t0 = time.time()
    if aligned:
        dist = msa_distances(seqs, device=device)
        steps.append(("msa distances", time.time() - t0))
    else:
        prof = kmer_profiles(seqs, k=k)
        t1 = time.time()
        steps.append(("kmer", t1 - t0))
        _profile(f"k-mer profiles: {t1 - t0:.1f}s")
        dist = pairwise_distances(prof)
        steps.append(("gram", time.time() - t1))
        _profile("distance matrix: host path")
    rng = np.random.default_rng(seed)
    print(f"{_TAG} estimated distances for {len(names)} sequences "
          f"in {time.time() - t0:.1f}s", file=sys.stderr)
    t1 = time.time()
    nwk = _nj_or_recurse(dist, list(names), nj_cap, rng)
    steps.append(("nj", time.time() - t1))
    _profile(f"NJ/PartTree: {time.time() - t1:.1f}s")
    return nwk
