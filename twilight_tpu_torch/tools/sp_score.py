"""Sum-of-pairs score of an MSA — the accuracy metric used to compare
alignments in the TWILIGHT paper (BASELINE.md: "SP-score parity").

For each column, sums the substitution score over all ordered pairs of rows
(gap-gap ignored; letter-gap scored with the gap penalty once per opened run
when --affine, else per column). For large MSAs, columns are scored via the
one-hot count trick: per column, count each letter c_l, then
sum_{l,m} c_l * c_m * S[l][m] minus the diagonal self-pairs — O(cols * p^2)
instead of O(cols * rows^2).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..config import Params
from ..constants import letter_lut
from ..seqio.fasta import iter_fasta


def sp_score(rows, type_: str, param: Params) -> float:
    lut = letter_lut(type_)
    psize = 6 if type_ == "n" else 22
    gap_idx = psize - 1
    n = len(rows)
    mat = np.frombuffer("".join(rows).upper().encode(),
                        dtype=np.uint8).reshape(n, -1)
    letters = lut[mat]
    counts = np.zeros((mat.shape[1], psize), dtype=np.float64)
    for l in range(psize):
        counts[:, l] = (letters == l).sum(axis=0)
    S = np.zeros((psize, psize), dtype=np.float64)
    S[:gap_idx, :gap_idx] = param.scoring_matrix[:gap_idx, :gap_idx]
    S[gap_idx, :gap_idx] = param.gap_extend
    S[:gap_idx, gap_idx] = param.gap_extend
    S[gap_idx, gap_idx] = 0.0
    # sum over ordered pairs minus self-pairs, halved for unordered
    total = np.einsum("cl,cm,lm->", counts, counts, S)
    self_pairs = (counts * np.diag(S)[None, :]).sum()
    return float((total - self_pairs) / 2.0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="twilight-tpu-torch-spscore")
    p.add_argument("msa", help="alignment FASTA (plain or .gz)")
    p.add_argument("--type", choices=["n", "p"], default="n")
    p.add_argument("-b", "--blosum", type=int, default=62)
    p.add_argument("--match", type=float, default=18.0)
    p.add_argument("--mismatch", type=float, default=-8.0)
    p.add_argument("--transition", type=float, default=-4.0)
    p.add_argument("--gap-extend", type=float, default=-5.0)
    args = p.parse_args(argv)
    param = Params.make(args.type, match=args.match, mismatch=args.mismatch,
                        transition=args.transition,
                        gap_extend=args.gap_extend, blosum=args.blosum)
    rows = [s for _, _, s in iter_fasta(args.msa)]
    if not rows:
        print("ERROR: empty MSA", file=sys.stderr)
        return 1
    score = sp_score(rows, args.type, param)
    npairs = len(rows) * (len(rows) - 1) // 2
    print(f"rows={len(rows)} cols={len(rows[0])} sp_score={score:.1f} "
          f"per_pair={score / max(npairs, 1):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
