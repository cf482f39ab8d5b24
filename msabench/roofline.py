"""The TALCO kernel's operations and bytes, and the H100's peaks.

A frozen copy of the port's table (`tools/talco_inputs.py`), with the
bytes counted from the pairs' shapes rather than from the batcher's
staging buffer: each input profile (or letter code) read once, each path
letter and tail written once.
"""
from __future__ import annotations

# f32 operations per DP cell of talco_xdrop.cu: similarity<P> (P = 6: 5
# rows of 10 mul + 5 add, 2 x 5 gap terms of 2 mul + 1 add, 1 div = 106;
# P = 22: 21 rows of 16 + 24 + 15 + 7 + 1, 2 x 21 gap terms of 3, 1 div =
# 1450; leaf: a matrix entry + 0.0f = 1) plus the recurrence (5 adds: the
# match and 4 gap terms; 6 compares: 2 gap pointers, 2 for the best
# state, the X-drop cut, the live test; 4 selects; the max = 16)
OPS_PER_CELL = {(6, False): 122, (6, True): 17, (22, False): 1466,
                (22, True): 17}
F32_PEAK = 67e12       # H100 SXM, f32 outside the tensor cores, at 700 W
HBM_PEAK = 3.35e12     # H100 SXM device memory, bytes/s
TAIL_BYTES = 16        # [len, err, dp_cells, diagonals] int32


def pair_ops(cells: int, p: int, leaf: bool) -> float:
    """f32 operations of a pair's band of `cells` DP cells."""
    return float(cells) * OPS_PER_CELL[(p, leaf)]


def pair_bytes(rl: int, ql: int, path_len: int, p: int, leaf: bool) -> float:
    """Bytes a pair needs moved: a letter code a column (leaf), or the
    profile's p f32 rows plus gap open and extend (freq), on each side;
    then the path and the tail."""
    per_col = 1 if leaf else 4 * (p + 2)
    return float((rl + ql) * per_col + max(path_len, 0) + TAIL_BYTES)


def bound_s(ops: float, nbytes: float) -> float:
    """The least seconds the card could take: operations over the f32 peak
    or bytes over the memory rate, whichever is longer."""
    return max(ops / F32_PEAK, nbytes / HBM_PEAK)
