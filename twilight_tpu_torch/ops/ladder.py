"""A pair's DP rules, each written once: the gap_char rule, the retry
ladder's starting state and its step, and the host ladder that applies
them on the host kernel (TWILIGHT src/alignment-cpu.cpp:95-130).

The batcher (`device_kernel.DeviceTalco`) packs a pair's gap_char and
starting state from here and relaunches a pair that the card answers with
error 1 or 2 by `step`; the pipeline (`pipeline/aligner.py`) and the
batcher's host stealing run `run_talco_with_retries`. So the card and the
host take the same decisions for every pair.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..config import Options, Params, TalcoParams
from . import talco_host, talco_np


def gap_char_zero(task: int, rnum, qnum) -> bool:
    """Whether the pair's gap_char score is 0 and not gap_extend: when
    merging (tasks 1 and 2), or where a side holds more than 10000
    sequences."""
    return task in (1, 2) or rnum > 10000 or qnum > 10000


def start(param: Params) -> Tuple[int, int]:
    """The ladder's starting (flen, xdrop): the kernel's own band width and
    X-drop (`config.TalcoParams`)."""
    tp = TalcoParams.from_params(param)
    return tp.flen, tp.xdrop


def step(err: int, flen: int, xdrop: int, lens) -> Tuple[int, int]:
    """The ladder's next (flen, xdrop) after error 1 (the X-drop band
    collapsed: twice the X-drop, and a width of eight times it) or error 2
    (the band outgrew flen: 2.4 times the width), the width capped at the
    pair's shorter side."""
    if err == 2:
        return min(int(flen * 1.2) << 1, min(lens)), xdrop
    xdrop = int(xdrop * 2)
    return min(int(xdrop * 4) << 1, min(lens)), xdrop


def run_talco_with_retries(freq_ref, freq_qry, gap_op, gap_ex, num, lens,
                           param: Params, zero_gap_char: bool,
                           current_task: int, option: Options,
                           flen: Optional[int] = None
                           ) -> Tuple[Optional[np.ndarray], bool]:
    """The reference retry ladder on the native host kernel (the NumPy
    oracle under --backend numpy or without a toolchain), from the
    starting state, or from width `flen` where given (the dry run's
    oracle, from its batcher's base_flen). Returns (path or None,
    needs_fallback)."""
    flen0, xdrop = start(param)
    tp = talco_np.TalcoRunParams(
        matrix=param.scoring_matrix,
        gap_open=param.gap_open,
        gap_extend=param.gap_extend,
        gap_char_score=0.0 if zero_gap_char else param.gap_extend,
        xdrop=xdrop, flen=flen or flen0)
    impl = talco_np.align_freq
    if option.device_backend != "numpy" and talco_host.available():
        impl = talco_host.align_freq
    while True:
        aln, err = impl(tp, freq_ref, freq_qry, gap_op, gap_ex, num)
        if err == 0 and len(aln):
            return aln, False
        if current_task == 0 and err != 0:
            return None, True
        if err in (1, 2):
            tp.flen, tp.xdrop = step(err, tp.flen, tp.xdrop, lens)
        elif err == 3:
            raise RuntimeError("TALCO index error (errorType 3)")
        else:
            return aln, False


def align_prepared(prep, meta, task: int, param: Params, option: Options,
                   flen: Optional[int] = None
                   ) -> Tuple[Optional[np.ndarray], bool]:
    """`run_talco_with_retries` on one prepared pair (the 7-tuple of
    `pipeline/aligner._prepare_pair`, its profiles cut to their lengths as
    the batcher packs them) whose meta is (ref_len, qry_len, ref_num,
    qry_num)."""
    freq_ref, freq_qry, _, _, lens, gap_op, gap_ex = prep
    rnum, qnum = meta[2], meta[3]
    return run_talco_with_retries(
        freq_ref[:lens[0]], freq_qry[:lens[1]], gap_op, gap_ex,
        (float(rnum), float(qnum)), lens, param,
        gap_char_zero(task, rnum, qnum), task, option, flen)
