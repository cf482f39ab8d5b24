"""TALCO-XDrop on an NVIDIA Hopper GPU: the CUDA kernel's wrapper and its
plain PyTorch version.

The counterpart of every TALCO TPU kernel of the repo (K1-K5), as size
variants of one kernel (`csrc/talco_xdrop.cu`):

- the grouped Pallas kernel `twilight_tpu/ops/talco_pallas_g8.py`
  (`get_pallas_kernel_g8`, `pallas_call` at :1672): its freq route
  (`_make_kernel(leaf=False)`, K1), its leaf route (`leaf=True`,
  `similarity_leaf`, K2), the work of its escalated-window variant
  (`hbm_tb=True`, K3) and its long-sequence variant (`hbm_in=True`,
  padlen above 2048, K4);
- the single-pair kernel `twilight_tpu/ops/talco_pallas.py`
  (`get_pallas_kernel`, `pallas_call` at :579, K5): ladder widths above
  4096 up to `MAX_WINDOW`, and padlen above 32768.

The kernel reads the profiles straight from global memory at any padlen,
and sizes each pair's scratch from the pair's own tile-width bound, so it
never overflows a static window and never returns error 6: K3, K4 and K5
need no code of their own, only a launch of the right size.

Launch configuration (the kernel's `make_layout`; `launch_config` asks the
built library for it): one block per pair of 256 consumer threads, plus 256
producer threads on the freq route that score the similarity ahead into a
ring in shared memory; the rolling rows of band offsets below `W_S` live in
shared memory, the rest in the pair's scratch.

Batch layout (the g8 compact layout; `device_kernel.pack_batch` fills it):

- `ints`   int32 [4, B]: ref_len, qry_len, flen (ladder width), xdrop
- `floats` f32   [5, B]: ref_num, qry_num, gap_char, gap_open, gap_extend
- `offs`   int64 [B+1]: per-pair scratch byte offsets (`scratch_offsets`)
- `ref`, `qry`: freq route f32 [B, P8, padlen] (profile rows 0..P-1, gap
  open/extend rows P8-2/P8-1), leaf route int8 [B, 1, padlen] letter
  codes. The ref is reversed and right-aligned at padlen; the query is
  left-aligned. Any padlen from 1 to `MAX_LAUNCH_PADLEN` is accepted.

Outputs: `paths` int8 [B, 2*padlen] (0 match, 1 insertion, 2 deletion)
and `tail` int32 [B, 4] = [len, err, dp_cells, diagonals], dp_cells
saturated at INT32_MAX. Errors: 0 ok, 1 X-drop band collapse, 2 band
exceeded flen, 3 index error. The kernel reports ERR_LAYOUT for a pair
whose lengths or scratch do not match the batch (`offs`), that is longer
than the launch's padlen, or whose tile-width bound min(flen, ref_len,
qry_len) exceeds `MAX_WINDOW`, which a correct packer never produces.
"""
from __future__ import annotations

import collections
import ctypes
import threading
from typing import List, Tuple

import numpy as np
import torch

from . import ladder

I_BOUNDARY = -2
D_BOUNDARY = -3
I_BOUNDARY_LOW16 = I_BOUNDARY & 0xFFFF
D_BOUNDARY_LOW16 = D_BOUNDARY & 0xFFFF

MARKER = 1 << 10
MAX_WINDOW = 1 << 15       # widest ladder width run on the card (the JAX
                           # package's max_window, device_kernel.py:195)
TAIL = 4                   # [len, err, dp_cells, diagonals]
INT32_MAX = (1 << 31) - 1  # dp_cells saturates here
MAX_LAUNCH_PADLEN = INT32_MAX >> 2   # paths [B, 2*padlen] index in int
ERR_LAYOUT = 8
_F32 = np.float32

W_S = 2048   # band offsets whose rolling rows are in shared memory


def p8_of(p: int) -> int:
    return 8 if p == 6 else 24


def pair_scratch_bytes(ref_len: int, qry_len: int, flen: int,
                       marker: int = MARKER) -> int:
    """Global-memory scratch of one pair, from its tile-width bound
    w = min(flen, ref_len, qry_len): the rolling S/I/D (f32) and CS/CI/CD
    (i32) rows (3+2+2 each) of the offsets at or above W_S (the rest are
    in shared memory), the traceback store ((marker+1) x w bytes) and the
    tile path buffer. Must match `pair_need` in talco_xdrop.cu."""
    w = max(1, min(flen, ref_len, qry_len))
    need = 56 * max(0, w - W_S) + (marker + 1) * w + ref_len + qry_len + 8
    return (need + 255) // 256 * 256


def scratch_offsets(ref_len, qry_len, flen, marker: int = MARKER
                    ) -> np.ndarray:
    """int64 [B+1] exclusive prefix sums of `pair_scratch_bytes`."""
    offs = np.zeros(len(ref_len) + 1, dtype=np.int64)
    for b, (rl, ql, fl) in enumerate(zip(ref_len, qry_len, flen)):
        offs[b + 1] = offs[b] + pair_scratch_bytes(int(rl), int(ql),
                                                   int(fl), marker)
    return offs


def device_params(param, device) -> Tuple[torch.Tensor, dict]:
    """The scoring state a launch needs: the f32 substitution matrix on
    `device`, and the scalars as f32-exact Python floats."""
    mat = torch.as_tensor(np.ascontiguousarray(
        param.scoring_matrix, dtype=np.float32)).to(device)
    scalars = {"gap_open": float(_F32(param.gap_open)),
               "gap_extend": float(_F32(param.gap_extend)),
               "xdrop": ladder.start(param)[1]}
    return mat, scalars


# ----------------------------------------------------------------------
# wrapper
# ----------------------------------------------------------------------

def _check(ints, floats, offs, ref, qry, matrix, p):
    if p not in (6, 22):
        raise ValueError(f"profile size must be 6 or 22, got {p}")
    if ref.dim() != 3 or ref.shape != qry.shape:
        raise ValueError("ref/qry must be [B, rows, padlen] of equal shape")
    b, rows, padlen = ref.shape
    leaf = ref.dtype == torch.int8
    if leaf:
        if rows != 1 or qry.dtype != torch.int8:
            raise ValueError("leaf blocks must be int8 [B, 1, padlen]")
    elif ref.dtype != torch.float32 or qry.dtype != torch.float32 \
            or rows != p8_of(p):
        raise ValueError(f"freq blocks must be f32 [B, {p8_of(p)}, padlen]")
    if not 1 <= padlen <= MAX_LAUNCH_PADLEN:
        raise ValueError(f"padlen must be in 1..{MAX_LAUNCH_PADLEN}")
    if ints.dtype != torch.int32 or tuple(ints.shape) != (4, b):
        raise ValueError("ints must be int32 [4, B]")
    if floats.dtype != torch.float32 or tuple(floats.shape) != (5, b):
        raise ValueError("floats must be f32 [5, B]")
    if offs.dtype != torch.int64 or tuple(offs.shape) != (b + 1,):
        raise ValueError("offs must be int64 [B+1]")
    if matrix.dtype != torch.float32 or matrix.dim() != 2 \
            or matrix.shape[0] != matrix.shape[1] \
            or matrix.shape[0] < p - 1:
        raise ValueError("matrix must be a square f32 [msize, msize] "
                         "with msize >= P-1")
    for t in (ints, floats, offs, ref, qry, matrix):
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")
        if t.device != ref.device:
            raise ValueError("all inputs must be on one device")
    return b, padlen, leaf


def talco_align(ints, floats, offs, ref, qry, matrix, *, p: int,
                scratch_bytes: int, marker: int = MARKER, out=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """TALCO-XDrop over a batch of profile pairs (layout: module doc).

    CUDA tensors launch `talco_xdrop.cu` on the current stream (no
    synchronisation; a launch the kernel refuses raises). CPU tensors run
    `talco_align_reference`.
    `scratch_bytes` is `offs[-1]` as the host computed it. `out`,
    optional, is a (paths, tail) pair to write into."""
    b, padlen, leaf = _check(ints, floats, offs, ref, qry, matrix, p)
    dev = ref.device
    if out is None:
        out = (torch.empty((b, 2 * padlen), dtype=torch.int8, device=dev),
               torch.empty((b, TAIL), dtype=torch.int32, device=dev))
    paths, tail = out
    if paths.dtype != torch.int8 or tuple(paths.shape) != (b, 2 * padlen) \
            or tail.dtype != torch.int32 or tuple(tail.shape) != (b, TAIL) \
            or not paths.is_contiguous() or not tail.is_contiguous() \
            or paths.device != dev or tail.device != dev:
        raise ValueError("out must be (int8 [B, 2*padlen], int32 [B, 4]) "
                         "contiguous on the inputs' device")
    if dev.type == "cpu":
        rp, rt = talco_align_reference(ints, floats, ref, qry, matrix,
                                       p=p, marker=marker)
        paths.copy_(rp)
        tail.copy_(rt)
        return paths, tail
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if b == 0:
        return paths, tail
    from . import build
    lib = build.load()
    vp = ctypes.c_void_p
    # cudaLaunchKernel (and the kernel's shared-memory attribute) act on
    # the calling thread's current device: make it the tensors' device
    with torch.cuda.device(dev):
        scratch = torch.empty(max(int(scratch_bytes), 256),
                              dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.talco_xdrop_launch(
            p, int(leaf), vp(ints.data_ptr()), vp(floats.data_ptr()),
            vp(offs.data_ptr()), vp(ref.data_ptr()), vp(qry.data_ptr()),
            vp(matrix.data_ptr()), matrix.shape[0],
            vp(scratch.data_ptr()), scratch.numel(),
            vp(paths.data_ptr()), vp(tail.data_ptr()),
            b, padlen, marker, vp(stream))
    if rc != 0:
        raise RuntimeError(f"talco_xdrop launch failed: "
                           f"{build.error_string(rc)} (cudaError {rc})")
    with _launches_lock:
        talco_align.launches += 1
        talco_align.by_instance[instance_name(p, leaf)] += 1
    return paths, tail


def instance_name(p: int, leaf: bool) -> str:
    """The kernel instance a launch of `p` profile rows takes, as the
    build names it: talco_xdrop_kernel<P, LEAF>."""
    return f"talco_xdrop_kernel<{p}, {'true' if leaf else 'false'}>"


# launches of the kernel, in all and by instance; a caller zeroes them
# (launches = 0, by_instance.clear()) before the run it counts
talco_align.launches = 0
talco_align.by_instance = collections.Counter()
_launches_lock = threading.Lock()   # the batcher launches off the main thread


def launch_config(leaf: bool, marker: int = MARKER, msize: int = 32) -> dict:
    """The launch configuration of the kernel instance (needs the built
    library): the block's dynamic shared memory (the reduction partials,
    the substitution matrix, ftr_length/ftr_lower_limit, the convergence
    bitmasks, the rolling rows of W_S offsets and, on the freq route, the
    similarity ring sized to the rest), W_S, ring cells a slot, producer
    and consumer threads, ring slots, the shared-memory limit and the
    widest tile bound. Raises ValueError for a configuration the kernel
    refuses."""
    from . import build
    out = (ctypes.c_longlong * 8)()
    rc = build.load().talco_xdrop_config(int(leaf), marker, msize, out)
    if rc != 0:
        raise ValueError(f"the kernel refuses marker {marker}, msize "
                         f"{msize}")
    keys = ("smem_bytes", "w_s", "ring_cells", "producers", "consumers",
            "ring_slots", "smem_limit", "max_width")
    return dict(zip(keys, (int(v) for v in out)))


def kernel_attributes(p: int, leaf: bool) -> dict:
    """cudaFuncGetAttributes of the kernel instance <p, leaf> (needs a
    CUDA device): registers and local (spill) bytes per thread, static
    shared bytes, maximum threads per block and dynamic shared bytes."""
    from . import build
    out = (ctypes.c_int * 7)()
    rc = build.load().talco_xdrop_attributes(p, int(leaf), out)
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: "
                           f"{build.error_string(rc)} (cudaError {rc})")
    keys = ("registers", "local_bytes", "static_shared_bytes",
            "max_threads_per_block", "max_dynamic_shared_bytes",
            "ptx_version", "binary_version")
    return dict(zip(keys, (int(v) for v in out)))


def resident_blocks(p: int, leaf: bool, device, msize: int = 32) -> int:
    """Blocks of the kernel instance <p, leaf> that CUDA `device` holds
    at once: its SMs times the blocks one SM keeps resident, by the CUDA
    occupancy calculation over the instance's threads, registers and
    shared memory (`kernel_attributes`, `launch_config`) and the
    device's limits. A launch of more blocks runs in several waves."""
    props = torch.cuda.get_device_properties(device)
    with torch.cuda.device(device):
        attr = kernel_attributes(p, leaf)
    cfg = launch_config(leaf, msize=msize)
    warp = props.warp_size
    warps = -(-(cfg["consumers"] + cfg["producers"]) // warp)
    by_threads = props.max_threads_per_multi_processor // (warps * warp)
    # registers go to a warp in units of 256
    regs_warp = -(-attr["registers"] * warp // 256) * 256
    by_regs = props.regs_per_multiprocessor // (regs_warp * warps)
    # an SM reserves for each block what it holds beyond the most that
    # one block may opt in to
    reserved = (props.shared_memory_per_multiprocessor
                - props.shared_memory_per_block_optin)
    smem = attr["static_shared_bytes"] + cfg["smem_bytes"] + reserved
    by_smem = props.shared_memory_per_multiprocessor // smem
    return props.multi_processor_count * min(by_threads, by_regs, by_smem)


# ----------------------------------------------------------------------
# plain PyTorch version: talco_np.tile / align_freq transcribed to torch
# tensors, one pair at a time, each anti-diagonal vectorised
# ----------------------------------------------------------------------

def _similarity(r, q, mat, gap_char: float, den: float):
    """Expected profile score per cell in the oracle's f32 order
    (talco_np.similarity_scores): separate multiplies and adds, the
    per-l partial sums added left to right."""
    n, p = r.shape
    num = torch.zeros(n, dtype=torch.float32, device=r.device)
    if p == 6:
        t = (q[:, None, :5] * mat[:5, :5]) * r[:, :5, None]   # [n, l, m]
        s = t[:, :, 0]
        for m in range(1, 5):
            s = s + t[:, :, m]
        for l in range(5):
            num = num + s[:, l]
        g = (r[:, :5] * q[:, 5:6]) * gap_char
        for l in range(5):
            num = num + g[:, l]
        g = (r[:, 5:6] * q[:, :5]) * gap_char
        for m in range(5):
            num = num + g[:, m]
    else:
        sv = (q[:, None, 0:8] * mat[:21, 0:8]) * r[:, :21, None]
        sv = sv + (q[:, None, 8:16] * mat[:21, 8:16]) * r[:, :21, None]
        tl = (r[:, :21, None] * q[:, None, 16:21]) * mat[:21, 16:21]
        hs = sv[:, :, 0]
        for j in range(1, 8):
            hs = hs + sv[:, :, j]
        for l in range(21):
            for m in range(5):
                num = num + tl[:, l, m]
            num = num + hs[:, l]
        g = (r[:, :21] * q[:, 21:22]) * gap_char
        for l in range(21):
            num = num + g[:, l]
        g = (r[:, 21:22] * q[:, :21]) * gap_char
        for m in range(21):
            num = num + g[:, m]
    return num / den


class _Pair:
    """One unpacked pair: forward-order profiles (or letter codes), the
    position-specific gap rows and the per-pair scalars."""

    def __init__(self, b, iv, fv, ref, qry, mat, p, leaf, marker):
        self.rl, self.ql, self.flen, self.xdrop = (int(iv[r][b])
                                                   for r in range(4))
        ref_num, qry_num, gap_char, go, ge = (_F32(fv[r][b])
                                              for r in range(5))
        self.den = float(ref_num * qry_num)
        self.gap_char = float(gap_char)
        self.marker = marker
        padlen = ref.shape[2]
        rl, ql = self.rl, self.ql
        dev = ref.device
        if leaf:
            nlet = p - 1
            ext = torch.zeros((nlet + 1, nlet + 1), dtype=torch.float32,
                              device=dev)
            ext[:nlet, :nlet] = mat[:nlet, :nlet]
            rc = ref[b, 0, padlen - rl:].flip(0).long()
            qc = qry[b, 0, :ql].long()
            self.rc = torch.where((rc >= 0) & (rc < nlet), rc, nlet)
            self.qc = torch.where((qc >= 0) & (qc < nlet), qc, nlet)
            self.ext = ext
            self.go_r = torch.full((rl,), float(go), device=dev)
            self.go_q = torch.full((ql,), float(go), device=dev)
            self.ge_r = torch.full((rl,), float(ge), device=dev)
            self.ge_q = torch.full((ql,), float(ge), device=dev)
        else:
            p8 = ref.shape[1]
            self.fr = ref[b, :p, padlen - rl:].flip(1).t()
            self.fq = qry[b, :p, :ql].t()
            self.go_r = ref[b, p8 - 2, padlen - rl:].flip(0)
            self.ge_r = ref[b, p8 - 1, padlen - rl:].flip(0)
            self.go_q = qry[b, p8 - 2, :ql]
            self.ge_q = qry[b, p8 - 1, :ql]
            self.mat = mat
        self.leaf = leaf
        self.gap_open = float(go)
        self.gap_extend = float(ge)

    def sim(self, rpos, qpos):
        if self.leaf:
            # one-hot unit-weight columns score exactly the matrix entry;
            # + 0.0 turns a -0.0 entry into the +0.0 the oracle's sum gives
            return self.ext[self.rc[rpos], self.qc[qpos]] + 0.0
        return _similarity(self.fr[rpos], self.fq[qpos], self.mat,
                           self.gap_char, self.den)


def _reduction(c, flen: int, start: int, length: int) -> int:
    start = min(start, flen - 1)
    if length < 0:
        return int(c[start])
    end = min(start + length, flen - 1)
    seg = c[start:end + 1]
    conv = int(seg[0])
    return conv if bool((seg == conv).all()) else -1


def _traceback(ftr_length, ftr_lower_limit, addr, ftr, state, idx,
               ref_start_idx, tb: List[int], aln: List[int],
               first_tile: bool) -> bool:
    query_idx = idx
    ref_idx = ref_start_idx
    while ftr >= 0:
        if addr < 0 or addr >= len(tb):
            return False
        v = tb[addr]
        if state == 0:
            state = v & 0x03
            if state == 0:
                d = 0
            elif state == 1:
                d = 1
                state = 1 if (v & 0x04) else 0
            else:
                d = 2
                state = 2 if (v & 0x08) else 0
        elif state == 1:
            d = 1
            state = 1 if (v & 0x04) else 0
        else:
            d = 2
            state = 2 if (v & 0x08) else 0
        if ftr > 0:
            addr = addr - (idx - ftr_lower_limit[ftr] + 1) - ftr_length[ftr - 1]
        if d == 0:
            if ftr > 1:
                addr = addr - ftr_length[ftr - 2] + (idx - ftr_lower_limit[ftr - 2])
            ftr -= 2
            idx -= 1
            query_idx -= 1
            ref_idx -= 1
        elif d == 1:
            if ftr > 0:
                addr = addr + (idx - ftr_lower_limit[ftr - 1])
            ftr -= 1
            idx -= 1
            query_idx -= 1
        else:
            if ftr > 0:
                addr = addr + (idx - ftr_lower_limit[ftr - 1] + 1)
            ftr -= 1
            ref_idx -= 1
        aln.append(d)
        if first_tile and (ref_idx < 0 or query_idx < 0):
            break
    if first_tile:
        aln.extend([2] * (ref_idx + 1))
        aln.extend([1] * (query_idx + 1))
    return True


def _tile(pr: _Pair, reference_idx: int, query_idx: int, tile_no: int,
          work: list):
    """One tile (talco_np.tile). Returns (tile_aln in traceback order,
    reference_idx, query_idx, last_tile, err); adds the diagonals and
    cells it computed to work = [cells, diagonals]."""
    marker = pr.marker
    xdrop = _F32(pr.xdrop)
    neg_inf = float(-_F32(2.0 * pr.xdrop + 1.0))
    ref_total, qry_total = pr.rl, pr.ql
    ref_len = ref_total - reference_idx
    qry_len = qry_total - query_idx
    if ref_len < 0 or qry_len < 0:
        return [], reference_idx, query_idx, True, 3
    flen = min(pr.flen, ref_len, qry_len)
    dev = pr.go_r.device
    f32 = torch.float32
    i32 = torch.int32

    S = torch.full((3, flen), -1.0, dtype=f32, device=dev)
    I = torch.full((2, flen), -1.0, dtype=f32, device=dev)
    D = torch.full((2, flen), -1.0, dtype=f32, device=dev)
    CS = torch.full((3, flen), -1, dtype=i32, device=dev)
    CI = torch.full((2, flen), I_BOUNDARY, dtype=i32, device=dev)
    CD = torch.full((2, flen), D_BOUNDARY, dtype=i32, device=dev)
    L = [0, 1, 2]
    U = [0, -1, -2]

    tb_rows = []
    ftr_length: List[int] = []
    ftr_lower_limit: List[int] = []
    ftr_addr = 0
    last_k = 0
    prev_conv_s = -1
    converged = False
    conv_logic = False
    conv_value = 0
    conv_score = _F32(0.0)
    max_score = _F32(0.0)
    max_score_prime = _F32(neg_inf)
    goe = pr.gap_open       # global alignment: end gaps use the gap scores
    gee = pr.gap_extend

    for k in range(ref_len + qry_len - 1):
        k3, k3p1, k3p2 = k % 3, (k + 1) % 3, (k + 2) % 3
        k2, k2p1 = k % 2, (k + 1) % 2
        Lk, Uk = L[k3], U[k3]
        if Lk >= Uk + 1:
            return [], reference_idx, query_idx, True, 1
        count = Uk - Lk + 1
        if count > flen:
            return [], reference_idx, query_idx, True, 2
        work[0] += count
        work[1] += 1
        if k <= marker:
            ftr_length.append(count)
            ftr_lower_limit.append(Lk)
            ftr_addr += count

        i_arr = torch.arange(Lk, Uk + 1, device=dev)
        lprime = max(0, k - ref_len + 1)
        jmax = min(k, ref_len - 1)
        j_arr = jmax - (i_arr - lprime)
        offset = i_arr - Lk
        off_diag = Lk - L[k3p1] + offset - 1
        off_up = Lk - L[k3p2] + offset
        off_left = Lk - L[k3p2] + offset - 1

        # match channel
        diag_valid = (off_diag >= 0) & (off_diag <= U[k3p1] - L[k3p1])
        if tile_no == 0:
            border = (i_arr == 0) | (j_arr == 0)
        else:
            border = torch.zeros_like(diag_valid)
        compute_sim = diag_valid | border
        if k == 0:
            compute_sim = torch.ones_like(diag_valid)
        rpos = reference_idx + j_arr
        qpos = query_idx + i_arr
        sim = pr.sim(rpos, qpos)
        steps = torch.clamp(torch.maximum(rpos, qpos) - 1, min=0).to(f32)
        border_val = sim + goe + gee * steps
        border_val = torch.where((i_arr == 0) & (j_arr == 0), sim,
                                 border_val)
        diag_take = torch.clamp(off_diag, 0, flen - 1)
        with_diag = S[k3p1][diag_take] + sim
        m = torch.where(border, border_val,
                        torch.where(off_diag < 0, sim, with_diag))
        match = torch.where(compute_sim, m, neg_inf)

        # gap channels
        pos_go_ref = pr.go_r[rpos]
        pos_go_qry = pr.go_q[qpos]
        pos_ge_ref = pr.ge_r[rpos]
        pos_ge_qry = pr.ge_q[qpos]
        ul2 = U[k3p2] - L[k3p2]
        up_valid = (off_up >= 0) & (off_up <= ul2)
        left_valid = (off_left >= 0) & (off_left <= ul2)
        up_take = torch.clamp(off_up, 0, flen - 1)
        left_take = torch.clamp(off_left, 0, flen - 1)
        del_op = torch.where(up_valid, S[k3p2][up_take] + pos_go_ref,
                             neg_inf)
        del_ext = torch.where(up_valid, D[k2p1][up_take] + pos_ge_ref,
                              neg_inf)
        ins_op = torch.where(left_valid, S[k3p2][left_take] + pos_go_qry,
                             neg_inf)
        ins_ext = torch.where(left_valid, I[k2p1][left_take] + pos_ge_qry,
                              neg_inf)

        iptr = ins_ext >= ins_op
        dptr = del_ext >= del_op
        i_val = torch.where(iptr, ins_ext, ins_op)
        d_val = torch.where(dptr, del_ext, del_op)
        m_ge_i = match >= i_val
        m_ge_d = match >= d_val
        i_gt_d = i_val > d_val
        s_val = torch.where(m_ge_i, torch.where(m_ge_d, match, d_val),
                            torch.where(i_gt_d, i_val, d_val))
        ptr = torch.where(m_ge_i, torch.where(m_ge_d, 0, 2),
                          torch.where(i_gt_d, 1, 2)).to(i32)

        # X-drop kill
        cut = float(max_score - xdrop)
        s_val = torch.where(s_val < cut, neg_inf, s_val)
        mx = _F32(s_val.max().item())
        if max_score_prime < mx:
            max_score_prime = mx

        I[k2][:count] = i_val
        D[k2][:count] = d_val
        S[k3][:count] = s_val

        # convergence bookkeeping
        low = (i_arr & 0xFFFF).to(i32)
        if k == marker - 1:
            CS[k3][:count] = (3 << 16) | low
        elif k == marker:
            CS[k3][:count] = low
            CI[k2][:count] = (1 << 16) | low
            CD[k2][:count] = (2 << 16) | low
        elif k >= marker + 1:
            ci_prop = torch.where(off_left >= 0, CI[k2p1][left_take],
                                  I_BOUNDARY)
            cs_left = CS[k3p2][left_take]
            ci_open = torch.where((off_left >= 0) & (cs_left != -1),
                                  cs_left, I_BOUNDARY)
            new_ci = torch.where(iptr, ci_prop, ci_open)
            cd_prop = torch.where(off_up >= 0, CD[k2p1][up_take],
                                  D_BOUNDARY)
            cs_up = CS[k3p2][up_take]
            cd_open = torch.where((off_up >= 0) & (cs_up != -1),
                                  cs_up, D_BOUNDARY)
            new_cd = torch.where(dptr, cd_prop, cd_open)
            cs_diag = CS[k3p1][diag_take]
            new_cs = torch.where(ptr == 0, cs_diag,
                                 torch.where(ptr == 1, new_ci, new_cd))
            CI[k2][:count] = new_ci
            CD[k2][:count] = new_cd
            CS[k3][:count] = new_cs

        if k <= marker:
            tb_rows.append(ptr | (iptr.to(i32) << 2) | (dptr.to(i32) << 3))

        # band shrink
        alive = s_val > neg_inf
        if not bool(alive.any()):
            new_l, new_u = Uk + 1, Lk - 1
        else:
            nz = torch.nonzero(alive).flatten()
            new_l = Lk + int(nz[0])
            new_u = Lk + int(nz[-1])

        # before marker-1 the convergence rows still hold their tile
        # initialisation (CS all -1, CI != CD), so the check cannot fire
        # and prev_conv_s stays -1: skipping it is exact
        if not converged and k < ref_len + qry_len - 2 and k >= marker - 1:
            start, length = new_l - Lk, new_u - new_l
            conv_i = _reduction(CI[k2], flen, start, length)
            conv_d = _reduction(CD[k2], flen, start, length)
            conv_s = _reduction(CS[k3], flen, start, length)
            if conv_i == conv_d and conv_i == conv_s \
                    and prev_conv_s == conv_s and conv_i != -1:
                converged = True
                conv_value = prev_conv_s
                conv_score = max_score_prime
            prev_conv_s = conv_s

        L[k3p1] = max(new_l, max(0, k + 2 - ref_len))
        U[k3p1] = min(qry_len - 1, new_u + 1)
        max_score = _F32(0.0) if max_score_prime < 0 else max_score_prime
        last_k = k
        if converged and max_score > conv_score:
            conv_logic = True
            break

    # locate the traceback start
    last_tile = False
    if not conv_logic and last_k < marker:
        conv_query_idx = qry_len - 1
        conv_ref_idx = ref_len - 1
        tb_start_addr = ftr_addr - 1
        tb_start_ftr = last_k
        tb_state = 0
        last_tile = True
    else:
        cv = conv_value if conv_logic else int(CS[last_k % 3][0])
        conv_query_idx = cv & 0xFFFF
        tb_state = (cv >> 16) & 0xFFFF
        conv_ref_idx = marker - conv_query_idx - (1 if tb_state == 3 else 0)
        tb_start_addr = ftr_addr - ftr_length[-1]
        if tb_state == 3:
            tb_start_addr = tb_start_addr - ftr_length[-2] + \
                (conv_query_idx - ftr_lower_limit[-2])
            tb_start_ftr = len(ftr_length) - 2
        else:
            tb_start_addr = tb_start_addr + \
                (conv_query_idx - ftr_lower_limit[-1])
            tb_start_ftr = len(ftr_length) - 1

    if conv_query_idx == D_BOUNDARY_LOW16:
        conv_query_idx, conv_ref_idx = 0, marker
    elif conv_query_idx == I_BOUNDARY_LOW16:
        conv_query_idx, conv_ref_idx = marker, 0

    reference_idx += conv_ref_idx
    query_idx += conv_query_idx
    if ref_total - reference_idx < 0 or qry_total - query_idx < 0:
        return [], reference_idx, query_idx, True, 3

    aln: List[int] = []
    if reference_idx == ref_total - 1 and query_idx < qry_total - 1:
        aln.extend([1] * (qry_total - query_idx - 1))
        last_tile = True
    if query_idx == qry_total - 1 and reference_idx < ref_total - 1:
        aln.extend([2] * (ref_total - reference_idx - 1))
        last_tile = True
    if reference_idx == ref_total - 1 and query_idx == qry_total - 1:
        last_tile = True

    tb = torch.cat(tb_rows).tolist() if tb_rows else []
    if not _traceback(ftr_length, ftr_lower_limit, tb_start_addr,
                      tb_start_ftr, tb_state % 3, conv_query_idx,
                      conv_ref_idx, tb, aln, tile_no == 0):
        return [], reference_idx, query_idx, True, 3
    return aln, reference_idx, query_idx, last_tile, 0


def _align_pair(pr: _Pair, maxaln: int):
    """Multi-tile driver (talco_np.align_freq). Returns (path, err, cells,
    diagonals)."""
    reference_idx = query_idx = tile_no = 0
    last_tile = False
    out: List[int] = []
    work = [0, 0]
    while not last_tile:
        tile_aln, reference_idx, query_idx, last_tile, err = _tile(
            pr, reference_idx, query_idx, tile_no, work)
        if not tile_aln:
            return [], err, work[0], work[1]
        # reversed, dropping the first step of each non-first tile
        step = tile_aln[::-1]
        out.extend(step[1:] if tile_no > 0 else step)
        if len(out) > maxaln:
            return [], 3, work[0], work[1]
        tile_no += 1
    return out, 0, work[0], work[1]


def talco_align_reference(ints, floats, ref, qry, matrix, *, p: int,
                          marker: int = MARKER
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on any device, with the
    kernel's inputs and outputs (module doc). Bit-identical to
    talco_np.align_freq: the same f32 operations in the same order."""
    b, _, padlen = ref.shape
    leaf = ref.dtype == torch.int8
    dev = ref.device
    maxaln = 2 * padlen
    paths = torch.zeros((b, maxaln), dtype=torch.int8)
    tail = torch.zeros((b, TAIL), dtype=torch.int32)
    iv = ints.cpu().tolist()
    fv = floats.cpu().numpy()
    for bi in range(b):
        rl, ql, flen = iv[0][bi], iv[1][bi], iv[2][bi]
        if not (1 <= rl <= padlen and 1 <= ql <= padlen and flen >= 1) \
                or (marker + 1) * min(flen, rl, ql) > INT32_MAX \
                or min(flen, rl, ql) > MAX_WINDOW:
            tail[bi, 1] = ERR_LAYOUT    # as the kernel's layout check
            continue
        pr = _Pair(bi, iv, fv, ref, qry, matrix, p, leaf, marker)
        path, err, cells, diags = _align_pair(pr, maxaln)
        n = len(path)
        if err == 0 and n:
            paths[bi, :n] = torch.tensor(path, dtype=torch.int8)
        tail[bi] = torch.tensor([n if err == 0 else 0, err,
                                 min(cells, INT32_MAX), diags],
                                dtype=torch.int32)
    return paths.to(dev), tail.to(dev)
