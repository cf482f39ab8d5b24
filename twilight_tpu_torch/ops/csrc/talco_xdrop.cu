// TALCO-XDrop profile-profile alignment: CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package, as size variants of this one
// template:
// - twilight_tpu/ops/talco_pallas_g8.py (get_pallas_kernel_g8, pallas_call
//   at :1672): the freq route (_make_kernel(leaf=False), similarity :230),
//   the leaf route (leaf=True, similarity_leaf :215), the work of the
//   escalated-window variant (hbm_tb=True) and the long-sequence variant
//   (hbm_in=True: padlen above 2048, profiles in HBM with anchor-window
//   DMA staging). Here the profiles are always read from global memory at
//   padlen-1-rpos / qpos, so any padlen is the same code.
// - twilight_tpu/ops/talco_pallas.py (get_pallas_kernel, pallas_call at
//   :579): one pair per program for ladder widths above 4096 and padlen
//   above 32768. Here each pair's scratch is sized from its own width, so
//   a wide pair is a launch with a larger scratch, not another kernel.
// Semantics are those of the NumPy oracle (twilight_tpu/ops/talco_np.py:
// tile :166, align_freq :456, _traceback :103) and of
// twilight_tpu/native/talco.cpp: band-relative rolling rows with
// ftr_length/ftr_lower_limit bookkeeping, the same f32 operations in the
// same order (build with -fmad=false; '/' is IEEE division), the same
// tie-breaks, and the same stale-buffer reads (clipped to the tile's flen).
//
// Design: one thread block per pair. The block's threads stride over the
// cells of an anti-diagonal; block-wide reductions give the X-drop max, the
// first and last live cell, and the three all-equal convergence checks
// (max, min and all-equal are exact in any order). One thread walks the
// traceback. The multi-tile loop runs inside the kernel.
//
// What bounds it: each pair's anti-diagonals run in sequence, and each
// costs two block barriers plus one pass over the live band, so a pair is
// latency-bound (the band is a few hundred cells) and the card is filled
// only by the batch's pairs (one block each). The profiles (P+P f32 per
// cell), the rolling rows and the traceback store live in global memory,
// where neighbouring threads read neighbouring addresses; each pair's
// scratch is sized from its own tile-width bound w = min(flen, ref_len,
// qry_len), so no static window overflows (the TPU kernels' error 6 cannot
// occur).
//
// Index widths: profile, path and scratch addresses are size_t or 64-bit
// offsets; a tile's traceback addresses (at most (marker+1)*w bytes, 33.6
// MB at w = 32768) and path lengths (at most rl+ql <= 2*padlen) are int,
// and the layout check refuses a pair whose traceback store would not fit
// an int. dp_cells is counted in 64 bits and saturates at INT32_MAX.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;              // threads per block
constexpr int NWARP = NT / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int I_BOUNDARY = -2;
constexpr int D_BOUNDARY = -3;
constexpr int I_BOUNDARY_LOW16 = I_BOUNDARY & 0xFFFF;
constexpr int D_BOUNDARY_LOW16 = D_BOUNDARY & 0xFFFF;
constexpr int ERR_LAYOUT = 8;        // scratch or lengths do not match offs

// Scratch bytes of one pair; talco_cuda.pair_scratch_bytes is the same.
__host__ __device__ inline long long pair_need(int rl, int ql, int flen,
                                               int marker) {
    const int w = max(1, min(flen, min(rl, ql)));
    const long long need = 56LL * w + (long long)(marker + 1) * w
        + rl + ql + 8;
    return (need + 255) / 256 * 256;
}

struct Batch {
    const int32_t* ints;     // [4, B] ref_len, qry_len, flen, xdrop
    const float* floats;     // [5, B] ref_num, qry_num, gap_char, go, ge
    const int64_t* offs;     // [B+1]
    const void* ref;         // [B, P8, padlen] f32 or [B, 1, padlen] int8
    const void* qry;
    const float* matrix;     // [msize, msize]
    int msize;
    uint8_t* scratch;
    long long scratch_bytes;
    int8_t* paths;           // [B, 2*padlen]
    int32_t* tail;           // [B, 4]
    int B, padlen, marker;
};

// Expected profile score of one cell, in the oracle's order
// (talco_np.similarity_scores); r/q are the P column values.
template <int P>
__device__ __forceinline__ float similarity(const float* r, const float* q,
                                            const float* M, int ms,
                                            float gap_char, float den) {
    float num = 0.0f;
    if constexpr (P == 6) {
#pragma unroll
        for (int l = 0; l < 5; ++l) {
            float s = (q[0] * M[l * ms + 0]) * r[l];
#pragma unroll
            for (int m = 1; m < 5; ++m) s = s + (q[m] * M[l * ms + m]) * r[l];
            num = num + s;
        }
#pragma unroll
        for (int l = 0; l < 5; ++l) num = num + (r[l] * q[5]) * gap_char;
#pragma unroll
        for (int m = 0; m < 5; ++m) num = num + (r[5] * q[m]) * gap_char;
    } else {
        // per l: two 8-wide partial sums, the m = 16..20 tail added to num
        // first, then the left-to-right horizontal sum
#pragma unroll
        for (int l = 0; l < 21; ++l) {
            float sv[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) sv[j] = (q[j] * M[l * ms + j]) * r[l];
#pragma unroll
            for (int j = 0; j < 8; ++j)
                sv[j] = sv[j] + (q[8 + j] * M[l * ms + 8 + j]) * r[l];
#pragma unroll
            for (int m = 16; m < 21; ++m)
                num = num + (r[l] * q[m]) * M[l * ms + m];
            float s = sv[0];
#pragma unroll
            for (int j = 1; j < 8; ++j) s = s + sv[j];
            num = num + s;
        }
#pragma unroll
        for (int l = 0; l < 21; ++l) num = num + (r[l] * q[21]) * gap_char;
#pragma unroll
        for (int m = 0; m < 21; ++m) num = num + (r[21] * q[m]) * gap_char;
    }
    return num / den;
}

// Reference Traceback (talco_np._traceback), by one thread. Appends to
// buf[*len]; false on an address outside the store or a full buffer.
__device__ bool traceback(const int* ftr_len, const int* ftr_low, int addr,
                          int ftr, int state, int idx, int ref_start_idx,
                          const int8_t* tb, int tb_size, int8_t* buf,
                          int* len, int cap, bool first_tile) {
    int query_idx = idx;
    int ref_idx = ref_start_idx;
    int n = *len;
    while (ftr >= 0) {
        if (addr < 0 || addr >= tb_size || n >= cap) return false;
        const int v = tb[addr];
        int d;
        if (state == 0) {
            state = v & 0x03;
            if (state == 0) {
                d = 0;
            } else if (state == 1) {
                d = 1;
                state = (v & 0x04) ? 1 : 0;
            } else {
                d = 2;
                state = (v & 0x08) ? 2 : 0;
            }
        } else if (state == 1) {
            d = 1;
            state = (v & 0x04) ? 1 : 0;
        } else {
            d = 2;
            state = (v & 0x08) ? 2 : 0;
        }
        if (ftr > 0) addr = addr - (idx - ftr_low[ftr] + 1) - ftr_len[ftr - 1];
        if (d == 0) {
            if (ftr > 1) addr = addr - ftr_len[ftr - 2] + (idx - ftr_low[ftr - 2]);
            ftr -= 2; idx -= 1; query_idx -= 1; ref_idx -= 1;
        } else if (d == 1) {
            if (ftr > 0) addr = addr + (idx - ftr_low[ftr - 1]);
            ftr -= 1; idx -= 1; query_idx -= 1;
        } else {
            if (ftr > 0) addr = addr + (idx - ftr_low[ftr - 1] + 1);
            ftr -= 1; ref_idx -= 1;
        }
        buf[n++] = (int8_t)d;
        if (first_tile && (ref_idx < 0 || query_idx < 0)) break;
    }
    if (first_tile) {
        for (; ref_idx > -1; --ref_idx) {
            if (n >= cap) return false;
            buf[n++] = 2;
        }
        for (; query_idx > -1; --query_idx) {
            if (n >= cap) return false;
            buf[n++] = 1;
        }
    }
    *len = n;
    return true;
}

template <int P, bool Leaf>
__global__ void __launch_bounds__(NT) talco_xdrop_kernel(Batch a) {
    constexpr int P8 = (P == 6) ? 8 : 24;
    constexpr int NLET = P - 1;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* smat = reinterpret_cast<float*>(smem_raw);
    int* ftr_len = reinterpret_cast<int*>(smat + a.msize * a.msize);
    int* ftr_low = ftr_len + (a.marker + 1);
    __shared__ float red_max[2][NWARP];
    __shared__ int red_first[2][NWARP];
    __shared__ int red_last[2][NWARP];
    __shared__ int red_conv[2][NWARP];
    __shared__ int tstate[5];   // reference_idx, query_idx, last, err, len

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int B = a.B;
    const int padlen = a.padlen;
    const int marker = a.marker;
    const int ms = a.msize;
    const int rl = a.ints[b];
    const int ql = a.ints[B + b];
    const int flen_param = a.ints[2 * B + b];
    const int xdrop = a.ints[3 * B + b];
    const float ref_num = a.floats[b];
    const float qry_num = a.floats[B + b];
    const float gap_char = a.floats[2 * B + b];
    const float gap_open = a.floats[3 * B + b];
    const float gap_ext = a.floats[4 * B + b];
    int32_t* tail = a.tail + 4 * b;
    int8_t* prow = a.paths + (size_t)b * 2 * padlen;
    const int maxaln = 2 * padlen;

    const long long base = a.offs[b];
    if (rl < 1 || ql < 1 || rl > padlen || ql > padlen || flen_param < 1
            || (long long)(marker + 1) * min(flen_param, min(rl, ql))
                > INT_MAX
            || base < 0 || base + pair_need(rl, ql, flen_param, marker)
                > a.offs[b + 1]
            || a.offs[B] > a.scratch_bytes) {
        if (tid == 0) {
            tail[0] = 0; tail[1] = ERR_LAYOUT; tail[2] = 0; tail[3] = 0;
        }
        return;
    }
    for (int x = tid; x < ms * ms; x += NT) smat[x] = a.matrix[x];

    // per-pair scratch (layout: pair_need)
    const int w = max(1, min(flen_param, min(rl, ql)));
    float* Sb = reinterpret_cast<float*>(a.scratch + base);
    float* Ib = Sb + 3 * w;
    float* Db = Ib + 2 * w;
    int* CSb = reinterpret_cast<int*>(Db + 2 * w);
    int* CIb = CSb + 3 * w;
    int* CDb = CIb + 2 * w;
    int8_t* tb = reinterpret_cast<int8_t*>(CDb + 2 * w);
    int8_t* tile_buf = tb + (size_t)(marker + 1) * w;
    const int tile_cap = rl + ql + 8;

    // ref columns are reversed and right-aligned: forward position pos
    // lives at column padlen-1-pos; the query is left-aligned
    const float* Rf = nullptr;
    const float* Qf = nullptr;
    const int8_t* Rc = nullptr;
    const int8_t* Qc = nullptr;
    if constexpr (Leaf) {
        Rc = reinterpret_cast<const int8_t*>(a.ref) + (size_t)b * padlen;
        Qc = reinterpret_cast<const int8_t*>(a.qry) + (size_t)b * padlen;
    } else {
        Rf = reinterpret_cast<const float*>(a.ref) + (size_t)b * P8 * padlen;
        Qf = reinterpret_cast<const float*>(a.qry) + (size_t)b * P8 * padlen;
    }
    const float den = ref_num * qry_num;
    const float xdrop_f = (float)xdrop;
    const float neg_inf = -(2.0f * xdrop_f + 1.0f);
    const float minus_inf = __int_as_float(0xff800000);

    int reference_idx = 0, query_idx = 0, tile_no = 0, out_len = 0;
    int err = 0, diags = 0;
    long long cells = 0;
    bool last_tile = false;
    __syncthreads();

    while (!last_tile) {
        const int ref_len = rl - reference_idx;
        const int qry_len = ql - query_idx;
        if (ref_len < 0 || qry_len < 0) { err = 3; break; }
        const int flen = min(flen_param, min(ref_len, qry_len));
        for (int x = tid; x < flen; x += NT) {
            Sb[x] = -1.0f; Sb[w + x] = -1.0f; Sb[2 * w + x] = -1.0f;
            Ib[x] = -1.0f; Ib[w + x] = -1.0f;
            Db[x] = -1.0f; Db[w + x] = -1.0f;
            CSb[x] = -1; CSb[w + x] = -1; CSb[2 * w + x] = -1;
            CIb[x] = I_BOUNDARY; CIb[w + x] = I_BOUNDARY;
            CDb[x] = D_BOUNDARY; CDb[w + x] = D_BOUNDARY;
        }
        __syncthreads();

        // band of diagonal k (Lc..Uc), k-1 (Lm1..Um1), k-2 (Lm2..Um2);
        // the oracle's L/U = [0, 1, 2] / [0, -1, -2] before k = 0
        int Lc = 0, Uc = 0, Lm1 = 2, Um1 = -2, Lm2 = 1, Um2 = -1;
        int ftr_addr = 0, nftr = 0, last_k = 0, prev_conv_s = -1;
        int conv_value = 0;
        bool converged = false, conv_logic = false;
        float conv_score = 0.0f, max_score = 0.0f, max_score_prime = neg_inf;
        const int cell_count = ref_len + qry_len - 1;
        for (int k = 0; k < cell_count; ++k) {
            if (Lc >= Uc + 1) { err = 1; break; }
            const int count = Uc - Lc + 1;
            if (count > flen) { err = 2; break; }
            cells += count;
            diags += 1;
            const int tb_base = ftr_addr;
            if (k <= marker) {
                if (tid == 0) { ftr_len[k] = count; ftr_low[k] = Lc; }
                ftr_addr += count;
                nftr += 1;
            }
            float* Sk = Sb + (k % 3) * w;
            const float* S1 = Sb + ((k + 2) % 3) * w;   // k-1
            const float* S2 = Sb + ((k + 1) % 3) * w;   // k-2
            float* Ik = Ib + (k % 2) * w;
            const float* I1 = Ib + ((k + 1) % 2) * w;
            float* Dk = Db + (k % 2) * w;
            const float* D1 = Db + ((k + 1) % 2) * w;
            int* CSk = CSb + (k % 3) * w;
            const int* CS1 = CSb + ((k + 2) % 3) * w;
            const int* CS2 = CSb + ((k + 1) % 3) * w;
            int* CIk = CIb + (k % 2) * w;
            const int* CI1 = CIb + ((k + 1) % 2) * w;
            int* CDk = CDb + (k % 2) * w;
            const int* CD1 = CDb + ((k + 1) % 2) * w;
            const int lprime = max(0, k - ref_len + 1);
            const int jmax = min(k, ref_len - 1);
            const int ul1 = Um2 - Lm2;
            const int ul2 = Um1 - Lm1;
            const float cut = max_score - xdrop_f;

            float tmax = minus_inf;
            int tfirst = INT_MAX, tlast = -1;
            for (int off = tid; off < count; off += NT) {
                const int i = Lc + off;
                const int j = jmax - (i - lprime);
                const int od = Lc - Lm2 + off - 1;
                const int ou = Lc - Lm1 + off;
                const int ol = ou - 1;
                const int rpos = reference_idx + j;
                const int qpos = query_idx + i;
                const int rcol = padlen - 1 - rpos;
                const bool diag_valid = od >= 0 && od <= ul1;
                const bool border = tile_no == 0 && (i == 0 || j == 0);
                float match = neg_inf;
                if (k == 0 || diag_valid || border) {
                    float sim;
                    if constexpr (Leaf) {
                        const int rc = Rc[rcol];
                        const int qc = Qc[qpos];
                        // a one-hot unit-weight column pair scores exactly
                        // the matrix entry (+0.0f as the oracle's sum gives)
                        sim = (rc >= 0 && rc < NLET && qc >= 0 && qc < NLET)
                            ? smat[rc * ms + qc] + 0.0f : 0.0f;
                    } else {
                        float r[P], q[P];
#pragma unroll
                        for (int l = 0; l < P; ++l) {
                            r[l] = Rf[(size_t)l * padlen + rcol];
                            q[l] = Qf[(size_t)l * padlen + qpos];
                        }
                        sim = similarity<P>(r, q, smat, ms, gap_char, den);
                    }
                    if (border) {
                        if (i == 0 && j == 0) {
                            match = sim;
                        } else {
                            const float steps = (float)max(0, max(rpos, qpos) - 1);
                            match = sim + gap_open + gap_ext * steps;
                        }
                    } else if (od < 0) {
                        match = sim;
                    } else {
                        match = S2[od] + sim;
                    }
                }
                float pgo_r, pge_r, pgo_q, pge_q;
                if constexpr (Leaf) {
                    pgo_r = pgo_q = gap_open;
                    pge_r = pge_q = gap_ext;
                } else {
                    pgo_r = Rf[(size_t)(P8 - 2) * padlen + rcol];
                    pge_r = Rf[(size_t)(P8 - 1) * padlen + rcol];
                    pgo_q = Qf[(size_t)(P8 - 2) * padlen + qpos];
                    pge_q = Qf[(size_t)(P8 - 1) * padlen + qpos];
                }
                const bool up_valid = ou >= 0 && ou <= ul2;
                const bool left_valid = ol >= 0 && ol <= ul2;
                const float del_op = up_valid ? S1[ou] + pgo_r : neg_inf;
                const float del_ext = up_valid ? D1[ou] + pge_r : neg_inf;
                const float ins_op = left_valid ? S1[ol] + pgo_q : neg_inf;
                const float ins_ext = left_valid ? I1[ol] + pge_q : neg_inf;
                const bool iptr = ins_ext >= ins_op;
                const bool dptr = del_ext >= del_op;
                const float i_val = iptr ? ins_ext : ins_op;
                const float d_val = dptr ? del_ext : del_op;
                float s_val;
                int ptr;
                if (match >= i_val) {
                    if (match >= d_val) { s_val = match; ptr = 0; }
                    else { s_val = d_val; ptr = 2; }
                } else {
                    if (i_val > d_val) { s_val = i_val; ptr = 1; }
                    else { s_val = d_val; ptr = 2; }
                }
                if (s_val < cut) s_val = neg_inf;

                Ik[off] = i_val;
                Dk[off] = d_val;
                Sk[off] = s_val;
                const int low = i & 0xFFFF;
                if (k == marker - 1) {
                    CSk[off] = (3 << 16) | low;
                } else if (k == marker) {
                    CSk[off] = low;
                    CIk[off] = (1 << 16) | low;
                    CDk[off] = (2 << 16) | low;
                } else if (k >= marker + 1) {
                    // index-clipped reads: stale values past the live band
                    // are read exactly as the oracle's np.clip takes do
                    const int lt = min(max(ol, 0), flen - 1);
                    const int ut = min(max(ou, 0), flen - 1);
                    const int dt = min(max(od, 0), flen - 1);
                    const int ci_prop = ol >= 0 ? CI1[lt] : I_BOUNDARY;
                    const int cs_left = CS1[lt];
                    const int ci_open = (ol >= 0 && cs_left != -1) ? cs_left
                                                                   : I_BOUNDARY;
                    const int new_ci = iptr ? ci_prop : ci_open;
                    const int cd_prop = ou >= 0 ? CD1[ut] : D_BOUNDARY;
                    const int cs_up = CS1[ut];
                    const int cd_open = (ou >= 0 && cs_up != -1) ? cs_up
                                                                 : D_BOUNDARY;
                    const int new_cd = dptr ? cd_prop : cd_open;
                    const int cs_diag = CS2[dt];
                    CIk[off] = new_ci;
                    CDk[off] = new_cd;
                    CSk[off] = ptr == 0 ? cs_diag : (ptr == 1 ? new_ci : new_cd);
                }
                if (k <= marker)
                    tb[tb_base + off] = (int8_t)(ptr | (iptr ? 4 : 0)
                                                 | (dptr ? 8 : 0));
                tmax = fmaxf(tmax, s_val);
                if (s_val > neg_inf) {
                    tfirst = min(tfirst, off);
                    tlast = max(tlast, off);
                }
            }

            // block reduction 1: max score, first and last live cell.
            // Buffers alternate by diagonal parity, so a diagonal's writes
            // never meet the previous diagonal's reads (one barrier apart).
            const int par = k & 1;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, o));
                tfirst = min(tfirst, __shfl_xor_sync(FULL, tfirst, o));
                tlast = max(tlast, __shfl_xor_sync(FULL, tlast, o));
            }
            if (lane == 0) {
                red_max[par][warp] = tmax;
                red_first[par][warp] = tfirst;
                red_last[par][warp] = tlast;
            }
            __syncthreads();
            float mx = red_max[par][0];
            int first = red_first[par][0];
            int last = red_last[par][0];
#pragma unroll
            for (int v = 1; v < NWARP; ++v) {
                mx = fmaxf(mx, red_max[par][v]);
                first = min(first, red_first[par][v]);
                last = max(last, red_last[par][v]);
            }
            if (max_score_prime < mx) max_score_prime = mx;
            int new_l, new_u;
            if (first == INT_MAX) { new_l = Uc + 1; new_u = Lc - 1; }
            else { new_l = Lc + first; new_u = Lc + last; }

            // convergence (before marker-1 the rows hold their tile
            // initialisation, so the check cannot fire: skipped exactly)
            if (!converged && k < ref_len + qry_len - 2 && k >= marker - 1) {
                const int start = min(new_l - Lc, flen - 1);
                const int length = new_u - new_l;
                const int ci0 = CIk[start];
                const int cd0 = CDk[start];
                const int cs0 = CSk[start];
                int conv_i = ci0, conv_d = cd0, conv_s = cs0;
                if (length >= 0) {
                    const int end = min(start + length, flen - 1);
                    unsigned bits = 0;
                    for (int x = start + 1 + tid; x <= end; x += NT) {
                        if (CIk[x] != ci0) bits |= 1u;
                        if (CDk[x] != cd0) bits |= 2u;
                        if (CSk[x] != cs0) bits |= 4u;
                    }
                    bits = __reduce_or_sync(FULL, bits);
                    if (lane == 0) red_conv[par][warp] = (int)bits;
                    __syncthreads();
                    int all = 0;
#pragma unroll
                    for (int v = 0; v < NWARP; ++v) all |= red_conv[par][v];
                    if (all & 1) conv_i = -1;
                    if (all & 2) conv_d = -1;
                    if (all & 4) conv_s = -1;
                }
                if (conv_i == conv_d && conv_i == conv_s
                        && prev_conv_s == conv_s && conv_i != -1) {
                    converged = true;
                    conv_value = prev_conv_s;
                    conv_score = max_score_prime;
                }
                prev_conv_s = conv_s;
            }

            const int Ln = max(new_l, max(0, k + 2 - ref_len));
            const int Un = min(qry_len - 1, new_u + 1);
            Lm2 = Lm1; Um2 = Um1;
            Lm1 = Lc; Um1 = Uc;
            Lc = Ln; Uc = Un;
            max_score = max_score_prime < 0.0f ? 0.0f : max_score_prime;
            last_k = k;
            if (converged && max_score > conv_score) {
                conv_logic = true;
                break;
            }
        }
        if (err != 0) break;
        __syncthreads();   // traceback store and CS rows complete

        if (tid == 0) {
            int cq, cr, addr, sftr, state;
            bool lt = false, bad_start = false;
            if (!conv_logic && last_k < marker) {
                cq = qry_len - 1;
                cr = ref_len - 1;
                addr = ftr_addr - 1;
                sftr = last_k;
                state = 0;
                lt = true;
            } else if (nftr < 2) {
                cq = cr = addr = sftr = state = 0;   // unreachable: tb is
                bad_start = true;                    // past the marker here
            } else {
                const int cv = conv_logic ? conv_value
                                          : CSb[(last_k % 3) * w];
                cq = cv & 0xFFFF;
                state = (cv >> 16) & 0xFFFF;
                cr = marker - cq - (state == 3 ? 1 : 0);
                addr = ftr_addr - ftr_len[nftr - 1];
                if (state == 3) {
                    addr = addr - ftr_len[nftr - 2] + (cq - ftr_low[nftr - 2]);
                    sftr = nftr - 2;
                } else {
                    addr = addr + (cq - ftr_low[nftr - 1]);
                    sftr = nftr - 1;
                }
            }
            if (cq == D_BOUNDARY_LOW16) { cq = 0; cr = marker; }
            else if (cq == I_BOUNDARY_LOW16) { cq = marker; cr = 0; }
            const int nref = reference_idx + cr;
            const int nqry = query_idx + cq;
            int terr = 0, tlen = 0;
            if (bad_start || rl - nref < 0 || ql - nqry < 0) {
                terr = 3;
            } else {
                if (nref == rl - 1 && nqry < ql - 1) {
                    for (int t = 0; t < ql - nqry - 1; ++t) tile_buf[tlen++] = 1;
                    lt = true;
                }
                if (nqry == ql - 1 && nref < rl - 1) {
                    for (int t = 0; t < rl - nref - 1; ++t) tile_buf[tlen++] = 2;
                    lt = true;
                }
                if (nref == rl - 1 && nqry == ql - 1) lt = true;
                // (the end-gap runs above are shorter than rl + ql, the
                // buffer's size; the traceback checks its own appends)
                if (!traceback(ftr_len, ftr_low, addr, sftr, state % 3, cq, cr,
                               tb, ftr_addr, tile_buf, &tlen, tile_cap,
                               tile_no == 0))
                    terr = 3;
            }
            tstate[0] = nref;
            tstate[1] = nqry;
            tstate[2] = lt ? 1 : 0;
            tstate[3] = terr;
            tstate[4] = tlen;
        }
        __syncthreads();
        reference_idx = tstate[0];
        query_idx = tstate[1];
        last_tile = tstate[2] != 0;
        const int terr = tstate[3];
        const int tlen = tstate[4];
        if (terr != 0) { err = terr; break; }
        if (tlen == 0) { out_len = 0; break; }   // the oracle's empty path
        // append the tile reversed, dropping the first step of each
        // non-first tile (talco_np.align_freq)
        const int skip = tile_no > 0 ? 1 : 0;
        const int n_new = tlen - skip;
        if (out_len + n_new > maxaln) { err = 3; break; }
        for (int t = tid; t < n_new; t += NT)
            prow[out_len + t] = tile_buf[tlen - 1 - skip - t];
        out_len += n_new;
        tile_no += 1;
        __syncthreads();   // tile_buf is rewritten by the next traceback
    }
    if (tid == 0) {
        tail[0] = err != 0 ? 0 : out_len;
        tail[1] = err;
        // a 30 kb pair at a ladder width of 30000 can pass 2^31 cells
        tail[2] = (int32_t)min(cells, (long long)INT_MAX);
        tail[3] = diags;
    }
}

template <int P, bool Leaf>
cudaError_t launch(const Batch& a, size_t smem, cudaStream_t stream) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            talco_xdrop_kernel<P, Leaf>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    talco_xdrop_kernel<P, Leaf><<<a.B, NT, smem, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one thread block per pair on `stream` and returns the launch's
// error (cudaSuccess = 0). Does not synchronise. padlen may be any length
// that holds the launch's longest side.
cudaError_t talco_xdrop_launch(int p, int leaf, const void* ints, const void* floats,
                       const void* offs, const void* ref, const void* qry,
                       const void* matrix, int msize, void* scratch,
                       long long scratch_bytes, void* paths, void* tail,
                       int B, int padlen, int marker, void* stream) {
    if (B <= 0) return cudaSuccess;
    if ((p != 6 && p != 22) || msize < p - 1 || msize > 32 || padlen < 1
            || padlen > (INT_MAX >> 2) || marker < 1)
        return cudaErrorInvalidValue;
    Batch a;
    a.ints = static_cast<const int32_t*>(ints);
    a.floats = static_cast<const float*>(floats);
    a.offs = static_cast<const int64_t*>(offs);
    a.ref = ref;
    a.qry = qry;
    a.matrix = static_cast<const float*>(matrix);
    a.msize = msize;
    a.scratch = static_cast<uint8_t*>(scratch);
    a.scratch_bytes = scratch_bytes;
    a.paths = static_cast<int8_t*>(paths);
    a.tail = static_cast<int32_t*>(tail);
    a.B = B;
    a.padlen = padlen;
    a.marker = marker;
    const size_t smem = (size_t)msize * msize * sizeof(float)
        + 2 * (size_t)(marker + 1) * sizeof(int);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (p == 6) return leaf ? launch<6, true>(a, smem, s) : launch<6, false>(a, smem, s);
    return leaf ? launch<22, true>(a, smem, s) : launch<22, false>(a, smem, s);
}

const char* talco_xdrop_error_string(int e) {
    return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
