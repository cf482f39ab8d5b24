// Loop-cost probes: CUDA kernels for Hopper (sm_90a).
//
// Replaces the five Pallas probe kernels of tools/probe_loop_costs.py
// (K6-K10), one template instance per variant:
// - carcass  (pallas_call at :86)  — V_CARCASS
// - body     (:144)                — V_BODY_CARRIED, V_BODY_SCRATCH
// - scalar0d (:239)                — V_S0D_COND, V_S0D_BODY, V_S0D_BOTH
// - deadcode (:317)                — V_DEADCODE
// - nested   (:391)                — V_NESTED, V_NESTED_WALK
// Each computes the JAX program's (GRP, W) = (8, 640) f32 result after
// `trips` loop steps, two bodies per loop trip; the plain PyTorch versions
// are ops/probe_loop.py's *_reference, which run the same f32 operations
// in the same order (build with -fmad=false), so the two agree bit for
// bit, NaN positions included.
//
// Two layouts; every variant has both.
//
// One block (probe_loop_kernel<V>): one block of 512 threads holds the
// whole (8, 640) state, as one TPU program held it. Thread t owns lanes
// [10c, 10c+10) of row g = t / 64 (c = t % 64), so each row is two warps
// and each thread carries 8 rows x 10 lanes in registers (80 floats; 128
// registers a thread at 512 threads, so most instances spill). The
// DP-like body (the tool's `math`) is body_lanes:
// - pltpu.roll(x, 1, 1), a shift by one lane, moves values within a
//   thread's registers, across its warp by __shfl_up_sync, and across the
//   row's warps through shared memory;
// - jnp.max(s, axis=1) is a warp reduction and a read of the row's warp
//   partials from shared memory;
// - the 0-d reductions over the (8, 1) row maxima (jnp.min/max/any) are
//   per-thread reductions over 8 registers that every thread holds after
//   the row reduction.
// Both exchanges of a body share one block barrier: the lane-boundary
// values of the next body and the row maxima of this one are written to
// shared buffers alternating by body parity, so one body's writes never
// meet the previous body's reads. max is NaN-propagating (jnp.maximum).
// body/scratch keeps its rows in a (64, 640) shared-memory scratch (the
// VMEM scratch) and reads it before writing it: the TPU's result is
// undefined and JAX's interpreter fills float scratch with NaN, so this
// kernel fills it with NaN too (with the offset: body/carried's start).
// deadcode's (8, 2048) int8 scratch is filled with -128 before the loop,
// the value JAX's interpreter gives uninitialised int8 scratch (its
// integer minimum), so live walks read defined values (before, the
// one-block instance left it uninitialised).
//
// Cluster (probe_cluster_kernel<V>, the default of every variant): one
// cluster of 8 CTAs, CTA g (its rank in the cluster) holding group row g,
// the 640 lanes of all 8 carried arrays. Rows meet only where the program
// combines them, so the state splits by row with no traffic inside a
// body: CT = 320 threads a CTA (10 warps), CL = 2 lanes a thread, 16
// floats of state a thread, no spill (of 128, 160, 320 and 640 threads,
// 320 was the fastest in every variant on the H100; PERF.md). The roll
// and the row maximum stay inside the CTA (shuffles, then the
// warp-boundary lanes and the warp partials through shared memory,
// double-buffered by body parity as in one block). What each instance
// exchanges:
// - carcass: nothing, and it has no cluster barrier: CTA g carries row g's
//   lanes of the 8 rows and row g's 20 columns and writes row g. Nothing
//   bounds it but the FP32 issue of its 8 SMs (16 FADDs a thread a body,
//   10 warps on 4 schedulers; one block: one SM's, 80 FADDs a thread over
//   16 warps): the rows' adds form no chain and nothing is exchanged. It
//   is the cluster layout's loop floor.
// - body/carried and nested: nothing; the rows never meet. body/carried
//   is the bare split step: the body and one CTA barrier a body.
// - body/scratch: nothing; CTA g keeps its (8, 640) slice of the scratch
//   (row i of group row g, 20 KB) in the dynamic shared memory that the
//   reserve below asks for, read before and written after every body.
// - scalar0d/body and /both: every body's 0-d reductions over all 8 row
//   maxima feed `org`, which the next body reads. After the CTA barrier
//   that completes the row maximum, thread k stores it into a parity slot
//   of CTA k's shared memory with st.async, each store completing 4 bytes
//   of CTA k's mbarrier for that slot, and every thread waits on its own
//   CTA's mbarrier until all 8 have arrived: a one-way exchange, no
//   cluster barrier. Every thread then holds all 8 row maxima and
//   computes org as one block does. (PROBE_CLUSTER_EXCHANGE=1 stores with
//   st.shared::cluster and waits at one cluster barrier instead, the
//   figure a barrier-based band split would pay; chip_smoke.py holds
//   that build to the plain versions and times it too. A first design,
//   every warp storing its partial into every CTA before one cluster
//   barrier, cost ~200 ns a step for each warp of the CTA.) The
//   exchange's cost a step is the figure the probe is for.
// - scalar0d/cond: `run` and `cnt` do not depend on the data; every CTA
//   carries all eight, with no exchange.
// - deadcode (after its loop) and nested+walk (at each of its two tile
//   ends): the walks start from the maximum of all 8 row maxima, so each
//   CTA pushes its row maximum into every CTA and waits at one cluster
//   barrier. Every CTA holds the whole int8 scratch (16 KB, static) and
//   runs all 8 walks, the same dead code in scope as one block.
// Every variant but the carcass has a cluster barrier at entry (every CTA
// has started, and its mbarriers are initialised, before a peer writes
// its shared memory) and one at exit (none leaves while a peer may still
// write it). Each CTA reserves more than half an SM's shared memory, so
// the 8 CTAs run on 8 SMs. The parity slots need no barrier of their
// own: a CTA stores into slot p for body k + 2 only after it has received
// every CTA's maximum of body k + 1, which each CTA sends after reading
// slot p of body k.
//
// What bounds it (every variant but the carcass, above): a dependent
// chain of one barrier and the body's ~37 f32 operations per element per
// step; it reads nothing and writes 20 KB once, so bytes do not bound it.
// The per-step bound on the card (the operations over the f32 peak of all
// 132 SMs) is ~130x under what one SM can issue, and the program is one
// dependent chain, so no instance comes near it; that is the point of the
// probe: one block measures the floor of one block's step, the structure
// of the TALCO kernel's per-diagonal step (talco_xdrop.cu, one block per
// pair); the cluster measures what 8 SMs buy a step and what an exchange
// of the row maxima through distributed shared memory costs one, the two
// figures that splitting one pair's band over a cluster is planned from.
//
// The offset (a launch argument; 0 runs the JAX tool's program): every
// variant, in both layouts, starts its carried rows (and body/scratch its
// scratch) at base + g * 2^-7 + x * 2^-12 (group row g, lane x; exact in
// f32), and the carcass its 20 columns at i + g, as its plain version does
// with offset=True. The tool's state is the same in every row and lane,
// so a value rolled from the wrong lane, a row maximum sent to the wrong
// CTA or slot, or a row written in another's place would not change its
// result; with the offset it does.
//
// Dead code stays in scope: the walks of deadcode and nested+walk start
// at done = min(int(max(msp)), walk_floor), with walk_floor a launch
// argument (-1, so they run no step), so nvcc cannot prove them dead; the
// carcass keeps its 20 carried int columns live through a test against
// walk_floor that never holds. With walk_floor above the row maxima (and
// the offset, which makes those differ by row) the walks run, and a CTA
// that started them from its own row maximum would emit another count.
#include <cstdint>
#include <cuda_runtime.h>

// how scalar0d/body and /both exchange the row maxima every body: 0, by
// st.async into every CTA, each store completing the receiver's mbarrier
// (no cluster barrier); 1, by st.shared::cluster, then one cluster
// barrier. tools/probe_loop_costs.py --cluster-exchange builds either.
#ifndef PROBE_CLUSTER_EXCHANGE
#define PROBE_CLUSTER_EXCHANGE 0
#endif

namespace {

constexpr int GRP = 8, W = 640;
constexpr int NT = 512;                 // threads per block
constexpr int NWARP = NT / 32;
constexpr int TPR = NT / GRP;           // threads per row (64)
constexpr int LPT = W / TPR;            // lanes per thread (10)
constexpr int NROW = 8;                 // carried rows
constexpr int NCOL = 20;                // carcass int columns
constexpr int TBW = 2048;               // deadcode int8 scratch width
constexpr unsigned FULL = 0xffffffffu;
// cluster instances: CTAs (one group row each), threads and warps of a
// CTA, lanes a thread
constexpr int NCTA = GRP;
constexpr int CT = 320;
constexpr int CW = CT / 32;
constexpr int CL = W / CT;

enum Variant {
    V_CARCASS = 0, V_BODY_CARRIED, V_BODY_SCRATCH, V_S0D_COND, V_S0D_BODY,
    V_S0D_BOTH, V_DEADCODE, V_NESTED, V_NESTED_WALK, N_VARIANTS
};

__device__ __forceinline__ float jmax(float a, float b) {
    // jnp.maximum / torch.maximum: NaN if either is NaN
    return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// f32 -> int32 as XLA converts: toward zero, saturating, NaN to 0
__device__ __forceinline__ int to_i32(float x) { return __float2int_rz(x); }

// scalar0d's bias of lane x: where(x - org % W < 0, 0, 1e-30)
__device__ __forceinline__ float bias(int x, int org) {
    const float kTiny = (float)1e-30;   // as torch rounds the Python float
    return (x - org % W < 0) ? 0.0f : kTiny;
}

// the offset of group row g, lane x (module doc)
__device__ __forceinline__ float init_offset(int g, int x) {
    return (float)g * 0.0078125f + (float)x * 0.000244140625f;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = jmax(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

// The tool's `math` on a thread's N lanes of one group row, in place:
// prev0 and prev2 are the values the lane roll brings into its first lane
// (rows 0 and 2). Returns the maximum of the new s over those lanes.
template <int N>
__device__ __forceinline__ float body_lanes(float (&r)[NROW][N], float prev0,
                                            float prev2) {
    const float k11 = (float)1.1, k09 = (float)0.9, k12 = (float)1.2;
    const float k08 = (float)0.8, k13 = (float)1.3, k07 = (float)0.7;
    const float k01 = (float)0.1, k02 = (float)0.2, k001 = (float)0.01;
    float tmax = -__int_as_float(0x7f800000);
    // descending, so the rolled reads r[*][j-1] are still this body's input
#pragma unroll
    for (int j = N - 1; j >= 0; --j) {
        const float r0 = r[0][j], r1 = r[1][j], r2 = r[2][j], r3 = r[3][j];
        const float r4 = r[4][j], r5 = r[5][j], r6 = r[6][j], r7 = r[7][j];
        const float rr0 = j ? r[0][j - 1] : prev0;
        const float rr2 = j ? r[2][j - 1] : prev2;
        const float sim = r0 * k11 + r1 * k09 + r2 * k12 + r3 * k08
            + r4 * k13 + r5 * k07;
        const float diag = rr0 + sim;
        const float up = r1 + -5.0f;
        const float left = rr2 + -3.0f;
        const float m2 = jmax(jmax(diag, up), left);
        const float iv = ((left > up) ? left : up) + sim * k01;
        const float dv = ((up > diag) ? up : diag) + sim * k02;
        const float sv = jmax(m2, jmax(iv, dv));
        r[0][j] = sv;
        r[1][j] = iv;
        r[2][j] = dv;
        r[3][j] = (sv > 0.0f) ? r3 : r4;
        r[4][j] = (iv > 0.0f) ? r5 : r6;
        r[5][j] = (dv > 0.0f) ? r6 : r7;
        r[6][j] = sim + sv * k001;
        r[7][j] = diag + iv * k001;
        tmax = jmax(tmax, sv);
    }
    return tmax;
}

// One body's row-local half: scalar0d's bias on row 0 (Bias), the lanes
// rolled in (from the previous lane's thread by shuffle; lane 0 from the
// last lane of warp `pw`, published in bnd[par][pw] before the body's
// barrier, with its own lane's bias), the math and the warp's maximum.
template <int N, bool Bias>
__device__ __forceinline__ float row_body(const float (*bnd)[2],
                                          float (&r)[NROW][N], int pw,
                                          int lane, int x0, int org) {
    if constexpr (Bias) {
#pragma unroll
        for (int j = 0; j < N; ++j) r[0][j] = r[0][j] + bias(x0 + j, org);
    }
    float prev0 = __shfl_up_sync(FULL, r[0][N - 1], 1);
    float prev2 = __shfl_up_sync(FULL, r[2][N - 1], 1);
    if (lane == 0) {
        prev0 = bnd[pw][0];
        prev2 = bnd[pw][1];
        if constexpr (Bias)
            prev0 = prev0 + bias((x0 + W - 1) % W, org);   // lane rolled into x0
    }
    return warp_max(body_lanes(r, prev0, prev2));
}

// Publishes the thread's rows 0 and 2 last lane (lane 31 of each warp; read
// by the next warp of the row) into bnd[warp].
template <int N>
__device__ __forceinline__ void put_boundary(float (*bnd)[2],
                                             const float (&r)[NROW][N],
                                             int warp, int lane) {
    if (lane == 31) {
        bnd[warp][0] = r[0][N - 1];
        bnd[warp][1] = r[2][N - 1];
    }
}

// scalar0d/body and /both: org from the 0-d reductions over the 8 row maxima
__device__ __forceinline__ int next_org(int org, const float (&msp)[GRP]) {
    int lmin = 0x7fffffff, umax = (int)0x80000000;
    bool anyv = false;
#pragma unroll
    for (int g = 0; g < GRP; ++g) {
        const bool alive = msp[g] > -2e3f;
        const int mi = to_i32(msp[g]);
        lmin = min(lmin, alive ? (mi & 0x7) + 1 : 1 << 30);
        umax = max(umax, alive ? (mi & 0x3) : 0);
        anyv = anyv || alive;
    }
    const int org_n = anyv ? max(org, min(lmin, umax)) : org;
    return min(org_n, 7);
}

// the loop condition: k < trips, and any(run) for cond and both
template <bool Cond>
__device__ __forceinline__ bool keep_going(const int (&run)[GRP], int k,
                                           int trips) {
    if constexpr (Cond) {
        bool any = false;
#pragma unroll
        for (int g = 0; g < GRP; ++g) any = any || run[g] != 0;
        return any && k < trips;
    } else {
        return k < trips;
    }
}

__device__ __forceinline__ void cond_step(int (&run)[GRP], int (&cnt)[GRP],
                                          int trips) {
#pragma unroll
    for (int g = 0; g < GRP; ++g) {
        run[g] = (cnt[g] + 1 < trips) ? 1 : 0;
        cnt[g] = cnt[g] + 1;
    }
}

struct Shared {
    float bnd[2][NWARP][2];   // lane 31's last lane of rows 0 and 2, by parity
    float part[2][NWARP];     // per-warp max of s, by parity
};

// One body (the tool's `math`) on the thread's rows, in place. Writes the
// next body's boundary values and this body's row maxima, one barrier,
// then updates msp[0..7].
template <bool Bias>
__device__ __forceinline__ void dp_body(Shared& sh, float (&r)[NROW][LPT],
                                        float (&msp)[GRP], int par, int warp,
                                        int lane, int x0, int org) {
    // the row's other warp rolls into this one's first lane
    const float tmax = row_body<LPT, Bias>(sh.bnd[par], r, warp ^ 1, lane,
                                           x0, org);
    if (lane == 0) sh.part[par][warp] = tmax;
    put_boundary(sh.bnd[par ^ 1], r, warp, lane);
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GRP; ++g)
        msp[g] = jmax(msp[g], jmax(sh.part[par][2 * g], sh.part[par][2 * g + 1]));
}

// The traceback walks of deadcode (over the int8 scratch) and nested+walk
// (no scratch), stepping as the JAX tool's wstep: GRP walks from `done`;
// returns their steps (0 when done < 0, as at walk_floor = -1).
template <bool Tbs>
__device__ __noinline__ int dead_walks(const int8_t* tbs, int done) {
    int emit = 0;
    for (int g = 0; g < GRP; ++g) {
        int ftr = done, idx = 5, n = 0;
        while (ftr >= 0) {
            const int m = ((idx % 128) + 128) % 128;   // Python's idx % 128
            int v;
            if constexpr (Tbs) {
                int base = (min(max(idx, 0), 1 << 20) / 128) * 128;
                base = min(base, TBW - 128);           // stay in the scratch
                v = 0;
                for (int l = 0; l < 128; ++l)
                    v += (l == m) ? (int)tbs[g * TBW + base + l] : 0;
                ftr = ftr - 1 - (v & 1);
                idx = idx - (v & 2) / 2;
            } else {
                v = m >= 0 ? 1 : 0;
                ftr = ftr - 1 - (v & 1);
                idx = idx - 1;
            }
            n += 1;
        }
        emit += n;
    }
    return emit;
}

// deadcode's int8 scratch, before the loop: -128 everywhere, the value
// the JAX interpreter gives uninitialised int8 scratch (module doc), by
// the block's nthreads threads in 32-bit words; the barrier before the
// loop publishes it
__device__ __forceinline__ void fill_tbs(int8_t* tbs, int tid, int nthreads) {
    int* w = reinterpret_cast<int*>(tbs);
    for (int i = tid; i < GRP * TBW / 4; i += nthreads) w[i] = (int)0x80808080;
}

// deadcode's merge into row 0 of the scratch, under a condition that
// never holds
__device__ __forceinline__ void dead_merge(int8_t* tbs, int emit, int tid,
                                           int nthreads) {
    if (emit > 1000000000) {
        for (int c = 0; c < 8; ++c) {
            const int c0 = (min(c * 128, TBW - 128) / 128) * 128;
            for (int l = tid; l < 128; l += nthreads)
                tbs[c0 + l] = (l < emit) ? (int8_t)1 : tbs[c0 + l];
        }
    }
}

__device__ __forceinline__ int max_msp_i32(const float (&msp)[GRP]) {
    float m = msp[0];
#pragma unroll
    for (int g = 1; g < GRP; ++g) m = jmax(m, msp[g]);
    return to_i32(m);
}

// The carcass on a thread's N lanes [x0, x0 + N) of group row g, in either
// layout: the 8 rows and the 20 columns (Off: the rows + the offset, the
// columns + g), +1 each a body, two bodies a loop trip; then acc = 0 + r0
// + ... + r7 + float(c0) into row g of out. Off is a template argument,
// not a branch: from starts known only at run time nvcc keeps the 20
// columns in the one-block loop (20 integer adds a trip, +12% a step on
// the H100; PERF.md), from constant starts it folds them into the trip
// count, so the tool's program (no offset) compiles without them.
template <int N, bool Off>
__device__ __forceinline__ void carcass_lanes(int trips, int walk_floor,
                                              int g, int x0,
                                              float* __restrict__ out) {
    float r[NROW][N];
#pragma unroll
    for (int i = 0; i < NROW; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) {
            r[i][j] = (float)i;
            if constexpr (Off) r[i][j] = r[i][j] + init_offset(g, x0 + j);
        }
    int col[NCOL];
#pragma unroll
    for (int i = 0; i < NCOL; ++i) col[i] = Off ? i + g : i;
    for (int k = 0; k < trips;) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
#pragma unroll
            for (int i = 0; i < NROW; ++i)
#pragma unroll
                for (int j = 0; j < N; ++j) r[i][j] = r[i][j] + 1.0f;
#pragma unroll
            for (int i = 0; i < NCOL; ++i) col[i] = col[i] + 1;
            k += 1;
        }
    }
    int live = 0;
#pragma unroll
    for (int i = 0; i < NCOL; ++i) live += col[i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < NROW; ++i) acc = acc + r[i][j];
        acc = acc + (float)col[0];
        if (live == walk_floor) acc = qnan();   // never: keeps cols live
        out[g * W + x0 + j] = acc;
    }
}

template <int N>
__device__ __forceinline__ void carcass(int trips, int walk_floor,
                                        int offset, int g, int x0,
                                        float* __restrict__ out) {
    if (offset)
        carcass_lanes<N, true>(trips, walk_floor, g, x0, out);
    else
        carcass_lanes<N, false>(trips, walk_floor, g, x0, out);
}

template <int V>
__global__ void __launch_bounds__(NT, 1)
probe_loop_kernel(int trips, int walk_floor, int offset,
                  float* __restrict__ out) {
    extern __shared__ __align__(16) float scratch[];   // body/scratch only
    __shared__ Shared sh;
    __shared__ __align__(4) int8_t tbs[(V == V_DEADCODE) ? GRP * TBW : 1];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int g0 = tid / TPR;
    const int x0 = (tid % TPR) * LPT;         // first lane of this thread

    if constexpr (V == V_CARCASS) {
        carcass<LPT>(trips, walk_floor, offset, g0, x0, out);
    } else {
        float r[NROW][LPT];
        constexpr bool kScratch = V == V_BODY_SCRATCH;
        constexpr bool kBias = V == V_S0D_COND || V == V_S0D_BODY
            || V == V_S0D_BOTH;
        constexpr bool kOrg = V == V_S0D_BODY || V == V_S0D_BOTH;
        constexpr bool kCond = V == V_S0D_COND || V == V_S0D_BOTH;
        constexpr int kTiles = (V == V_NESTED || V == V_NESTED_WALK) ? 2 : 1;
        float* srow = scratch + (size_t)g0 * W + x0;   // row i at i*GRP*W
        float acc[LPT];
#pragma unroll
        for (int j = 0; j < LPT; ++j) acc[j] = 0.0f;
        float msp[GRP];
        int org = 0;
        int par = 0;
        if constexpr (V == V_DEADCODE) fill_tbs(tbs, tid, NT);
        for (int t = 0; t < kTiles; ++t) {
#pragma unroll
            for (int i = 0; i < NROW; ++i)
#pragma unroll
                for (int j = 0; j < LPT; ++j) {
                    if constexpr (kScratch)
                        r[i][j] = offset ? (float)i + 1.0f : qnan();
                    else if constexpr (kTiles == 2)
                        r[i][j] = acc[j] * (float)0.001 + (float)(i + 1.0);
                    else
                        r[i][j] = (float)i + 1.0f;
                    if (offset) r[i][j] = r[i][j] + init_offset(g0, x0 + j);
                }
            if constexpr (kScratch) {
#pragma unroll
                for (int i = 0; i < NROW; ++i)
#pragma unroll
                    for (int j = 0; j < LPT; ++j)
                        srow[(size_t)i * GRP * W + j] = r[i][j];
            }
#pragma unroll
            for (int g = 0; g < GRP; ++g) msp[g] = -1e3f;
            int run[GRP], cnt[GRP];
#pragma unroll
            for (int g = 0; g < GRP; ++g) { run[g] = 1; cnt[g] = 0; }
            put_boundary(sh.bnd[par], r, warp, lane);
            __syncthreads();
            int k = 0;
            while (keep_going<kCond>(run, k, trips)) {
#pragma unroll
                for (int b = 0; b < 2; ++b) {
                    if constexpr (kScratch) {
#pragma unroll
                        for (int i = 0; i < NROW; ++i)
#pragma unroll
                            for (int j = 0; j < LPT; ++j)
                                r[i][j] = srow[(size_t)i * GRP * W + j];
                    }
                    dp_body<kBias>(sh, r, msp, par, warp, lane, x0, org);
                    if constexpr (kScratch) {
#pragma unroll
                        for (int i = 0; i < NROW; ++i)
#pragma unroll
                            for (int j = 0; j < LPT; ++j)
                                srow[(size_t)i * GRP * W + j] = r[i][j];
                    }
                    par ^= 1;
                    k += 1;
                    if constexpr (kOrg) org = next_org(org, msp);
                    if constexpr (kCond) cond_step(run, cnt, trips);
                }
            }
            int emit = 0;
            if constexpr (V == V_DEADCODE || V == V_NESTED_WALK) {
                const int done = min(max_msp_i32(msp), walk_floor);
                emit = dead_walks<V == V_DEADCODE>(tbs, done);
            }
            if constexpr (V == V_DEADCODE) dead_merge(tbs, emit, tid, NT);
#pragma unroll
            for (int j = 0; j < LPT; ++j) {
                float v = r[0][j] + msp[g0];
                if constexpr (kOrg || kBias) v = v + (float)org;
                if constexpr (V == V_DEADCODE || kTiles == 2)
                    v = v + (float)emit;
                acc[j] = v;
            }
        }
#pragma unroll
        for (int j = 0; j < LPT; ++j) out[g0 * W + x0 + j] = acc[j];
    }
}

// ---- cluster instances ---------------------------------------------------

__device__ __forceinline__ int cluster_rank() {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return (int)r;
}

// every thread of every CTA of the cluster: arrive (releasing this
// thread's shared-memory writes, local and remote), then wait (acquiring
// the others')
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release;\n\t"
                 "barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// the shared::cluster address of shared-memory word `local` in the
// cluster's CTA `rank`
__device__ __forceinline__ unsigned map_to(const void* local, int rank) {
    unsigned ra;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(ra) : "r"(smem_addr(local)), "r"((unsigned)rank));
    return ra;
}

// v into word `local` of CTA `rank`; a cluster barrier publishes it
__device__ __forceinline__ void store_to(float* local, int rank, float v) {
    asm volatile("st.shared::cluster.b32 [%0], %1;"
                 :: "r"(map_to(local, rank)), "r"(__float_as_uint(v))
                 : "memory");
}

// v into word `local` of CTA `rank`, completing 4 bytes of the
// transaction that CTA's mbarrier `bar` waits for
__device__ __forceinline__ void store_async_to(float* local, int rank,
                                               float v, uint64_t* bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32"
                 " [%0], %1, [%2];"
                 :: "r"(map_to(local, rank)), "r"(__float_as_uint(v)),
                    "r"(map_to(bar, rank)) : "memory");
}

// an mbarrier of one arrival a phase, visible to the cluster's CTAs after
// the next cluster barrier
__device__ __forceinline__ void bar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n\t"
                 "fence.mbarrier_init.release.cluster;"
                 :: "r"(smem_addr(bar)) : "memory");
}

// the phase's one arrival, expecting `bytes` of st.async stores
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// waits for the phase of parity `parity` to complete (acquiring the
// stores that completed it)
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
    unsigned done;
    do {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64"
                     " p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                     : "memory");
    } while (!done);
}

struct ClusterShared {
    float bnd[2][CW][2];      // each warp's last lane of rows 0 and 2, by parity
    float part[2][CW];        // this CTA's warp maxima of s, by body parity
    float rows[2][GRP];       // scalar0d/body, /both: every CTA's row maximum
                              // of the body, by parity (stored by each CTA)
    float tile[2][GRP];       // deadcode, nested+walk: every CTA's msp at
                              // tile t's end
    uint64_t full[2];         // st.async exchange: rows[p] holds all 8
};

__device__ __forceinline__ float row_max(const float (&part)[CW]) {
    float m = part[0];
#pragma unroll
    for (int w = 1; w < CW; ++w) m = jmax(m, part[w]);
    return m;
}

// Every variant (module doc): CTA g of the cluster computes group row g.
// Launched only as one cluster of NCTA CTAs (cluster_config), whose
// dynamic shared memory (the reserve) holds body/scratch's slice of the
// scratch.
template <int V>
__global__ void __launch_bounds__(CT)
probe_cluster_kernel(int trips, int walk_floor, int offset,
                     float* __restrict__ out) {
    static_assert(V < N_VARIANTS, "no such variant");
    if constexpr (V == V_CARCASS) {
        // the rows never meet: no exchange, no cluster barrier
        carcass<CL>(trips, walk_floor, offset, cluster_rank(),
                    (int)threadIdx.x * CL, out);
        return;
    }
    constexpr bool kScratch = V == V_BODY_SCRATCH;
    constexpr bool kBias = V == V_S0D_COND || V == V_S0D_BODY
        || V == V_S0D_BOTH;
    constexpr bool kOrg = V == V_S0D_BODY || V == V_S0D_BOTH;   // exchange a body
    constexpr bool kCond = V == V_S0D_COND || V == V_S0D_BOTH;
    constexpr bool kTbs = V == V_DEADCODE;
    constexpr bool kWalk = kTbs || V == V_NESTED_WALK;          // exchange a tile
    constexpr int kTiles = (V == V_NESTED || V == V_NESTED_WALK) ? 2 : 1;
    constexpr int kRows = kOrg ? GRP : 1;    // row maxima a thread holds
    constexpr bool kAsync = PROBE_CLUSTER_EXCHANGE == 0;
    extern __shared__ __align__(16) float slice[];   // row i at i * W
    __shared__ ClusterShared sh;
    __shared__ __align__(4) int8_t tbs[kTbs ? GRP * TBW : 1];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int g0 = cluster_rank();           // this CTA's group row
    const int x0 = tid * CL;                 // first lane of this thread
    // the warp whose last lane rolls into this warp's first (warp 0 takes
    // the row's last lane: the roll wraps around)
    const int pw = (warp + CW - 1) % CW;
    float* srow = slice + x0;
    float r[NROW][CL];
    float acc[CL];
#pragma unroll
    for (int j = 0; j < CL; ++j) acc[j] = 0.0f;
    float msp[kRows];
    int org = 0;
    int par = 0;
    unsigned phase = 0;                      // bit p: full[p]'s phase parity
    if constexpr (kOrg && kAsync) {
        if (tid == 0) {
            bar_init(&sh.full[0]);
            bar_init(&sh.full[1]);
        }
    }
    if constexpr (kTbs) fill_tbs(tbs, tid, CT);
    cluster_sync();                          // every CTA has started
    for (int t = 0; t < kTiles; ++t) {
#pragma unroll
        for (int i = 0; i < NROW; ++i)
#pragma unroll
            for (int j = 0; j < CL; ++j) {
                if constexpr (kScratch)
                    r[i][j] = offset ? (float)i + 1.0f : qnan();
                else if constexpr (kTiles == 2)
                    r[i][j] = acc[j] * (float)0.001 + (float)(i + 1.0);
                else
                    r[i][j] = (float)i + 1.0f;
                if (offset) r[i][j] = r[i][j] + init_offset(g0, x0 + j);
                if constexpr (kScratch) srow[i * W + j] = r[i][j];
            }
#pragma unroll
        for (int g = 0; g < kRows; ++g) msp[g] = -1e3f;
        int run[GRP], cnt[GRP];
#pragma unroll
        for (int g = 0; g < GRP; ++g) { run[g] = 1; cnt[g] = 0; }
        put_boundary(sh.bnd[par], r, warp, lane);
        __syncthreads();
        int k = 0;
        while (keep_going<kCond>(run, k, trips)) {
#pragma unroll
            for (int b = 0; b < 2; ++b) {
                if constexpr (kScratch) {
#pragma unroll
                    for (int i = 0; i < NROW; ++i)
#pragma unroll
                        for (int j = 0; j < CL; ++j) r[i][j] = srow[i * W + j];
                }
                const float tmax = row_body<CL, kBias>(sh.bnd[par], r, pw,
                                                       lane, x0, org);
                if constexpr (kScratch) {
#pragma unroll
                    for (int i = 0; i < NROW; ++i)
#pragma unroll
                        for (int j = 0; j < CL; ++j) srow[i * W + j] = r[i][j];
                }
                if (lane == 0) sh.part[par][warp] = tmax;
                put_boundary(sh.bnd[par ^ 1], r, warp, lane);
                __syncthreads();
                const float mx = row_max(sh.part[par]);   // this row's, this body
                if constexpr (kOrg) {
                    // thread k stores it into CTA k; every CTA then holds
                    // all 8 rows' maxima of the body
                    if constexpr (kAsync) {
                        if (tid < NCTA)
                            store_async_to(&sh.rows[par][g0], tid, mx, &sh.full[par]);
                        if (tid == 0)
                            bar_expect(&sh.full[par], NCTA * sizeof(float));
                        bar_wait(&sh.full[par], (phase >> par) & 1u);
                        phase ^= 1u << par;
                    } else {
                        if (tid < NCTA) store_to(&sh.rows[par][g0], tid, mx);
                        cluster_sync();
                    }
#pragma unroll
                    for (int g = 0; g < GRP; ++g)
                        msp[g] = jmax(msp[g], sh.rows[par][g]);
                } else {
                    msp[0] = jmax(msp[0], mx);
                }
                par ^= 1;
                k += 1;
                if constexpr (kOrg) org = next_org(org, msp);
                if constexpr (kCond) cond_step(run, cnt, trips);
            }
        }
        float mine = msp[0];                 // this row's maximum
        if constexpr (kOrg) {
#pragma unroll
            for (int g = 1; g < GRP; ++g) mine = (g == g0) ? msp[g] : mine;
        }
        int emit = 0;
        if constexpr (kWalk) {
            // the walks start from the maximum of all 8 row maxima: one
            // push of this row's into every CTA, one cluster barrier
            if (tid < NCTA) store_to(&sh.tile[t][g0], tid, mine);
            cluster_sync();
            float all[GRP];
#pragma unroll
            for (int g = 0; g < GRP; ++g) all[g] = sh.tile[t][g];
            const int done = min(max_msp_i32(all), walk_floor);
            emit = dead_walks<kTbs>(tbs, done);
        }
        if constexpr (kTbs) dead_merge(tbs, emit, tid, CT);
#pragma unroll
        for (int j = 0; j < CL; ++j) {
            float v = r[0][j] + mine;
            if constexpr (kBias) v = v + (float)org;
            if constexpr (kWalk || kTiles == 2) v = v + (float)emit;
            acc[j] = v;
        }
    }
#pragma unroll
    for (int j = 0; j < CL; ++j) out[g0 * W + x0 + j] = acc[j];
    cluster_sync();                          // no CTA leaves before its peers
}

// One cluster of NCTA CTAs: the launch's configuration and its occupancy
// query's. Each CTA reserves more than half an SM's 228 KB of shared
// memory (unused), so no two share an SM: the cluster spans 8 SMs, as a
// pair's band split over a cluster would.
constexpr int CLUSTER_RESERVE = 116 * 1024;

template <int V>
cudaError_t cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* at,
                           cudaStream_t s) {
    const cudaError_t e = cudaFuncSetAttribute(
        probe_cluster_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        CLUSTER_RESERVE);
    at->id = cudaLaunchAttributeClusterDimension;
    at->val.clusterDim.x = NCTA;
    at->val.clusterDim.y = 1;
    at->val.clusterDim.z = 1;
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(NCTA);
    cfg->blockDim = dim3(CT);
    cfg->dynamicSmemBytes = CLUSTER_RESERVE;
    cfg->stream = s;
    cfg->attrs = at;
    cfg->numAttrs = 1;
    return e;
}

template <int V>
cudaError_t launch_cluster(int trips, int walk_floor, int offset, float* out,
                           cudaStream_t s) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute at;
    const cudaError_t ce = cluster_config<V>(&cfg, &at, s);
    if (ce != cudaSuccess) return ce;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, probe_cluster_kernel<V>,
                                             trips, walk_floor, offset, out);
    const cudaError_t last = cudaGetLastError();   // clears a refused launch
    return e != cudaSuccess ? e : last;
}

template <int V>
cudaError_t launch(int trips, int walk_floor, int offset, float* out,
                   cudaStream_t s) {
    size_t smem = 0;
    if constexpr (V == V_BODY_SCRATCH) {
        smem = (size_t)NROW * GRP * W * sizeof(float);   // 160 KB
        const cudaError_t e = cudaFuncSetAttribute(
            probe_loop_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return e;
    }
    probe_loop_kernel<V><<<1, NT, smem, s>>>(trips, walk_floor, offset, out);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches probe `variant` (ops/probe_loop.py KERNEL_ID) for `trips` loop
// steps into out (f32 [8, 640]) on `stream`, as one block or (cluster !=
// 0) one cluster of 8 CTAs, with the initial state's offset when offset
// != 0; returns the launch's error (cudaSuccess = 0; a refused cluster
// launch is an error, never a one-block launch). Does not synchronise.
cudaError_t probe_loop_launch(int variant, int cluster, int trips,
                              int walk_floor, int offset, void* out,
                              void* stream) {
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (trips < 0 || out == nullptr) return cudaErrorInvalidValue;
    if (cluster) {
        switch (variant) {
            case V_CARCASS: return launch_cluster<V_CARCASS>(trips, walk_floor, offset, o, s);
            case V_BODY_CARRIED: return launch_cluster<V_BODY_CARRIED>(trips, walk_floor, offset, o, s);
            case V_BODY_SCRATCH: return launch_cluster<V_BODY_SCRATCH>(trips, walk_floor, offset, o, s);
            case V_S0D_COND: return launch_cluster<V_S0D_COND>(trips, walk_floor, offset, o, s);
            case V_S0D_BODY: return launch_cluster<V_S0D_BODY>(trips, walk_floor, offset, o, s);
            case V_S0D_BOTH: return launch_cluster<V_S0D_BOTH>(trips, walk_floor, offset, o, s);
            case V_DEADCODE: return launch_cluster<V_DEADCODE>(trips, walk_floor, offset, o, s);
            case V_NESTED: return launch_cluster<V_NESTED>(trips, walk_floor, offset, o, s);
            case V_NESTED_WALK: return launch_cluster<V_NESTED_WALK>(trips, walk_floor, offset, o, s);
            default: return cudaErrorInvalidValue;
        }
    }
    switch (variant) {
        case V_CARCASS: return launch<V_CARCASS>(trips, walk_floor, offset, o, s);
        case V_BODY_CARRIED: return launch<V_BODY_CARRIED>(trips, walk_floor, offset, o, s);
        case V_BODY_SCRATCH: return launch<V_BODY_SCRATCH>(trips, walk_floor, offset, o, s);
        case V_S0D_COND: return launch<V_S0D_COND>(trips, walk_floor, offset, o, s);
        case V_S0D_BODY: return launch<V_S0D_BODY>(trips, walk_floor, offset, o, s);
        case V_S0D_BOTH: return launch<V_S0D_BOTH>(trips, walk_floor, offset, o, s);
        case V_DEADCODE: return launch<V_DEADCODE>(trips, walk_floor, offset, o, s);
        case V_NESTED: return launch<V_NESTED>(trips, walk_floor, offset, o, s);
        case V_NESTED_WALK: return launch<V_NESTED_WALK>(trips, walk_floor, offset, o, s);
        default: return cudaErrorInvalidValue;
    }
}

// cudaFuncGetAttributes of probe `variant` as one block or (cluster != 0)
// as a cluster: out = [registers per thread, local (spill) bytes per
// thread, static shared bytes, max threads per block, threads a launch
// gives a block, blocks a cluster, cudaOccupancyMaxActiveClusters of the
// launch (cluster; 0 for one block)].
cudaError_t probe_loop_attributes(int variant, int cluster, int* out) {
    const void* fn = nullptr;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute at;
    cudaError_t e = cudaSuccess;
    if (cluster) {
        switch (variant) {
            case V_CARCASS: fn = (const void*)probe_cluster_kernel<V_CARCASS>;
                e = cluster_config<V_CARCASS>(&cfg, &at, 0); break;
            case V_BODY_CARRIED: fn = (const void*)probe_cluster_kernel<V_BODY_CARRIED>;
                e = cluster_config<V_BODY_CARRIED>(&cfg, &at, 0); break;
            case V_BODY_SCRATCH: fn = (const void*)probe_cluster_kernel<V_BODY_SCRATCH>;
                e = cluster_config<V_BODY_SCRATCH>(&cfg, &at, 0); break;
            case V_S0D_COND: fn = (const void*)probe_cluster_kernel<V_S0D_COND>;
                e = cluster_config<V_S0D_COND>(&cfg, &at, 0); break;
            case V_S0D_BODY: fn = (const void*)probe_cluster_kernel<V_S0D_BODY>;
                e = cluster_config<V_S0D_BODY>(&cfg, &at, 0); break;
            case V_S0D_BOTH: fn = (const void*)probe_cluster_kernel<V_S0D_BOTH>;
                e = cluster_config<V_S0D_BOTH>(&cfg, &at, 0); break;
            case V_DEADCODE: fn = (const void*)probe_cluster_kernel<V_DEADCODE>;
                e = cluster_config<V_DEADCODE>(&cfg, &at, 0); break;
            case V_NESTED: fn = (const void*)probe_cluster_kernel<V_NESTED>;
                e = cluster_config<V_NESTED>(&cfg, &at, 0); break;
            case V_NESTED_WALK: fn = (const void*)probe_cluster_kernel<V_NESTED_WALK>;
                e = cluster_config<V_NESTED_WALK>(&cfg, &at, 0); break;
            default: return cudaErrorInvalidValue;
        }
        if (e != cudaSuccess) return e;
    } else {
        switch (variant) {
            case V_CARCASS: fn = (const void*)probe_loop_kernel<V_CARCASS>; break;
            case V_BODY_CARRIED: fn = (const void*)probe_loop_kernel<V_BODY_CARRIED>; break;
            case V_BODY_SCRATCH: fn = (const void*)probe_loop_kernel<V_BODY_SCRATCH>; break;
            case V_S0D_COND: fn = (const void*)probe_loop_kernel<V_S0D_COND>; break;
            case V_S0D_BODY: fn = (const void*)probe_loop_kernel<V_S0D_BODY>; break;
            case V_S0D_BOTH: fn = (const void*)probe_loop_kernel<V_S0D_BOTH>; break;
            case V_DEADCODE: fn = (const void*)probe_loop_kernel<V_DEADCODE>; break;
            case V_NESTED: fn = (const void*)probe_loop_kernel<V_NESTED>; break;
            case V_NESTED_WALK: fn = (const void*)probe_loop_kernel<V_NESTED_WALK>; break;
            default: return cudaErrorInvalidValue;
        }
    }
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, fn);
    if (e != cudaSuccess) return e;
    out[0] = fa.numRegs;
    out[1] = (int)fa.localSizeBytes;
    out[2] = (int)fa.sharedSizeBytes;
    out[3] = fa.maxThreadsPerBlock;
    out[4] = cluster ? CT : NT;
    out[5] = cluster ? NCTA : 1;
    out[6] = 0;
    if (cluster) e = cudaOccupancyMaxActiveClusters(&out[6], fn, &cfg);
    return e;
}

}  // extern "C"
