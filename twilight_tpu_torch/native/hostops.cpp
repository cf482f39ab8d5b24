// Native host-side alignment helpers (ctypes).
//
// pairwise_global: affine-gap global alignment with free end gaps on two
// letter-index strings, used to re-align simultaneously-gappy column blocks
// (reference semantics: alignment-helper.cpp:243-322). Implemented natively
// because the DP must run in float32 with the reference's exact operation
// order and tie-breaking; Python-level f32 emulation is ~100x slower.
//
// prep_level_scan / prep_level_fill: a whole level's pair prep on a pool
// of threads (below).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -pthread hostops.cpp -o libhostops.so
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#include <unistd.h>

namespace {

inline float max3(float a, float b, float c) {
    return std::max(a, std::max(b, c));
}

}  // namespace

extern "C" {

// seq1/seq2: letter indices (row/col into matrix). matrix: msize*msize f32.
// out: caller-allocated int8 buffer of capacity >= m+n. Returns path length.
int64_t pairwise_global(const int32_t* seq1, int64_t m,
                        const int32_t* seq2, int64_t n,
                        const float* matrix, int32_t msize,
                        float gap_open, float gap_extend,
                        int8_t* out) {
    const float NEG = -1e9f;
    std::vector<float> M((m + 1) * (n + 1), 0.0f);
    std::vector<float> X((m + 1) * (n + 1), 0.0f);
    std::vector<float> Y((m + 1) * (n + 1), 0.0f);
    std::vector<int8_t> tb((m + 1) * (n + 1), 0);
    auto at = [&](int64_t i, int64_t j) { return i * (n + 1) + j; };

    for (int64_t i = 1; i <= m; ++i) {
        M[at(i, 0)] = 0.0f;
        X[at(i, 0)] = M[at(i, 0)];
        Y[at(i, 0)] = NEG;
        tb[at(i, 0)] = 2;
    }
    for (int64_t j = 1; j <= n; ++j) {
        M[at(0, j)] = 0.0f;
        Y[at(0, j)] = M[at(0, j)];
        X[at(0, j)] = NEG;
        tb[at(0, j)] = 1;
    }
    for (int64_t i = 1; i <= m; ++i) {
        for (int64_t j = 1; j <= n; ++j) {
            float base = matrix[seq1[i - 1] * msize + seq2[j - 1]];
            float diag = max3(M[at(i - 1, j - 1)], X[at(i - 1, j - 1)],
                              Y[at(i - 1, j - 1)]);
            float mm = base + diag;
            float xx = std::max(M[at(i - 1, j)] + gap_open,
                                X[at(i - 1, j)] + gap_extend);
            float yy = std::max(M[at(i, j - 1)] + gap_open,
                                Y[at(i, j - 1)] + gap_extend);
            M[at(i, j)] = mm;
            X[at(i, j)] = xx;
            Y[at(i, j)] = yy;
            float best = max3(mm, xx, yy);
            // tie-break: match first, then gap-in-reference (1), then 2
            int8_t d;
            if (best == mm) d = 0;
            else if (best == yy) d = 1;
            else d = 2;
            tb[at(i, j)] = d;
        }
    }
    int64_t i = m, j = n, len = 0;
    while (i > 0 || j > 0) {
        int8_t d = tb[at(i, j)];
        out[len++] = d;
        if (d == 0) { --i; --j; }
        else if (d == 1) { --j; }
        else { --i; }
    }
    std::reverse(out, out + len);
    return len;
}

// Apply an alignment path to a batch of byte rows (the updateAlignment char
// shuffle, reference alignment-helper.cpp:389-447). keep_code0/1: the two
// path codes that consume an input char (0/2 for reference side, 0/1 for
// query side). rows: num_rows * in_stride bytes in, num_rows * aln_len out.
void apply_path_chars(const int8_t* aln, int64_t aln_len,
                      const uint8_t* rows_in, int64_t in_stride,
                      uint8_t* rows_out, int64_t num_rows,
                      int32_t keep_code_a, int32_t keep_code_b,
                      uint8_t gap_char) {
    std::vector<int64_t> src(aln_len);
    int64_t org = 0;
    for (int64_t k = 0; k < aln_len; ++k) {
        if (aln[k] == keep_code_a || aln[k] == keep_code_b) src[k] = org++;
        else src[k] = -1;
    }
    for (int64_t r = 0; r < num_rows; ++r) {
        const uint8_t* in = rows_in + r * in_stride;
        uint8_t* out = rows_out + r * aln_len;
        for (int64_t k = 0; k < aln_len; ++k) {
            out[k] = (src[k] >= 0) ? in[src[k]] : gap_char;
        }
    }
}

// Weighted per-sequence profile accumulation (the hot loop of
// calculateProfile, reference alignment-helper.cpp:23-34). Float semantics
// are load-bearing: each column add is f32(double(acc) + double(w)),
// sequence-by-sequence in member order — identical to the Python loop in
// pipeline/helpers.py it replaces, ~60x faster.
// rows: nseq pointers to length-`length` byte rows; lut: 256-entry letter
// index table; profile: length*psize f32, updated in place.
void accumulate_profile(const uint8_t** rows, const float* weights,
                        int64_t nseq, const uint8_t* lut, int64_t length,
                        int64_t psize, float* profile) {
    for (int64_t s = 0; s < nseq; ++s) {
        const double w = (double)weights[s];
        const uint8_t* row = rows[s];
        for (int64_t k = 0; k < length; ++k) {
            float* cell = profile + k * psize + lut[row[k]];
            *cell = (float)((double)*cell + w);
        }
    }
}

}  // extern "C"

// Level prep: every pair's profile, consensus, gappy runs, compaction and
// gap scores (pipeline/aligner.py's _prepare_pair) for a whole level, on a
// pool of threads. The float operations and their order are those of the
// Python path (pipeline/helpers.py), so the bytes are the same.
//
// A level has 2 * npairs sides, side 2i the reference of pair i and 2i+1
// its query. A side's full profile has rows[s] rows: its cached profile's
// (freq[s] != 0) or len[s], the side's aln_len. Consensus, gappy runs and
// gap scores read its first len[s] rows.
struct PrepIn {
    int64_t npairs;
    int64_t psize;
    const uint8_t* lut;         // 256 letter indices; psize - 1 is the gap
    const uint8_t* letters;     // psize - 1 consensus letters
    const int64_t* len;         // [2n] aln_len
    const int64_t* rows;        // [2n] rows of the full profile
    const int64_t* num;         // [2n] aln_num
    const float* weight;        // [2n] f32(aln_weight)
    const uint64_t* freq;       // [2n] cached profile (f32 rows x psize) or 0
    const int64_t* mem_off;     // [2n + 1] a side's members in mem_*
    const uint64_t* mem_rows;   // member byte rows, in seqs_included order
    const float* mem_w;         // member f32(seq.weight)
    int32_t gappy;              // threshold != 1.0
    float threshold;
    float gap_open, gap_extend, scale;
};

// Where prep_level_fill writes side s: the compacted profile (n_runs[s] ?
// kept[s] : rows[s] rows), len[s] consensus bytes, kept[s] gap open and
// extend scores, n_runs[s] (start, length) pairs, and, where store[s] is
// not 0, the full profile divided back (len[s] rows) for node.msa_freq.
struct PrepOut {
    const int64_t* n_runs;
    const int64_t* kept;
    const uint64_t* prof;
    const uint64_t* cons;
    const uint64_t* op;
    const uint64_t* ex;
    const uint64_t* runs;
    const uint64_t* store;
};

namespace {

template <class T>
inline T* at_ptr(uint64_t p) { return reinterpret_cast<T*>(p); }

inline int64_t members(const PrepIn& in, int64_t s) {
    return in.mem_off[s + 1] - in.mem_off[s];
}

// A member's weight times its side's count, as calculateProfile scales it.
inline double member_weight(const PrepIn& in, int64_t s, int64_t m) {
    return (double)((in.mem_w[m] / in.weight[s]) * (float)in.num[s]);
}

// Adds side s's members into prof (len x psize, zero there):
// f32(double(acc) + double(w)), member by member.
void accumulate(const PrepIn& in, int64_t s, float* prof) {
    const int64_t P = in.psize;
    for (int64_t m = in.mem_off[s]; m < in.mem_off[s + 1]; ++m) {
        const double w = member_weight(in, s, m);
        const uint8_t* row = at_ptr<const uint8_t>(in.mem_rows[m]);
        for (int64_t k = 0; k < in.len[s]; ++k) {
            float* cell = prof + k * P + in.lut[row[k]];
            *cell = (float)((double)*cell + w);
        }
    }
}

// The same sums for the gap letter alone, into gap (len, zero there).
void accumulate_gap(const PrepIn& in, int64_t s, float* gap) {
    const uint8_t g = (uint8_t)(in.psize - 1);
    for (int64_t m = in.mem_off[s]; m < in.mem_off[s + 1]; ++m) {
        const double w = member_weight(in, s, m);
        const uint8_t* row = at_ptr<const uint8_t>(in.mem_rows[m]);
        for (int64_t k = 0; k < in.len[s]; ++k)
            if (in.lut[row[k]] == g) gap[k] = (float)((double)gap[k] + w);
    }
}

// The runs of columns whose gap share passes the threshold (_gappy_runs),
// gap[k * stride] the gap sum of column k: calls run(start, length) for
// each and returns the columns they cover.
template <class F>
int64_t gappy_runs(const PrepIn& in, int64_t s, const float* gap,
                   int64_t stride, F run) {
    const float nf = (float)in.num[s];
    int64_t covered = 0, start = -1;
    for (int64_t k = 0; k <= in.len[s]; ++k) {
        const bool over = k < in.len[s] && gap[k * stride] / nf > in.threshold;
        if (over && start < 0) start = k;
        if (!over && start >= 0) {
            run(start, k - start);
            covered += k - start;
            start = -1;
        }
    }
    return covered;
}

// np.minimum(a, b) of two f32: b where it is NaN.
inline float np_min(float a, float b) {
    return (b != b) ? b : (a <= b ? a : b);
}

// Consensus, runs, compaction and gap scores of side s from its full
// profile. Returns false where the compaction disagrees with the scan.
bool side_fill(const PrepIn& in, const PrepOut& out, int64_t s,
               const float* prof) {
    const int64_t P = in.psize, L = in.len[s];
    const float nf = (float)in.num[s];
    // consensus (get_consensus): np.argmax's first strict maximum over the
    // letters, the ambiguity letter where it is not above 0 or is NaN
    uint8_t* cons = at_ptr<uint8_t>(out.cons[s]);
    for (int64_t k = 0; k < L; ++k) {
        const float* r = prof + k * P;
        int64_t best = 0;
        float mx = r[0];
        bool nan = mx != mx;
        for (int64_t j = 1; j < P - 2 && !nan; ++j) {
            if (r[j] != r[j]) nan = true;
            else if (r[j] > mx) { mx = r[j]; best = j; }
        }
        cons[k] = in.letters[(!nan && mx > 0) ? best : P - 2];
    }
    // gappy runs and compaction (remove_gappy_columns)
    const int64_t n_runs = out.n_runs[s], kept = out.kept[s];
    float* dst = at_ptr<float>(out.prof[s]);
    if (n_runs == 0) {
        if (kept != L) return false;
        std::copy(prof, prof + in.rows[s] * P, dst);
    } else {
        int64_t* runs = at_ptr<int64_t>(out.runs[s]);
        int64_t n = 0, from = 0, to = 0;
        auto keep = [&](int64_t a, int64_t b) {
            std::copy(prof + a * P, prof + b * P, dst + to * P);
            to += b - a;
        };
        gappy_runs(in, s, prof + P - 1, P, [&](int64_t a, int64_t len) {
            if (n < n_runs && to + a - from <= kept) {
                runs[2 * n] = a;
                runs[2 * n + 1] = len;
                keep(from, a);
            }
            ++n;
            from = a + len;
        });
        if (n != n_runs || to + L - from != kept) return false;
        keep(from, L);
    }
    // gap scores (calculate_psgp) over the compacted profile
    const float go = in.gap_open, ge = in.gap_extend;
    const float a = go * in.scale;
    const float min_ge = (float)((double)ge * 0.2);
    const float min_go = (float)((double)go * 0.1);
    float* op = at_ptr<float>(out.op[s]);
    float* ex = at_ptr<float>(out.ex[s]);
    for (int64_t k = 0; k < kept; ++k) {
        const float g = dst[k * P + P - 1];
        const double frac = (double)(nf - g) * 1.0 / (double)in.num[s];
        op[k] = g > 0 ? np_min(min_go, (float)((double)a * frac)) : go;
        ex[k] = g > 0 ? np_min(min_ge, (float)((double)ge * frac)) : ge;
    }
    return true;
}

// Worker threads that outlive a call. On the H100's host, making and
// joining 7 threads takes 1.2-1.5 ms, more than most levels' whole prep,
// and a level runs two rounds. Made on first use, detached and never
// destroyed, so that no exit-time destructor pulls their state away.
class Pool {
  public:
    // fn(worker) on the calling thread (worker 0) and on workers 1 to
    // nthreads - 1 (fewer where a thread cannot be made); returns when all
    // have returned.
    void run(int64_t nthreads, const std::function<void(int64_t)>& fn) {
        std::lock_guard<std::mutex> one(call_);
        if (nthreads > 1) start(nthreads, fn);
        fn(0);
        std::unique_lock<std::mutex> lk(m_);
        done_.wait(lk, [&] { return busy_ == 0; });
    }

  private:
    void start(int64_t nthreads, const std::function<void(int64_t)>& fn) {
        std::lock_guard<std::mutex> lk(m_);
        if (pid_ != getpid()) {     // a forked child has none of the threads
            pid_ = getpid();
            workers_ = 0;
        }
        while (workers_ < nthreads - 1) {
            try {
                std::thread(&Pool::serve, this, workers_ + 1, round_).detach();
            } catch (...) {
                break;
            }
            ++workers_;
        }
        want_ = std::min(nthreads, workers_ + 1);
        busy_ = want_ - 1;
        fn_ = &fn;
        ++round_;
        wake_.notify_all();
    }

    void serve(int64_t w, uint64_t seen) {
        std::unique_lock<std::mutex> lk(m_);
        for (;;) {
            wake_.wait(lk, [&] { return round_ != seen; });
            seen = round_;
            if (w >= want_) continue;
            const std::function<void(int64_t)>& fn = *fn_;
            lk.unlock();
            fn(w);
            lk.lock();
            if (--busy_ == 0) done_.notify_one();
        }
    }

    std::mutex call_;               // one round at a time
    std::mutex m_;
    std::condition_variable wake_, done_;
    const std::function<void(int64_t)>* fn_ = nullptr;
    pid_t pid_ = 0;
    int64_t workers_ = 0, want_ = 0, busy_ = 0;
    uint64_t round_ = 0;
};

Pool& pool() {
    static Pool* p = new Pool;
    return *p;
}

// Runs body(task, worker) for every task in [0, n) on up to nthreads
// threads (the pool's and the calling one, worker 0); each takes the next
// task from a shared index.
template <class F>
void parallel(int64_t n, int64_t nthreads, F body) {
    if (n <= 0) return;
    std::atomic<int64_t> next{0};
    pool().run(std::min(nthreads, n), [&](int64_t w) {
        for (int64_t t; (t = next.fetch_add(1)) < n;) body(t, w);
    });
}

// side(s, scratch) for both sides of every pair of a level, pairs largest
// first, a worker's scratch lent to each. A task writes only its own
// outputs, so the bytes do not depend on the thread count.
template <class Side>
void for_level(const PrepIn& in, int64_t nthreads, Side side) {
    const int64_t n = in.npairs;
    std::vector<int64_t> cost(n, 0), order(n);
    for (int64_t s = 0; s < 2 * n; ++s) {
        cost[s / 2] += in.rows[s] * in.psize;
        if (!in.freq[s]) cost[s / 2] += members(in, s) * in.len[s];
    }
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t x, int64_t y) { return cost[x] > cost[y]; });
    std::vector<std::vector<float>> scratch(nthreads);
    parallel(n, nthreads, [&](int64_t t, int64_t w) {
        const int64_t i = order[t];
        for (int64_t s = 2 * i; s < 2 * i + 2; ++s) side(s, scratch[w]);
    });
}

}  // namespace

extern "C" {

// Pass one of a level's prep: each side's gappy runs (n_runs) and the
// columns it keeps (kept), from its gap column alone, so that the caller
// can size the compacted outputs. Without gappy removal every side keeps
// its len.
void prep_level_scan(const PrepIn* in, int64_t* n_runs, int64_t* kept,
                     int64_t nthreads) {
    for (int64_t s = 0; s < 2 * in->npairs; ++s) {
        n_runs[s] = 0;
        kept[s] = in->len[s];
    }
    if (!in->gappy) return;
    const int64_t P = in->psize;
    for_level(*in, nthreads, [&](int64_t s, std::vector<float>& gap) {
        const int64_t L = in->len[s];
        gap.assign(L, 0.0f);
        if (in->freq[s]) {
            const float* m = at_ptr<const float>(in->freq[s]);
            const float nf = (float)in->num[s], wf = in->weight[s];
            for (int64_t k = 0; k < L; ++k)
                gap[k] = (m[k * P + P - 1] / wf) * nf;
        } else {
            accumulate_gap(*in, s, gap.data());
        }
        kept[s] -= gappy_runs(*in, s, gap.data(), 1,
                              [&](int64_t, int64_t) { ++n_runs[s]; });
    });
}

// Pass two: every side's full profile, then its outputs (PrepOut).
// Returns the number of sides whose runs differ from the scan's (0: none
// can, the sums being the same).
int64_t prep_level_fill(const PrepIn* in, const PrepOut* out,
                        int64_t nthreads) {
    const int64_t P = in->psize;
    std::atomic<int64_t> bad{0};
    for_level(*in, nthreads, [&](int64_t s, std::vector<float>& prof) {
        const int64_t cells = in->rows[s] * P;
        const float nf = (float)in->num[s], wf = in->weight[s];
        prof.assign(cells, 0.0f);
        if (in->freq[s]) {
            const float* m = at_ptr<const float>(in->freq[s]);
            for (int64_t c = 0; c < cells; ++c)
                prof[c] = (m[c] / wf) * nf;
        } else {
            accumulate(*in, s, prof.data());
        }
        if (out->store[s]) {
            float* st = at_ptr<float>(out->store[s]);
            for (int64_t c = 0; c < cells; ++c)
                st[c] = (prof[c] / nf) * wf;
        }
        if (!side_fill(*in, *out, s, prof.data())) bad.fetch_add(1);
    });
    return bad.load();
}

// Apply an alignment path to many byte rows given per-row input pointers
// (updateAlignment char shuffle, reference alignment-helper.cpp:389-447).
// src_map: aln_len precomputed source indices (-1 = gap). rows_out is one
// contiguous num_rows*aln_len block the caller slices into per-seq views.
void apply_path_rows(const int64_t* src_map, int64_t aln_len,
                     const uint8_t** rows_in, uint8_t* rows_out,
                     int64_t num_rows, uint8_t gap_char) {
    for (int64_t r = 0; r < num_rows; ++r) {
        const uint8_t* in = rows_in[r];
        uint8_t* out = rows_out + r * aln_len;
        for (int64_t k = 0; k < aln_len; ++k) {
            const int64_t s = src_map[k];
            out[k] = (s >= 0) ? in[s] : gap_char;
        }
    }
}

// Sort permutation for the deferred-realign node list. The reference sorts
// fallback nodes with std::sort and a (alnNum desc, alnLen desc) comparator
// (progressive.cpp:282-286); std::sort is NOT stable, and the permutation
// of equal keys is libstdc++'s introsort order — which the byte-identical
// bar requires us to reproduce exactly. Running the same comparator through
// the same std::sort over the same input order yields that permutation.
void sort_fallback_perm(const int32_t* nums, const int32_t* lens,
                        int32_t* idx, int64_t n) {
    for (int64_t i = 0; i < n; ++i) idx[i] = (int32_t)i;
    std::sort(idx, idx + n, [&](int32_t a, int32_t b) {
        if (nums[a] == nums[b]) return lens[a] > lens[b];
        return nums[a] > nums[b];
    });
}

}  // extern "C"
