// IVF-PQ asymmetric distances (ADC) -> the k nearest candidates, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel B8 of the JAX package:
//   kernels/ann.py::_adc_topk_kernel (adc_topk): per query an int32 LUT
//   (m * n_codes entries), per candidate m int8 codes stored as code - 128
//   and an id; a candidate's distance is the sum of its m LUT entries, and
//   a candidate whose id is negative (ragged-cell padding) takes the
//   sentinel adc_dmax(m) = 255 m + 1 in value space.  The k smallest come
//   back ascending, ties to the smallest candidate position.  Like the
//   Pallas kernel, the fused route keeps only a (Q, k) list: the distances
//   never leave the chip.
//
// What bounds it on an H100: the bytes it must read once: the ids of every
// candidate (4 bytes), the codes of the valid ones only (m bytes; an
// invalid candidate's distance is the sentinel, known from its id) and the
// LUTs.  At the ANN serving bucket (Q = 1024, L = 32,768, m = 21, about
// half the slots cell padding, one contiguous run at the tail of each
// cell's list) that is 0.15 ms at 3.35 TB/s.  Under it, in shared memory:
// m table lookups a candidate, at random codes.
//
// Two routes (``ann.route``), counted by the wrapper:
//
// fused (k <= FUSED_K_MAX): one kernel computes and selects.
//  * A block of FT = 128 threads takes one query and a span of its
//    candidates, one candidate a thread in push groups of FT; eight blocks
//    an SM (at most 64 registers a thread), so the 1024 queries of a
//    bucket run in one wave.  The reads are latency-bound, so occupancy
//    sets the time: at the bucket 0.41, 0.34, 0.30 ms with two, three and
//    four 256-thread blocks an SM, 0.29 with eight of 128 (five and six
//    spill: 0.37, 0.44; launch/ann_breakdown.py).  Where Q is small the
//    spans split L (``ann.plan``) and the split merge kernel of
//    csrc/key_select.cuh finishes, as B5's does.
//  * The table: the block stages the query's LUT as one byte an entry,
//    m rows of 256, entry (j, u) = LUT[j][min(u ^ 0x80, n_codes - 1)], so
//    a stored code byte u indexes it as it is (the +128 and the hold past
//    n_codes are baked in).  A row of 256 bytes is 64 words over 32 banks,
//    so a warp's lookups into one row take at most two wavefronts, where
//    int32 entries at random codes take about 3.5.  The LUT is on the
//    0..255 step by construction (core/ann.py::build_query_luts); a block
//    that finds an entry outside it, or a table past TABLE_MAX bytes,
//    reads the int32 LUT from device memory instead (through L1).
//  * Loads: a thread reads its candidate's m code bytes straight into
//    registers by up to three aligned 16-byte loads, and two selects and
//    a funnel shift realign them (m <= FAST_M; wider codes are read byte
//    by byte).  The ids run two groups ahead and the codes one group
//    ahead of the group being summed; a padding candidate costs its id
//    read and no code read.  Staging the codes in shared memory instead
//    (per warp by 1-D bulk asynchronous copies, or per thread by
//    cp.async, up to five groups ahead) was slower at the bucket
//    (0.37-0.42 against 0.33 ms, launch/ann_breakdown.py): the lookups
//    already keep shared memory busy.  The design this replaces copied
//    each warp's codes through a shared buffer with the warp's own loads,
//    with no read ahead: its code reads alone, without the lookups, took
//    0.355 of its 0.380 ms.
//  * Selection: csrc/key_select.cuh, B5's filter route.  Each distance
//    forms the key (distance, position); a key below the block's
//    threshold goes to a queue behind the sorted k-list in shared memory,
//    one shared atomic a warp; once a group of FT candidates leaves
//    max(k, F_EAGER) keys queued, one bitonic sort merges list and queue
//    and the k-th key is the new threshold.  The queue is sized to k (a
//    list, a queue at the merge mark and one group's pushes), not to B5's
//    8192 keys, and nothing is ever dropped.  A list a warp, merged by the
//    warp alone under a shared threshold, was slower (0.45 ms): each
//    warp's threshold trails the block's, and the pushes grew.
//
// matrix (k > FUSED_K_MAX): adc_dist_kernel writes each query's row of L
// int32 distances (in chunks of queries, ops._matrix_topk), and B5's int32
// key mode (csrc/topk_select.cu) selects on the same (distance, position)
// key.  It stages the int32 LUT in shared memory where it fits.
//
// Both hold a code past n_codes - 1 to n_codes - 1, as the plain version
// does (valid fits never produce one).
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "key_select.cuh"

namespace {

constexpr int ADC_THREADS = 256;
constexpr int ADC_WARPS = ADC_THREADS / 32;
constexpr int WARP_BYTES = 1024;       // codes a warp stages at once
constexpr int M_MAX = 4096;            // the widest code a launch takes
constexpr int SPAN_MIN = 8192;         // candidates a block takes at least
constexpr int SMEM_MAX = 232448;       // dynamic shared memory a block may use
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------ matrix route
// A block takes one query's int32 LUT (in shared memory where it fits,
// else read from device memory) and a span of its candidates.  Each warp
// works alone on 32 candidates at a time: one coalesced read of their ids;
// where none is valid (a padding run) it writes the sentinel and reads no
// code; else it copies their 32 m code bytes to its own shared buffer and
// each lane sums the m entries of its candidate.
template <bool LUT_IN_SMEM>
__global__ void __launch_bounds__(ADC_THREADS)
adc_dist_kernel(const int* __restrict__ lut, const int8_t* __restrict__ codes,
                const int* __restrict__ ids, int* __restrict__ out, int L,
                int m, int n_codes, int dmax, int splits, int span) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int q = blockIdx.x / splits;
    const int c_lo = (blockIdx.x % splits) * span;
    const int c_hi = min(L, c_lo + span);
    const int lut_len = m * n_codes;
    const int* lut_q = lut + (size_t)q * lut_len;
    int* lut_s = reinterpret_cast<int*>(smem);
    int8_t* buf = reinterpret_cast<int8_t*>(
        smem + (LUT_IN_SMEM ? (size_t)lut_len * 4 : 0)) + warp * WARP_BYTES;
    const int* table = lut_q;
    if (LUT_IN_SMEM) {
        for (int i = threadIdx.x; i < lut_len; i += ADC_THREADS)
            lut_s[i] = lut_q[i];
        table = lut_s;
        __syncthreads();
    }
    const int8_t* codes_q = codes + (size_t)q * L * m;
    const int* ids_q = ids + (size_t)q * L;
    int* out_q = out + (size_t)q * L;

    // span is a multiple of 32, so each warp's 32 candidates start at a
    // multiple of 32 and their codes at a multiple of 4 bytes of the row
    for (int t0 = c_lo + warp * 32; t0 < c_hi; t0 += ADC_THREADS) {
        const int t = t0 + lane;
        const bool live = t < c_hi;
        const bool valid = live && ids_q[t] >= 0;
        if (!__any_sync(FULL, valid)) {   // padding: no code is read
            if (live) out_q[t] = dmax;
            continue;
        }
        const int nbytes = min(32, c_hi - t0) * m;
        const int8_t* src = codes_q + (size_t)t0 * m;
        const bool aligned = (reinterpret_cast<uintptr_t>(src) & 3) == 0;
        const int lo = lane * m;          // this lane's bytes: [lo, lo + m)
        int s = 0;
        for (int b0 = 0; b0 < nbytes; b0 += WARP_BYTES) {
            const int nb = min(WARP_BYTES, nbytes - b0);
            __syncwarp();                 // the last chunk is consumed
            int done = 0;
            if (aligned) {
                const int nw = nb / 4;
                const int* src4 = reinterpret_cast<const int*>(src + b0);
                int* buf4 = reinterpret_cast<int*>(buf);
                for (int i = lane; i < nw; i += 32) buf4[i] = src4[i];
                done = 4 * nw;
            }
            for (int i = done + lane; i < nb; i += 32) buf[i] = src[b0 + i];
            __syncwarp();
            if (valid) {
                const int j1 = min(lo + m, b0 + nb);
                for (int j = max(lo, b0); j < j1; ++j) {
                    // codes hold code - 128; a code past n_codes would
                    // read another subspace's entries, so it is held
                    const int code = min((int)buf[j - b0] + 128, n_codes - 1);
                    s += table[(j - lo) * n_codes + code];
                }
            }
        }
        if (live) out_q[t] = valid ? s : dmax;
    }
}

size_t smem_bytes(int m, int n_codes, bool lut_in_smem) {
    return (size_t)ADC_WARPS * WARP_BYTES +
           (lut_in_smem ? (size_t)m * n_codes * 4 : 0);
}

// ------------------------------------------------------------ fused route

constexpr int FT = 128;             // threads of a fused block
constexpr int F_EAGER = 128;        // merge once the queue holds max(k, this)
constexpr int FUSED_K_MAX = 256;    // the longest list of the fused route
constexpr int ROW = 256;            // table entries a subspace: a code byte each
constexpr int TABLE_MAX = 131072;   // bytes of a staged table at most
constexpr int FAST_M = 24;          // widest code held in registers

// keys of the list, its queue at the merge mark and one group's pushes,
// a power of two
__host__ __device__ inline int fused_cap(int k) {
    const int need = k + (k > F_EAGER ? k : F_EAGER) - 1 + FT;
    int p2 = 1;
    while (p2 < need) p2 <<= 1;
    return p2;
}

__host__ __device__ inline bool table_fits(int m) {
    return static_cast<long long>(m) * ROW <= TABLE_MAX;
}

// bytes of the fused route's dynamic shared memory: the list and its
// queue, the queue length (16 bytes), the byte table
__host__ __device__ inline size_t fused_smem(int k, int m) {
    return static_cast<size_t>(fused_cap(k)) * 8 + 16 +
           (table_fits(m) ? static_cast<size_t>(m) * ROW : 0);
}

// byte b of w, zero-extended
__device__ __forceinline__ unsigned byte_of(uint32_t w, int b) {
    return __byte_perm(w, 0u, 0x4440u | static_cast<unsigned>(b));
}

// the aligned 16-byte blocks holding candidate t's m code bytes (m <=
// FAST_M: at most three), read once; none for a padding candidate
__device__ __forceinline__ void fetch(const int8_t* codes_q, int t, int m,
                                      int id, uint32_t (&r)[12]) {
#pragma unroll
    for (int i = 0; i < 12; ++i) r[i] = 0u;
    if (id < 0) return;
    const uintptr_t at = reinterpret_cast<uintptr_t>(codes_q) +
                         static_cast<uintptr_t>(t) * m;
    const uint4* p = reinterpret_cast<const uint4*>(at & ~uintptr_t{15});
    const int o = static_cast<int>(at & 15);
#pragma unroll
    for (int blk = 0; blk < 3; ++blk) {
        if (blk == 0 || o + m > 16 * blk) {
            const uint4 v = __ldcs(p + blk);
            r[4 * blk] = v.x;
            r[4 * blk + 1] = v.y;
            r[4 * blk + 2] = v.z;
            r[4 * blk + 3] = v.w;
        }
    }
}

// the ADC sum of a candidate whose code bytes start o bytes into r: the
// first seven words realigned (two selects by o's word, a funnel shift by
// its byte), then one lookup a subspace
template <bool TABLE>
__device__ __forceinline__ int sum_fast(const uint32_t (&r)[12], int o,
                                        int m, const uint8_t* tb,
                                        const int* __restrict__ lut_q,
                                        int n_codes) {
    const int wi = o >> 2, sh = 8 * (o & 3);
    uint32_t s2[10], s1[7];
#pragma unroll
    for (int i = 0; i < 10; ++i) s2[i] = (wi & 2) ? r[i + 2] : r[i];
#pragma unroll
    for (int i = 0; i < 7; ++i) s1[i] = (wi & 1) ? s2[i + 1] : s2[i];
    int s = 0;
#pragma unroll
    for (int i = 0; i < FAST_M / 4; ++i) {
        if (4 * i >= m) break;
        const uint32_t w = __funnelshift_r(s1[i], s1[i + 1], sh);
        const uint8_t* tq = tb + 4 * i * ROW;
        auto look = [&](int b) {   // subspace 4 i + b
            if (TABLE)
                s += tq[b * ROW + byte_of(w, b)];
            else
                s += __ldg(lut_q + (4 * i + b) * n_codes +
                           min(byte_of(w, b) ^ 0x80u,
                               static_cast<unsigned>(n_codes - 1)));
        };
        const int n = m - 4 * i;   // the word's subspaces, if fewer than 4
        look(0);
        if (n >= 4) {
            look(1);
            look(2);
            look(3);
        } else {
            if (n > 1) look(1);
            if (n > 2) look(2);
        }
    }
    return s;
}

// the same for any m, read byte by byte from device memory
template <bool TABLE>
__device__ __forceinline__ int sum_any(const int8_t* src, int m,
                                       const uint8_t* tb,
                                       const int* __restrict__ lut_q,
                                       int n_codes) {
    int s = 0;
    for (int j = 0; j < m; ++j) {
        const unsigned u = static_cast<unsigned char>(src[j]);
        if (TABLE)
            s += tb[j * ROW + u];
        else
            s += __ldg(lut_q + j * n_codes +
                       min(u ^ 0x80u, static_cast<unsigned>(n_codes - 1)));
    }
    return s;
}

// The candidates [c_lo, c_hi) of one query through the block's list:
// thread tid takes candidate c_lo + g FT + tid of group g.  With FAST each
// thread reads its id two groups ahead and its code bytes one group ahead
// of the group it sums, into registers; a padding candidate costs its id
// and no code read.
template <bool FAST, bool TABLE>
__device__ __forceinline__ void scan(unsigned long long* keys, unsigned* cnt,
                                     int k, const int8_t* codes_q,
                                     const int* __restrict__ ids_q,
                                     const uint8_t* tb,
                                     const int* __restrict__ lut_q, int m,
                                     int n_codes, int c_lo, int c_hi) {
    const int tid = threadIdx.x;
    const int dmax = 255 * m + 1;
    const unsigned eager = static_cast<unsigned>(k > F_EAGER ? k : F_EAGER);
    const int n_groups = (c_hi - c_lo + FT - 1) / FT;
    unsigned long long tau = ksel::NONE;
    auto id_of = [&](int g) {
        const int t = c_lo + g * FT + tid;
        return t < c_hi ? __ldcs(ids_q + t) : -1;
    };
    // the key of candidate t (distance dist) to the queue if it ranks
    // before the threshold; a merge once the queue passes the mark
    auto push = [&](int dist, int t) {
        const unsigned long long key = ksel::sort_key(dist, t);
        const bool pass = t < c_hi && key < tau;
        unsigned len = 0;
        if (__any_sync(ksel::FULL, pass)) {
            const uint2 slot = ksel::reserve(cnt, pass ? 1u : 0u);
            if (pass) keys[k + slot.x] = key;
            len = slot.y;
        }
        if (__syncthreads_or(len >= eager))
            tau = ksel::merge_list(keys, k, cnt);
    };
    if (FAST) {
        int id0 = id_of(0), id1 = id_of(1);
        uint32_t r0[12], r1[12];
        fetch(codes_q, c_lo + tid, m, id0, r0);
        for (int g = 0; g < n_groups; ++g) {
            const int t = c_lo + g * FT + tid;
            const int id2 = id_of(g + 2);
            fetch(codes_q, t + FT, m, id1, r1);
            int dist = dmax;
            if (id0 >= 0) {
                const int o = static_cast<int>(
                    (reinterpret_cast<uintptr_t>(codes_q) +
                     static_cast<uintptr_t>(t) * m) & 15);
                dist = sum_fast<TABLE>(r0, o, m, tb, lut_q, n_codes);
            }
            push(dist, t);
            id0 = id1;
            id1 = id2;
#pragma unroll
            for (int i = 0; i < 12; ++i) r0[i] = r1[i];
        }
    } else {
        for (int g = 0; g < n_groups; ++g) {
            const int t = c_lo + g * FT + tid;
            const int id = id_of(g);
            push(id >= 0 ? sum_any<TABLE>(codes_q + static_cast<size_t>(t) * m,
                                          m, tb, lut_q, n_codes)
                         : dmax, t);
        }
    }
    __syncthreads();
    if (*cnt > 0) ksel::merge_list(keys, k, cnt);
}

// Block b: split b % n_splits of query b / n_splits (a query's splits are
// adjacent blocks).  One split: the query's k smallest into vals/idx; more:
// the split's list of k keys into part[b * k ..].
template <bool FAST>
__global__ void __launch_bounds__(FT, 8)
adc_topk_kernel(const int* __restrict__ lut, const int8_t* __restrict__ codes,
                const int* __restrict__ ids, int* __restrict__ vals,
                int* __restrict__ idx, unsigned long long* __restrict__ part,
                int L, int m, int n_codes, int k, int n_splits, int span) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int cap = fused_cap(k);
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
    unsigned* cnt = reinterpret_cast<unsigned*>(smem + cap * 8);
    uint8_t* tb = smem + cap * 8 + 16;
    const int tid = threadIdx.x;
    const int q = blockIdx.x / n_splits, split = blockIdx.x - q * n_splits;
    const int c_lo = split * span, c_hi = min(L, c_lo + span);
    const int* lut_q = lut + static_cast<size_t>(q) * m * n_codes;
    const int8_t* codes_q = codes + static_cast<size_t>(q) * L * m;
    const int* ids_q = ids + static_cast<size_t>(q) * L;

    // the byte table, entry (j, u) = LUT[j][min(u ^ 0x80, n_codes - 1)]
    bool bad = !table_fits(m);
    if (!bad) {
        for (int e = tid; e < m * ROW; e += FT) {
            const int u = e & (ROW - 1);
            const int code = min(u ^ 0x80, n_codes - 1);
            const int v = lut_q[(e >> 8) * n_codes + code];
            bad |= static_cast<unsigned>(v) > 255u;
            tb[e] = static_cast<uint8_t>(v);
        }
    }
    for (int i = tid; i < k; i += FT) keys[i] = ksel::NONE;
    if (tid == 0) *cnt = 0;
    if (!__syncthreads_or(bad))
        scan<FAST, true>(keys, cnt, k, codes_q, ids_q, tb, lut_q, m, n_codes,
                         c_lo, c_hi);
    else
        scan<FAST, false>(keys, cnt, k, codes_q, ids_q, tb, lut_q, m,
                          n_codes, c_lo, c_hi);
    if (n_splits == 1) {
        for (int j = tid; j < k; j += FT) {
            vals[static_cast<size_t>(q) * k + j] = ksel::key_value(keys[j]);
            idx[static_cast<size_t>(q) * k + j] = ksel::key_index(keys[j]);
        }
    } else {
        for (int j = tid; j < k; j += FT)
            part[static_cast<size_t>(blockIdx.x) * k + j] = keys[j];
    }
}

}  // namespace

extern "C" {

int adc_fused_k_max() { return FUSED_K_MAX; }
int adc_merge_keys() { return ksel::MERGE_KEYS; }

// 1 when the fused route stages a LUT of m subspaces in shared memory as
// its byte table (for LUT entries in 0..255), 0 when it reads the LUT from
// device memory.
int adc_lut_in_smem(int m, int n_codes) {
    return n_codes >= 1 && table_fits(m);
}

// The fused route: lut (Q, m * n_codes) int32, codes (Q, L, m) int8 (code
// - 128), ids (Q, L) int32 -> vals, idx (Q, k) int32: the k smallest ADC
// distances (adc_dmax(m) where ids < 0) and their positions, ascending,
// ties to the smallest position.  1 <= k <= min(L, FUSED_K_MAX).  Each
// query's L candidates go in n_splits spans of ``span`` (a multiple of 32;
// none empty); with more than one, ``part`` holds Q * n_splits * k keys
// of scratch (n_splits * k <= MERGE_KEYS).  Returns the first CUDA error.
int adc_topk_i32(const int* lut, const int8_t* codes, const int* ids,
                 int* vals, int* idx, unsigned long long* part, int Q, int L,
                 int m, int n_codes, int k, int n_splits, int span,
                 void* stream) {
    if (Q < 1 || L < 1 || m < 1 || n_codes < 1 || m > M_MAX ||
        (long long)m * n_codes > INT_MAX / 4 || k < 1 || k > L ||
        k > FUSED_K_MAX || n_splits < 1 || span < 1 || span % 32 ||
        (long long)(n_splits - 1) * span >= L ||
        (long long)n_splits * span < L ||
        (n_splits > 1 && (part == nullptr ||
                          n_splits * k > ksel::MERGE_KEYS)) ||
        (long long)Q * n_splits > INT_MAX)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t bytes = fused_smem(k, m);
    auto kernel = m <= FAST_M ? adc_topk_kernel<true>
                              : adc_topk_kernel<false>;
    if (bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<Q * n_splits, FT, bytes, s>>>(lut, codes, ids, vals, idx, part,
                                           L, m, n_codes, k, n_splits, span);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_splits == 1) return (int)err;
    ksel::split_merge_kernel<int, true>
        <<<Q, ksel::MERGE_THREADS, 0, s>>>(nullptr, 0, k, n_splits, part,
                                            vals, idx);
    return (int)cudaGetLastError();
}

// The matrix route: lut (Q, m * n_codes) int32, codes (Q, L, m) int8
// (code - 128), ids (Q, L) int32 -> out (Q, L) int32 ADC distances,
// adc_dmax(m) where ids < 0; B5's int32 mode selects on them.
int adc_dist_i32(const int* lut, const int8_t* codes, const int* ids,
                 int* out, int Q, int L, int m, int n_codes, void* stream) {
    if (Q < 1 || L < 1 || m < 1 || n_codes < 1 || m > M_MAX ||
        (long long)m * n_codes > INT_MAX / 4)
        return (int)cudaErrorInvalidValue;
    // each query's candidates in spans of at least SPAN_MIN, a multiple
    // of 32: the LUT is staged once a span, and the blocks make waves
    const int splits = max(1, L / SPAN_MIN);
    const int span = ((L + splits - 1) / splits + 31) / 32 * 32;
    if ((long long)Q * splits > INT_MAX) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int dmax = 255 * m + 1;
    const bool staged = smem_bytes(m, n_codes, true) <= (size_t)SMEM_MAX;
    const size_t bytes = smem_bytes(m, n_codes, staged);
    auto kernel = staged ? adc_dist_kernel<true> : adc_dist_kernel<false>;
    if (bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<Q * splits, ADC_THREADS, bytes, s>>>(
        lut, codes, ids, out, L, m, n_codes, dmax, splits, span);
    return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
