// Exact int8 lattice distance -> nearest rows / nearest centroid, for
// Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   B6  kernels/quantized.py::_quant_topk_kernel   (distance_topk_q8, the
//       int8 arm of kNN OP1+OP2)
//   B7  kernels/quantized.py::_quant_argmin_kernel (distance_argmin_q8, the
//       int8 arm of K-Means OP1+OP2)
//
// Both compute the lattice distance ||a||^2 - 2 a.c + ||c||^2 of int8 rows
// in exact int32 arithmetic.  For d <= 832 every sum stays far inside
// int32 (4 * 832 * 127^2 < 2^26), so both kernels are bit-equal to the
// plain versions, whatever order they sum in.  The TPU kernels fed the
// int8 operands to the f32 matrix unit, offset the distance by OFF, left a
// norm to be restored outside and packed (distance, lane) into one int32
// key; none of that is needed here.  Ranking by (distance, row) gives the
// same order and the same ties.  d <= 832 stays the wrappers' contract,
// as in the reference.
//
// What bounds B6 on an H100.  At the kNN serving shape (N = 2^20 rows,
// Q = 1024 queries, d = 21) it does 2*N*Q*d = 45 G integer operations
// against 22 MB of A: 0.023 ms at the int8 tensor-core peak.  That bound
// is out of reach: each of the N*Q = 2^30 (row, query) pairs also needs its
// distance formed and compared with the query's threshold, a few CUDA-core
// instructions a pair (~0.1 ms at the card's instruction rate), so the
// selection, not the products, sets the pace: the epilogue, the queue
// traffic while thresholds are loose, and the latency of each tile's
// barriers at two blocks an SM.
//
// B6's design, k <= TOPK_K_MAX (B1's, csrc/distance_topk.cu, with these
// differences):
//  * The products run on the int8 tensor cores: mma.sync m16n8k32 s8 x s8
//    -> s32.  A block scores QB = 128 queries against 128-row tiles; each
//    warp takes 32 rows x 64 queries (2 x 8 fragments).  Rows and queries
//    sit in shared memory as 4-byte words, zero-padded to a multiple of 32
//    features (d = 21 is one k-step), in rows of 32 * k-steps + 16 bytes so
//    that the eight rows a fragment load touches fall in distinct banks.
//  * Staging (the bulk route): a 128-row tile is one span of 128*d bytes.
//    One thread copies it into a ring of three stages with a 1-D bulk
//    asynchronous copy (hop::bulk_load_1d); the block then repacks it into
//    the padded word layout with aligned 4-byte shared loads and a funnel
//    shift (load_word, no byte loads) and forms the row norms with __dp4a,
//    two threads a row.
//  * Epilogue: x = ||a||^2 - 2 a.c is compared with the query's threshold
//    less ||c||^2, kept in registers (one multiply-add and one compare a
//    pair, the 16 compares of a push group or-ed under one branch); a pair
//    that passes is queued through csrc/block_select.cuh.  A query takes
//    at most 32 candidates in one push group (one of a thread's four
//    rows, 32 threads a query), and the block merges early when a queue
//    passes bsel::FILL, so no candidate is dropped.
//  * The alignment rule (routes, counted by the wrapper): the bulk route
//    needs A's base 16-byte aligned and d <= Q8_BULK_MAX_D (four k-steps);
//    rows_per_split is a multiple of 32, so every tile starts 16-byte
//    aligned.  The last tile's span may end off a 16-byte multiple: the
//    bulk copy takes its 16-byte part and the copying thread loads the
//    last (rows*d) % 16 bytes itself before it arrives on the barrier.
//    Any other A (a view such as A[1:], or d > Q8_BULK_MAX_D) takes the
//    plain route: the block repacks each tile straight from device memory
//    with the same aligned word loads, four k-steps at a time between
//    barriers.  A word load reads only aligned words that hold a byte of
//    the row.
//  * B6, larger k: the reference takes every 1 <= k <= N.  For k past the
//    lists the wrapper has this file write the int32 (Q, N) lattice matrix,
//    one query per row so B5 reads rows contiguously, in chunks of queries
//    that bound its bytes; B5 (csrc/topk_select.cu) then selects in its
//    int32 key mode.  The matrix tile puts rows on the lanes, so the
//    stores of a warp are contiguous.  Rows are staged there as words
//    built from bytes (row_word), zero-padded past d.
//  * B7: one row per thread; centroids are staged in shared memory in tiles
//    of 32 (so any K fits) and read as broadcasts into 32 running dot
//    products in registers, by __dp4a.  The scan compares (distance,
//    column) with strict < in ascending column order: the first index wins
//    ties, so the reference's packed/unpacked fork is not needed.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "block_select.cuh"
#include "hopper.cuh"

namespace {

using bsel::QB;
using bsel::RB;
using bsel::THREADS;

constexpr int TOPK_K_MAX = bsel::K_MAX;
constexpr int Q8_BULK_MAX_D = 128;  // widest row the bulk route stages
constexpr int STAGES = 3;           // bulk route: tiles in flight
constexpr int KSC = 4;              // k-steps (32 features) of a chunk
constexpr int RL = 8;               // matrix mode: warps of a block
constexpr int WC = 16;              // matrix mode, B7: words of a chunk
constexpr int MAX_D = 832;

// features [f, f + 4) of an int8 row of d as one word, zero past d
__device__ __forceinline__ int row_word(const int8_t* __restrict__ row,
                                        int f, int d) {
    unsigned int w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        const unsigned int byte =
            f + b < d ? (unsigned int)(unsigned char)row[f + b] : 0u;
        w |= byte << (8 * b);
    }
    return (int)w;
}

// The same word from aligned 4-byte loads and a funnel shift: reads the
// aligned word holding byte f and, only if the four bytes cross it, the
// next one.  ``row`` may point to shared or device memory.
__device__ __forceinline__ uint32_t load_word(const int8_t* row, int f,
                                              int d) {
    const int n = min(4, d - f);
    if (n <= 0) return 0u;
    const uintptr_t at = reinterpret_cast<uintptr_t>(row + f);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(at & ~uintptr_t{3});
    const int sh = static_cast<int>(at & 3);
    const uint32_t lo = w[0];
    const uint32_t hi = sh + n > 4 ? w[1] : 0u;
    const uint32_t v = __funnelshift_r(lo, hi, 8 * sh);
    return n == 4 ? v : v & ((1u << (8 * n)) - 1u);
}

struct Q8Layout {
    size_t stage_bytes, a_w, c_w, cn, an, lists, bars, total;
    int st;   // words of a padded row
};

// byte offsets of B6's dynamic shared memory (host and device agree)
__host__ __device__ inline Q8Layout q8_layout(bool bulk, int d, int k) {
    Q8Layout L{};
    const int ks = (d + 31) / 32;
    L.st = 8 * (ks < KSC ? ks : KSC) + 4;
    // +16: the funnel shift may read the word after a tile's last byte
    L.stage_bytes = bulk ? (static_cast<size_t>(RB) * d + 16 + 127)
                           & ~size_t{127} : 0;
    size_t off = L.stage_bytes * STAGES;
    L.a_w = off;
    off += static_cast<size_t>(RB) * L.st * 4;
    L.c_w = off;
    off += static_cast<size_t>(QB) * L.st * 4;
    L.cn = off;
    off += QB * 4;
    L.an = off;
    off += RB * 4;
    L.lists = off;
    off += bsel::lists_bytes(k);
    L.bars = off;
    L.total = off + 8 * STAGES;
    return L;
}

// words [w0, w0 + W) of the rows at src (row r at src + r*d bytes) into
// rows of st words of dst, zeros for rows >= rows: two threads a row, each
// half of the words.  Returns the thread's part of the squared norms.
__device__ __forceinline__ int repack(uint32_t* dst, int st, const int8_t* src,
                                      int rows, int d, int w0, int W) {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int8_t* row = src + static_cast<size_t>(r) * d;
    int s = 0;
    for (int w = half * (W / 2); w < (half + 1) * (W / 2); ++w) {
        const uint32_t v = r < rows ? load_word(row, 4 * (w0 + w), d) : 0u;
        dst[r * st + w] = v;
        s = __dp4a(static_cast<int>(v), static_cast<int>(v), s);
    }
    return s;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mi][ni] += rows x queries over nks k-steps: the warp's rows
// 32 wr + 16 mi + (gid, gid + 8), queries 64 wq + 8 ni + gid (B operand)
__device__ __forceinline__ void cross(const uint32_t* a_w,
                                      const uint32_t* c_w, int st, int nks,
                                      int wr, int wq, int gid, int tig,
                                      int (&acc)[2][8][4]) {
    for (int s = 0; s < nks; ++s) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
            const uint32_t* p = a_w + (32 * wr + 16 * mi + gid) * st + 8 * s
                                + tig;
            a[mi][0] = p[0];
            a[mi][1] = p[8 * st];
            a[mi][2] = p[4];
            a[mi][3] = p[8 * st + 4];
        }
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
            const uint32_t* p = c_w + (64 * wq + 8 * ni + gid) * st + 8 * s
                                + tig;
            const uint32_t b0 = p[0], b1 = p[4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
        }
    }
}

template <bool BULK>
__global__ void __launch_bounds__(THREADS, 2)
q8_topk_partial_kernel(const int8_t* __restrict__ A,
                       const int8_t* __restrict__ C, int* __restrict__ part_v,
                       int* __restrict__ part_i, int N, int Q, int d, int k,
                       int rows_per_split) {
    extern __shared__ __align__(128) unsigned char smem[];
    const Q8Layout lay = q8_layout(BULK, d, k);
    int8_t* stage = reinterpret_cast<int8_t*>(smem);
    uint32_t* a_w = reinterpret_cast<uint32_t*>(smem + lay.a_w);
    uint32_t* c_w = reinterpret_cast<uint32_t*>(smem + lay.c_w);
    int* cn_s = reinterpret_cast<int*>(smem + lay.cn);
    int* an_s = reinterpret_cast<int*>(smem + lay.an);
    const bsel::Lists<int> L = bsel::carve<int>(smem + lay.lists, k);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
    const int st = lay.st;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int wr = warp & 3, wq = warp >> 2;
    const int split = blockIdx.x, q0 = blockIdx.y * QB;
    const int row_lo = split * rows_per_split;
    const int row_hi = min(N, row_lo + rows_per_split);
    const int n_tiles = (row_hi - row_lo + RB - 1) / RB;
    const int ks = (d + 31) / 32;
    const int nch = (ks + KSC - 1) / KSC;
    const int q_rows = min(QB, Q - q0);
    const int8_t* Cb = C + static_cast<size_t>(q0) * d;

    bsel::init(L);
    {   // query norms over every word, two threads a query
        const int q = tid >> 1;
        int s = 0;
        if (q < q_rows) {
            const int8_t* c = Cb + static_cast<size_t>(q) * d;
            for (int w = tid & 1; w < (d + 3) / 4; w += 2) {
                const int v = static_cast<int>(load_word(c, 4 * w, d));
                s = __dp4a(v, v, s);
            }
        }
        s += __shfl_xor_sync(bsel::FULL, s, 1);
        if ((tid & 1) == 0) cn_s[q] = s;
    }
    if (nch == 1) repack(c_w, st, Cb, q_rows, d, 0, 8 * ks);
    if (BULK && tid == 0) {
        for (int s = 0; s < STAGES; ++s) hop::mbar_init(&full[s], 1);
        hop::fence_barrier_init();
    }
    __syncthreads();

    auto issue = [&](int t) {   // tile t into stage t % STAGES
        const int row0 = row_lo + t * RB;
        const int n = min(RB, row_hi - row0) * d;
        int8_t* dst = stage + (t % STAGES) * lay.stage_bytes;
        const int8_t* src = A + static_cast<size_t>(row0) * d;
        const int bulk = n & ~15;
        for (int b = bulk; b < n; ++b) dst[b] = src[b];
        hop::mbar_expect_tx(&full[t % STAGES], static_cast<uint32_t>(bulk));
        if (bulk)
            hop::bulk_load_1d(dst, src, static_cast<uint32_t>(bulk),
                              &full[t % STAGES]);
    };
    if (BULK && tid == 0)
        for (int t = 0; t < STAGES && t < n_tiles; ++t) issue(t);

    // the thread's 16 queries 64 wq + 8 ni + 2 tig + e: threshold less the
    // query norm, INT_MIN past Q (no pair passes)
    int tcn[16];
    auto load_thresholds = [&]() {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int ql = 64 * wq + 8 * (j >> 1) + 2 * tig + (j & 1);
            tcn[j] = ql < q_rows ? L.threshold(ql) - cn_s[ql] : INT_MIN;
        }
    };
    load_thresholds();
    bool flag = false;   // a queue this thread pushed to passed FILL
    auto sync_merge = [&]() {
        if (__syncthreads_or(flag)) {
            bsel::merge(L);
            __syncthreads();
            load_thresholds();
        }
        flag = false;
    };

    for (int t = 0; t < n_tiles; ++t) {
        const int row0 = row_lo + t * RB;
        const int rows = min(RB, row_hi - row0);
        if (t > 0) {
            sync_merge();   // also: every thread is done with tile t - 1
            if (BULK && tid == 0 && t - 1 + STAGES < n_tiles)
                issue(t - 1 + STAGES);
        }
        int acc[2][8][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 8; ++ni)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0;
        int s = 0;
        if (BULK) {
            hop::mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
            s = repack(a_w, st, stage + (t % STAGES) * lay.stage_bytes, rows,
                       d, 0, 8 * ks);
            s += __shfl_xor_sync(bsel::FULL, s, 1);
            if ((tid & 1) == 0) an_s[tid >> 1] = s;
            __syncthreads();
            cross(a_w, c_w, st, ks, wr, wq, gid, tig, acc);
        } else {
            const int8_t* Ab = A + static_cast<size_t>(row0) * d;
            for (int ch = 0; ch < nch; ++ch) {
                const int nks = min(KSC, ks - ch * KSC);
                if (ch > 0) __syncthreads();
                s += repack(a_w, st, Ab, rows, d, 8 * KSC * ch, 8 * nks);
                if (nch > 1)
                    repack(c_w, st, Cb, q_rows, d, 8 * KSC * ch, 8 * nks);
                __syncthreads();
                cross(a_w, c_w, st, nks, wr, wq, gid, tig, acc);
            }
            s += __shfl_xor_sync(bsel::FULL, s, 1);
            if ((tid & 1) == 0) an_s[tid >> 1] = s;
            __syncthreads();
        }
        // four push groups, one of the thread's rows each: at most 32
        // candidates a query.  One branch a group: the 16 compares are
        // or-ed first.
#pragma unroll
        for (int g = 0; g < 4; ++g) {
            if (g > 0) sync_merge();
            const int mi = g >> 1, h = g & 1;
            const int rl = 32 * wr + 16 * mi + 8 * h + gid;
            const int an = an_s[rl];
            int x[16];
            bool any = false;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                x[j] = an - 2 * acc[mi][j >> 1][2 * h + (j & 1)];
                any |= x[j] <= tcn[j];
            }
            if (any && rl < rows) {
#pragma unroll
                for (int j = 0; j < 16; ++j) {
                    const int ql = 64 * wq + 8 * (j >> 1) + 2 * tig + (j & 1);
                    if (x[j] <= tcn[j])
                        flag |= bsel::queue(L, ql, x[j] + cn_s[ql], row0 + rl);
                }
            }
        }
    }
    __syncthreads();
    bsel::merge(L);
    __syncthreads();
    bsel::write_lists(L, part_v, part_i, q0, Q, split, gridDim.x);
}

template <bool BULK>
cudaError_t launch_partial(const int8_t* A, const int8_t* C, int* part_v,
                           int* part_i, int N, int Q, int d, int k,
                           int n_splits, int rows_per_split, cudaStream_t s) {
    const size_t bytes = q8_layout(BULK, d, k).total;
    static size_t allowed = 48 * 1024;   // the dynamic size allowed so far
    if (bytes > allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            q8_topk_partial_kernel<BULK>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes));
        if (err != cudaSuccess) return err;
        allowed = bytes;
    }
    const dim3 grid(n_splits, (Q + QB - 1) / QB);
    q8_topk_partial_kernel<BULK><<<grid, THREADS, bytes, s>>>(
        A, C, part_v, part_i, N, Q, d, k, rows_per_split);
    return cudaGetLastError();
}

// The (Q, N) lattice matrix, one query per row: a block covers MR rows
// (rows on the lanes, MR / 32 a thread) and MQ queries (MQ / 8 a warp).
constexpr int MR = 128;
constexpr int MQ = 64;
constexpr int M_RPT = MR / 32;
constexpr int M_QPT = MQ / RL;

__global__ void __launch_bounds__(32 * RL)
q8_dist_matrix_kernel(const int8_t* __restrict__ A,
                      const int8_t* __restrict__ C, int* __restrict__ out,
                      int N, int Q, int d) {
    __shared__ int a_s[MR][WC + 1];
    __shared__ int c_s[MQ][WC + 1];

    const int lane = threadIdx.x;
    const int wp = threadIdx.y;
    const int tid = wp * 32 + lane;
    const int row0 = blockIdx.x * MR;
    const int q0 = blockIdx.y * MQ;
    const int dw = (d + 3) / 4;

    int acc[M_RPT][M_QPT];
    int an[M_RPT], cn[M_QPT];
#pragma unroll
    for (int r = 0; r < M_RPT; ++r) {
        an[r] = 0;
#pragma unroll
        for (int j = 0; j < M_QPT; ++j) acc[r][j] = 0;
    }
#pragma unroll
    for (int j = 0; j < M_QPT; ++j) cn[j] = 0;

    for (int w0 = 0; w0 < dw; w0 += WC) {
        const int wc = min(WC, dw - w0);
        __syncthreads();
        for (int e = tid; e < MR * WC; e += 32 * RL) {
            const int r = e / WC, w = e % WC;
            const int row = row0 + r;
            a_s[r][w] = (row < N && w < wc)
                ? row_word(A + (size_t)row * d, 4 * (w0 + w), d) : 0;
        }
        for (int e = tid; e < MQ * WC; e += 32 * RL) {
            const int qq = e / WC, w = e % WC;
            const int qg = q0 + qq;
            c_s[qq][w] = (qg < Q && w < wc)
                ? row_word(C + (size_t)qg * d, 4 * (w0 + w), d) : 0;
        }
        __syncthreads();
        for (int w = 0; w < wc; ++w) {
            int aw[M_RPT], cw[M_QPT];
#pragma unroll
            for (int r = 0; r < M_RPT; ++r) {
                aw[r] = a_s[lane + 32 * r][w];
                an[r] = __dp4a(aw[r], aw[r], an[r]);
            }
#pragma unroll
            for (int j = 0; j < M_QPT; ++j) {
                cw[j] = c_s[wp * M_QPT + j][w];
                cn[j] = __dp4a(cw[j], cw[j], cn[j]);
            }
#pragma unroll
            for (int r = 0; r < M_RPT; ++r)
#pragma unroll
                for (int j = 0; j < M_QPT; ++j)
                    acc[r][j] = __dp4a(aw[r], cw[j], acc[r][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < M_QPT; ++j) {
        const int qg = q0 + wp * M_QPT + j;
        if (qg >= Q) continue;
#pragma unroll
        for (int r = 0; r < M_RPT; ++r) {
            const int row = row0 + lane + 32 * r;
            if (row < N)
                out[(size_t)qg * N + row] = an[r] - 2 * acc[r][j] + cn[j];
        }
    }
}

constexpr int AM_ROWS = 128;  // rows per block, one per thread
constexpr int KT = 32;        // centroids per shared-memory tile

__global__ void __launch_bounds__(AM_ROWS)
q8_argmin_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ C,
                 int* __restrict__ out_v, int* __restrict__ out_i, int N,
                 int K, int d) {
    __shared__ int a_s[AM_ROWS][WC + 1];
    __shared__ int c_s[WC][KT];
    __shared__ int cn_s[KT];

    const int t = threadIdx.x;
    const int row0 = blockIdx.x * AM_ROWS;
    const int row = row0 + t;
    const int dw = (d + 3) / 4;
    const int nchunks = (dw + WC - 1) / WC;
    int an = 0;
    int best = INT_MAX, best_i = 0;

    for (int k0 = 0; k0 < K; k0 += KT) {
        const int kt = min(KT, K - k0);
        int acc[KT];
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) acc[kk] = 0;
        int cn_part = 0;
        for (int ch = 0; ch < nchunks; ++ch) {
            const int w0 = ch * WC;
            const int wc = min(WC, dw - w0);
            __syncthreads();
            if (nchunks > 1 || k0 == 0) {  // rows: once if d <= 4 * WC
                for (int e = t; e < AM_ROWS * WC; e += AM_ROWS) {
                    const int r = e / WC, w = e % WC;
                    a_s[r][w] = (row0 + r < N && w < wc)
                        ? row_word(A + (size_t)(row0 + r) * d, 4 * (w0 + w), d)
                        : 0;
                }
            }
            for (int e = t; e < KT * WC; e += AM_ROWS) {
                const int kk = e % KT, w = e / KT;
                c_s[w][kk] = (kk < kt && w < wc)
                    ? row_word(C + (size_t)(k0 + kk) * d, 4 * (w0 + w), d) : 0;
            }
            __syncthreads();
            if (k0 == 0) {
                for (int w = 0; w < wc; ++w)
                    an = __dp4a(a_s[t][w], a_s[t][w], an);
            }
            if (t < KT) {
                for (int w = 0; w < wc; ++w)
                    cn_part = __dp4a(c_s[w][t], c_s[w][t], cn_part);
            }
            for (int w = 0; w < wc; ++w) {
                const int aw = a_s[t][w];
#pragma unroll
                for (int kk = 0; kk < KT; ++kk)
                    acc[kk] = __dp4a(aw, c_s[w][kk], acc[kk]);
            }
        }
        if (t < KT) cn_s[t] = cn_part;
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
            const int dist = an - 2 * acc[kk] + cn_s[kk];
            if (kk < kt && dist < best) {
                best = dist;
                best_i = k0 + kk;
            }
        }
    }
    if (row < N) {
        out_v[row] = best;
        out_i[row] = best_i;
    }
}

}  // namespace

extern "C" {

int q8_topk_k_max() { return TOPK_K_MAX; }
int q8_query_tile() { return QB; }
int q8_tile_rows() { return RB; }
int q8_bulk_max_d() { return Q8_BULK_MAX_D; }
int q8_max_d() { return MAX_D; }

// A (N, d), C (Q, d) int8 row-major; part_v/part_i scratch of
// Q * n_splits * k; vals/idx (Q, k) int32.  bulk: 1 for the bulk route (A
// 16-byte aligned, d <= Q8_BULK_MAX_D), 0 for the plain route.  The splits
// must cover N with none empty, in multiples of 32 rows.  Returns the
// first CUDA error.
int distance_topk_q8(const int8_t* A, const int8_t* C, int* part_v,
                     int* part_i, int* vals, int* idx, int N, int Q, int d,
                     int k, int n_splits, int rows_per_split, int bulk,
                     void* stream) {
    if (k < 1 || k > TOPK_K_MAX || k > N || Q < 1 || N < 1 || d < 1 ||
        d > MAX_D || n_splits < 1 || rows_per_split < 1 ||
        rows_per_split % 32 ||
        static_cast<long long>(n_splits - 1) * rows_per_split >= N ||
        static_cast<long long>(n_splits) * rows_per_split < N ||
        (bulk && (d > Q8_BULK_MAX_D ||
                  reinterpret_cast<uintptr_t>(A) % 16 != 0)))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = bulk
        ? launch_partial<true>(A, C, part_v, part_i, N, Q, d, k, n_splits,
                               rows_per_split, s)
        : launch_partial<false>(A, C, part_v, part_i, N, Q, d, k, n_splits,
                                rows_per_split, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int per_block = bsel::MERGE_THREADS / 32;
    bsel::merge_splits_kernel<int>
        <<<(Q + per_block - 1) / per_block, bsel::MERGE_THREADS, 0, s>>>(
            part_v, part_i, vals, idx, Q, n_splits * k, k);
    return static_cast<int>(cudaGetLastError());
}

// A (N, d), C (Q, d) int8 row-major -> out (Q, N) int32 row-major.
int dist_matrix_q8(const int8_t* A, const int8_t* C, int* out, int N, int Q,
                   int d, void* stream) {
    if (N < 1 || Q < 1 || d < 1 || d > MAX_D)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid((N + MR - 1) / MR, (Q + MQ - 1) / MQ);
    q8_dist_matrix_kernel<<<grid, dim3(32, RL), 0, s>>>(A, C, out, N, Q, d);
    return (int)cudaGetLastError();
}

// A (N, d), C (K, d) int8 row-major -> out_v (N,), out_i (N,) int32.
int distance_argmin_q8(const int8_t* A, const int8_t* C, int* out_v,
                       int* out_i, int N, int K, int d, void* stream) {
    if (N < 1 || K < 1 || d < 1 || d > MAX_D)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    q8_argmin_kernel<<<(N + AM_ROWS - 1) / AM_ROWS, AM_ROWS, 0, s>>>(
        A, C, out_v, out_i, N, K, d);
    return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
