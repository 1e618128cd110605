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
//  * B7 (what bounds it).  At the K-Means int8 fit shape (N = 262,144
//    rows, K = 256, d = 21) it forms 67 M distances: 0.0023 ms of bytes,
//    and on the int8 tensor cores the dot products are ~1 us, so each
//    distance's CUDA-core work (form it, compare it) sets the pace.  A
//    serving bucket (N = 1024) is 262,144 distances: there the launch, the
//    staging and how many SMs take part do.
//  * B7's design.  Centroids are staged in shared memory once a block as
//    B6 stages its queries (zero-padded words, rows of 8 ks + 4 words, so
//    fragment loads are conflict-free), with their int32 norms; past
//    AM_RESIDENT_MAX bytes they stream in chunks of kc centroids (route
//    "stream"; "resident" otherwise).  A warp owns a 16-row tile: its A
//    fragments are built from device memory by aligned word loads
//    (load_word), and the dot products run on mma.sync m16n8k32 s8, four
//    8-centroid tiles (a 32-centroid group) at a time.  The epilogue ranks
//    ||c||^2 - 2 a.c (||a||^2 is the same for a row's every centroid and is
//    added at the end).  Where every key fits int32 (3 d 127^2 2^b < 2^31
//    for b bits of a centroid index: d = 21 with K up to 2048), a centroid's
//    norm is staged as (||c||^2 << b) + k, so a distance's key is one
//    multiply-add and the running minimum one min: the smallest key is the
//    smallest distance and, on ties, the first centroid.  Otherwise the
//    epilogue takes the minimum of a thread's 8 values of a row and only
//    where that beats the running minimum finds the first centroid holding
//    it (measured on an H100 at the fit shape: 0.042 ms that way, 0.031
//    with keys).
//    ``split`` warps share a tile's groups (the wrapper's plan: eight at a
//    1024-row bucket, so 64 blocks take part where 8 would); the four
//    lanes of a row and then the split warps reduce (value, index) by
//    shuffles and through shared memory, the smallest value and then the
//    smallest index.  Blocks are persistent (at most four an SM) and walk
//    their tiles.  The distances are exact int32 and the scan keeps the
//    first index on ties, so the reference's packed/unpacked fork is not
//    needed.
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
constexpr int WC = 16;              // matrix mode: words of a chunk
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

// B7.  Block b, iteration i: the 16-row tiles t = (i gridDim.x + b) TPB +
// warp / split; the split warps of a tile take the 32-centroid groups
// G = warp % split, + split, .. of each chunk of centroids in shared memory.
constexpr int AM_THREADS = 256;
constexpr int AM_WARPS = AM_THREADS / 32;
constexpr int AM_RESIDENT_MAX = 57344;  // bytes of staged centroid words, norms

// bytes a staged centroid takes: 8 ks + 4 words (B6's padded row), a norm
__host__ __device__ inline int am_record(int d) {
    return (8 * ((d + 31) / 32) + 4) * 4 + 4;
}

// the k-step s fragment of rows r and r + 8 (mma.sync A operand): bytes
// 32 s + 4 tig and 32 s + 16 + 4 tig of each, zero past d and past N
__device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                       const int8_t* __restrict__ A, int r,
                                       int N, int d, int s, int tig) {
    const int f = 32 * s + 4 * tig;
    const int8_t* lo = A + static_cast<size_t>(r) * d;
    const int8_t* hi = lo + static_cast<size_t>(8) * d;
    a[0] = r < N ? load_word(lo, f, d) : 0u;
    a[1] = r + 8 < N ? load_word(hi, f, d) : 0u;
    a[2] = r < N ? load_word(lo, f + 16, d) : 0u;
    a[3] = r + 8 < N ? load_word(hi, f + 16, d) : 0u;
}

// PACKED: a centroid's norm is staged as the key (||c||^2 << shift) + k,
// and a distance's key (||c||^2 - 2 a.c) << shift + k is one multiply-add
// from it; the smallest key is the smallest distance and, on ties, the
// smallest index (the entry point takes it where every key fits int32).
template <bool PACKED>
__global__ void __launch_bounds__(AM_THREADS, 4)
q8_argmin_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ C,
                 int* __restrict__ out_v, int* __restrict__ out_i, int N,
                 int K, int d, int split, int kc, int shift) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int ks = (d + 31) / 32;
    const int st = 8 * ks + 4;
    uint32_t* c_w = reinterpret_cast<uint32_t*>(smem);
    int* cn_s = reinterpret_cast<int*>(smem + static_cast<size_t>(kc) * st * 4);
    int* red_v = cn_s + kc;                 // [AM_WARPS][16]
    int* red_i = red_v + AM_WARPS * 16;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int per_block = AM_WARPS / split;
    const int wq = warp % split;
    const int tiles = (N + 15) / 16;
    const bool resident = kc >= K;

    // centroids [k0, k0 + kc) as padded words with their norms; INT_MAX
    // norms past K, so no padding centroid is ever the nearest
    auto stage = [&](int k0) {
        for (int e = tid; e < kc; e += AM_THREADS) {
            const int k = k0 + e;
            const int8_t* c = C + static_cast<size_t>(k) * d;
            int n = 0;
#pragma unroll 8
            for (int w = 0; w < 8 * ks; ++w) {
                const uint32_t v = k < K ? load_word(c, 4 * w, d) : 0u;
                c_w[e * st + w] = v;
                n = __dp4a(static_cast<int>(v), static_cast<int>(v), n);
            }
            cn_s[e] = k >= K ? INT_MAX : PACKED ? (n << shift) + k : n;
        }
    };
    if (resident) {
        stage(0);
        __syncthreads();
    }
    for (int t0 = blockIdx.x * per_block; t0 < tiles;
         t0 += gridDim.x * per_block) {
        const int tile = t0 + warp / split;
        const int r = tile * 16 + gid;        // the thread's rows r, r + 8
        const bool live = tile < tiles;
        uint32_t a0[4];
        int an[2] = {0, 0};
        a_frag(a0, A, r, N, d, 0, tig);
        for (int s = 0; s < ks; ++s) {
            uint32_t a[4];
            if (s == 0) {
#pragma unroll
                for (int j = 0; j < 4; ++j) a[j] = a0[j];
            } else {
                a_frag(a, A, r, N, d, s, tig);
            }
            an[0] = __dp4a(static_cast<int>(a[0]), static_cast<int>(a[0]),
                           an[0]);
            an[0] = __dp4a(static_cast<int>(a[2]), static_cast<int>(a[2]),
                           an[0]);
            an[1] = __dp4a(static_cast<int>(a[1]), static_cast<int>(a[1]),
                           an[1]);
            an[1] = __dp4a(static_cast<int>(a[3]), static_cast<int>(a[3]),
                           an[1]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            an[h] += __shfl_xor_sync(bsel::FULL, an[h], 1);
            an[h] += __shfl_xor_sync(bsel::FULL, an[h], 2);
        }
        // the running minimum of ||c||^2 - 2 a.c of rows r and r + 8 over
        // the thread's columns, in ascending centroid order
        int best[2] = {INT_MAX, INT_MAX}, best_i[2] = {0, 0};
        for (int k0 = 0; k0 < K; k0 += kc) {
            if (!resident) {
                __syncthreads();   // the last chunk is consumed
                stage(k0);
                __syncthreads();
            }
            if (!live) continue;
            const int groups = (min(kc, K - k0) + 31) / 32;
            for (int g = wq; g < groups; g += split) {
                int acc[4][4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
                for (int s = 0; s < ks; ++s) {
                    uint32_t a[4];
                    if (s == 0) {
#pragma unroll
                        for (int j = 0; j < 4; ++j) a[j] = a0[j];
                    } else {
                        a_frag(a, A, r, N, d, s, tig);
                    }
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const uint32_t* p =
                            c_w + (32 * g + 8 * j + gid) * st + 8 * s + tig;
                        mma_s8(acc[j], a, p[0], p[4]);
                    }
                }
                // columns 32 g + 8 j + 2 tig + e; rows r (acc e = 0, 1)
                // and r + 8 (e = 2, 3)
                int2 cn[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    cn[j] = *reinterpret_cast<const int2*>(
                        cn_s + 32 * g + 8 * j + 2 * tig);
                if (PACKED) {
                    const int mul = -(2 << shift);
#pragma unroll
                    for (int h = 0; h < 2; ++h)
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            best[h] = min(best[h],
                                          min(acc[j][2 * h] * mul + cn[j].x,
                                              acc[j][2 * h + 1] * mul +
                                                  cn[j].y));
                    continue;
                }
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    int v[8];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        v[2 * j] = cn[j].x - 2 * acc[j][2 * h];
                        v[2 * j + 1] = cn[j].y - 2 * acc[j][2 * h + 1];
                    }
                    int m = v[0];
#pragma unroll
                    for (int i = 1; i < 8; ++i) m = min(m, v[i]);
                    if (m < best[h]) {   // rare past the first groups
                        int at = 7;
#pragma unroll
                        for (int i = 6; i >= 0; --i)
                            if (v[i] == m) at = i;
                        best[h] = m;
                        best_i[h] = k0 + 32 * g + 8 * (at >> 1) + 2 * tig +
                                    (at & 1);
                    }
                }
            }
        }
        // the four lanes of a row: the smallest value, then the smallest
        // index holding it; the split warps of a tile meet in red
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if (PACKED && best[h] != INT_MAX) {
                best_i[h] = best[h] & ((1 << shift) - 1);
                best[h] >>= shift;
            }
#pragma unroll
            for (int o = 1; o <= 2; o <<= 1) {
                const int v = __shfl_xor_sync(bsel::FULL, best[h], o);
                const int i = __shfl_xor_sync(bsel::FULL, best_i[h], o);
                if (v < best[h] || (v == best[h] && i < best_i[h])) {
                    best[h] = v;
                    best_i[h] = i;
                }
            }
            if (tig == 0) {
                red_v[warp * 16 + gid + 8 * h] =
                    best[h] == INT_MAX ? INT_MAX : best[h] + an[h];
                red_i[warp * 16 + gid + 8 * h] = best_i[h];
            }
        }
        __syncthreads();
        if (tid < per_block * 16) {
            const int tl = tid / 16, row = (t0 + tl) * 16 + tid % 16;
            if (row < N) {
                int v = INT_MAX, i = 0;
                for (int w = tl * split; w < (tl + 1) * split; ++w) {
                    const int wv = red_v[w * 16 + tid % 16];
                    const int wi = red_i[w * 16 + tid % 16];
                    if (wv < v || (wv == v && wi < i)) {
                        v = wv;
                        i = wi;
                    }
                }
                out_v[row] = v;
                out_i[row] = i;
            }
        }
        __syncthreads();   // red is read before the next tiles write it
    }
}

}  // namespace

extern "C" {

int q8_topk_k_max() { return TOPK_K_MAX; }
int q8_query_tile() { return QB; }
int q8_tile_rows() { return RB; }
int q8_bulk_max_d() { return Q8_BULK_MAX_D; }
int q8_max_d() { return MAX_D; }
int q8_argmin_resident_max() { return AM_RESIDENT_MAX; }

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
// split: warps a 16-row tile (1, 2, 4 or 8); kc: centroids staged at once,
// a multiple of 32 whose words and norms fit AM_RESIDENT_MAX bytes (all
// of them resident where kc >= K); grid: the persistent blocks.
int distance_argmin_q8(const int8_t* A, const int8_t* C, int* out_v,
                       int* out_i, int N, int K, int d, int split, int kc,
                       int grid, void* stream) {
    if (N < 1 || K < 1 || d < 1 || d > MAX_D || grid < 1 ||
        (split != 1 && split != 2 && split != 4 && split != AM_WARPS) ||
        kc < 32 || kc % 32 ||
        static_cast<long long>(kc) * am_record(d) > AM_RESIDENT_MAX)
        return (int)cudaErrorInvalidValue;
    int shift = 0;   // bits of a centroid index
    while ((1LL << shift) < K) ++shift;
    // |(||c||^2 - 2 a.c)| <= 3 d 127^2
    const bool packed = ((3LL * d * 127 * 127 + 1) << shift) <= INT_MAX;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t bytes = static_cast<size_t>(kc) * am_record(d) +
                         2 * AM_WARPS * 16 * sizeof(int);
    auto* kernel = packed ? q8_argmin_kernel<true> : q8_argmin_kernel<false>;
    static size_t allowed[2] = {48 * 1024, 48 * 1024};
    if (bytes > allowed[packed]) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes));
        if (err != cudaSuccess) return static_cast<int>(err);
        allowed[packed] = bytes;
    }
    kernel<<<grid, AM_THREADS, bytes, s>>>(A, C, out_v, out_i, N, K, d, split,
                                           kc, shift);
    return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
