// The fp32 distance-tile arithmetic shared by B1 (distance_topk.cu), B2
// (distance_argmin.cu) and B4 (pairwise_sq_dist.cu), so that the two arms
// of kNN, and the two arms of K-Means, compute the same distances bit for
// bit.
//
// A tile scores QB queries against RB rows with 256 threads, each owning
// an 8-query x 8-row register micro-tile.  The expansion is
// ||a||^2 - 2 a.c + ||c||^2 in fp32 on the CUDA cores (never TF32):
//  * queries are staged transposed in shared memory and scaled by -2
//    (exact), c_t[j][q] = -2 C[q][j];
//  * a query's and a row's squared norm are summed by two threads, each
//    over every other feature (j = parity, parity + 2, ...) with fused
//    multiply-adds from zero, and the two halves added;
//  * on the bulk route a distance starts from ||a||^2 + ||c||^2 and takes
//    one fused multiply-add a feature, c_t[j][q] * a[j] + acc, in feature
//    order; so after the last feature it is the distance.
// The order of every operation is fixed here; which thread owns which
// (query, row) is each kernel's own choice and does not change a value.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace dtile {

constexpr int QB = 128;        // queries of a tile
constexpr int RB = 128;        // rows of a tile
constexpr int THREADS = 256;   // threads of a tile
constexpr int TQ = 8;          // queries of a thread
constexpr int TR = 8;          // rows of a thread
constexpr int DC = 32;         // plain route: features of a chunk
constexpr int PSTRIDE = DC + 1;  // plain route: padded row of a chunk
constexpr unsigned FULL = 0xffffffffu;

// The bulk route: the n floats of a row tile (one span) into a stage, the
// 16-byte part by one 1-D bulk copy, the rest by this thread, which then
// arrives on the stage's barrier.  src and dst must be 16-byte aligned.
__device__ __forceinline__ void issue_rows(float* dst, const float* src,
                                           int n, uint64_t* bar) {
    const int bulk = n & ~3;
    for (int f = bulk; f < n; ++f) dst[f] = src[f];
    hop::mbar_expect_tx(bar, static_cast<uint32_t>(bulk) * 4);
    if (bulk) hop::bulk_load_1d(dst, src, static_cast<uint32_t>(bulk) * 4, bar);
}

// The plain route: features [c0, c0 + dc) of rows row0.. of A (0 past
// ``rows``) into stage[r * PSTRIDE + j], by element loads
__device__ __forceinline__ void stage_rows(float* stage,
                                           const float* __restrict__ A,
                                           int row0, int rows, int d, int c0,
                                           int dc) {
    for (int e = threadIdx.x; e < RB * dc; e += THREADS) {
        const int r = e / dc, j = e - r * dc;
        stage[r * PSTRIDE + j] = r < rows
            ? A[static_cast<size_t>(row0 + r) * d + c0 + j] : 0.f;
    }
}

// c_t[j][q] = -2 * C[q0 + q][c0 + j] for j < dc, 0 past Q
__device__ __forceinline__ void stage_queries(float* c_t,
                                              const float* __restrict__ C,
                                              int q0, int Q, int d, int c0,
                                              int dc) {
    for (int e = threadIdx.x; e < dc * QB; e += THREADS) {
        const int j = e / QB, q = e - j * QB;
        c_t[e] = q0 + q < Q ? -2.f * C[static_cast<size_t>(q0 + q) * d + c0 + j]
                            : 0.f;
    }
}

// cn_s[q] = ||C[q0 + q]||^2 for the QB queries of a tile (0 past Q), two
// threads a query
__device__ __forceinline__ void query_norms(float* cn_s,
                                            const float* __restrict__ C,
                                            int q0, int Q, int d) {
    const int q = threadIdx.x >> 1;
    float s = 0.f;
    if (q0 + q < Q) {
        const float* c = C + static_cast<size_t>(q0 + q) * d;
        for (int j = threadIdx.x & 1; j < d; j += 2) s = fmaf(c[j], c[j], s);
    }
    s += __shfl_xor_sync(FULL, s, 1);
    if ((threadIdx.x & 1) == 0) cn_s[q] = s;
}

// this thread's half of the sum of squares of features [0, dc) of row
// threadIdx.x / 2 of a staged tile whose row r, feature j lies at
// a_s[r * rs + j * fs]; add the partner's half with __shfl_xor_sync(., 1)
__device__ __forceinline__ float half_norm(const float* a_s, int rs, int fs,
                                           int dc) {
    const float* r = a_s + (threadIdx.x >> 1) * rs;
    float s = 0.f;
    for (int j = threadIdx.x & 1; j < dc; j += 2)
        s = fmaf(r[j * fs], r[j * fs], s);
    return s;
}

// the plain route's half of a row's squared norm, read from the row's d
// floats (device or shared memory): per 32-feature chunk a fused
// multiply-add chain from zero over the chunk's features of this parity,
// the chunks' sums added in order; it is what half_norm sums chunk by
// chunk on the plain route, and half_norm's own sum where d <= DC
__device__ __forceinline__ float chunked_half_norm(const float* row, int d,
                                                   int parity) {
    float s = 0.f;
    for (int c0 = 0; c0 < d; c0 += DC) {
        const int c1 = c0 + DC < d ? c0 + DC : d;
        float h = 0.f;
        for (int j = c0 + parity; j < c1; j += 2) h = fmaf(row[j], row[j], h);
        s += h;
    }
    return s;
}

// one feature of the micro-tile: acc[qi][ri] += c[qi] * a[ri], fused
__device__ __forceinline__ void fma_tile(const float (&c)[TQ],
                                         const float (&a)[TR],
                                         float (&acc)[TQ][TR]) {
#pragma unroll
    for (int qi = 0; qi < TQ; ++qi)
#pragma unroll
        for (int ri = 0; ri < TR; ++ri)
            acc[qi][ri] = fmaf(c[qi], a[ri], acc[qi][ri]);
}

// the tile-local index of a thread's slot i (queries or rows): 4 t + i
// and 64 + 4 t + (i - 4), so that each half loads as one float4
__device__ __forceinline__ int slot(int t, int i) {
    return (i < 4 ? 0 : 64 - 4) + 4 * t + i;
}

// acc[qi][ri] += sum_j c_t[j][slot(tq, qi)] * a_s[row(ri)][j] over j < dc,
// one fused multiply-add a feature in feature order.  a_s holds the tile's
// rows row-major with row stride ``stride``; c_t the queries transposed
// (QB a feature).  A thread's rows: slot(tr, ri) with CONSEC (B4: four
// consecutive rows a half, for float4 writes of a finished tile), or
// tr + 16 ri (B1, B2).  Eight scalar loads of rows and two float4 of
// queries feed 64 FMAs a feature.  B1 and B4 keep the loop rolled: with
// 64 accumulators and their lists or staging the registers of a deeper
// unroll spill at two blocks an SM.  B2 keeps no list and unrolls it by
// two (UNROLL): 0.099 against 0.106 ms at the K-Means fit shape
// (launch/ann_breakdown.py's probes).  The unroll does not change a value.
template <bool CONSEC, int UNROLL = 1>
__device__ __forceinline__ void dots(const float* a_s, int stride,
                                     const float* c_t, int dc, int tq, int tr,
                                     float (&acc)[TQ][TR]) {
    const float* ar = a_s + (CONSEC ? 4 * tr : tr) * stride;
    const float* cq = c_t + 4 * tq;
#pragma unroll (UNROLL)
    for (int j = 0; j < dc; ++j) {
        float a[TR];
#pragma unroll
        for (int i = 0; i < TR; ++i)
            a[i] = ar[(CONSEC ? slot(0, i) : 16 * i) * stride + j];
        const float4 c0 = *reinterpret_cast<const float4*>(cq + j * QB);
        const float4 c1 = *reinterpret_cast<const float4*>(cq + j * QB + 64);
        const float c[TQ] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        fma_tile(c, a, acc);
    }
}

}  // namespace dtile
