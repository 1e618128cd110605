// Fused squared distance -> nearest centroid, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel B2 of the JAX package:
//   kernels/distance_topk.py::_argmin_kernel (distance_argmin, K-Means
//   OP1+OP2, Selection Sort with k = 1): A (N, d), C (K, d) -> the smallest
//   ||a||^2 - 2 a.c + ||c||^2 of each row and its centroid, the first
//   index on ties.  The (N, K) distances never leave the chip.
//
// What bounds it on an H100: the fp32 CUDA cores.  At the K-Means fit
// shape (N = 262,144, K = 256, d = 21) it does 1.4 G fused multiply-adds,
// 0.042 ms at the 67 TFLOP/s peak, against 22 MB of rows; at d = 1 (the
// ANN path's PQ codebook fits) the multiply-adds are few and what costs is
// a distance's other operations (the norm sum and the compare), and the
// launch.
//
// The design.
//  * Arithmetic: csrc/distance_tile.cuh, B1's and B4's.  Centroids play
//    the part of B1's queries: they stay resident in shared memory for the
//    whole kernel, transposed and scaled by -2, in tiles of 128, with
//    their norms; rows stream.  Each of 256 threads computes an 8-centroid
//    x 8-row micro-tile (dtile::dots; on the bulk route its feature loop
//    unrolled by two, which spills registers on the others), 6.4
//    multiply-adds a shared load.
//    The operation order is the one B4 takes for the same rows, chosen by
//    B4's rule: where B4 takes its bulk route (A 16-byte aligned, d <= 32)
//    a distance starts from ||a||^2 + ||c||^2 and takes one FMA a feature;
//    otherwise it starts from ||c||^2, takes the FMAs and adds ||a||^2
//    last, with ||a||^2 summed in 32-feature chunks.  So K-Means' fused
//    (B2) and blocked (B4, then a row min) arms rank the same floats and
//    assign identically (chip_smoke.py checks it at the fit shape).
//  * Selection: each thread keeps, in registers across the centroid tiles,
//    a running (value, index) minimum for each of its 8 rows: a strict <
//    in ascending centroid order, so a NaN distance never takes it and the
//    first index wins a tie.  At the end of a row tile the 16 threads that
//    share a row reduce by shuffles (the smallest value, then the smallest
//    index holding it) and the two warps of a row meet in shared memory.
//    One launch; no list and no merge kernel.  A row whose distances are
//    all NaN (or +Inf) keeps the start (+Inf, 0): centroid 0 at +Inf, the
//    rule ROADMAP C4 pins.
//  * Routes (``distance_argmin.route``), counted by the wrapper:
//      bulk    (A 16-byte aligned, d <= 32, centroids resident): persistent
//              blocks, about two an SM, walk the 128-row tiles; one thread
//              copies each tile into a ring of three stages with a 1-D bulk
//              asynchronous copy (B1's ring, hop::bulk_load_1d), two tiles
//              ahead of the one computed.  Only the d features a row has
//              are staged: at d = 1 a tile is 512 bytes.
//      plain   (any other A, centroids resident): the same tiles, rows
//              loaded in 32-feature chunks with element loads.
//      stream  (the centroids do not stay resident: K d past
//              RESIDENT_MAX bytes): as plain, and each 32-feature chunk of
//              a 128-centroid tile is staged in turn for every row tile.
//      narrow  (few rows: N <= NARROW_MAX_ROWS in the wrapper, centroids
//              resident): a block takes 8 rows, a warp each, and each lane
//              8 centroids of a 128-centroid tile at a time; the warp
//              reduces its row by shuffles.  So a serving bucket of 1024
//              rows runs 128 blocks where the 128-row tiles would run 8.
//      rows    (d <= ROWS_MAX_D, centroids resident): the PQ codebooks'
//              width (d = 1 on the ANN path), where a distance is one or
//              a few multiply-adds and the tiles' norms, reductions and
//              barriers would cost more than the distances.  A thread
//              holds 4 rows in registers and scans a quarter of the
//              centroids in ascending order, from records in shared memory
//              that the warp reads at once; the four threads of a row
//              group reduce by two shuffles, and 128 rows make a block, so
//              65,536 rows fill the card with 16 warps an SM.  No padding
//              feature is staged.  The operation order is the tiles'.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

#include "distance_tile.cuh"
#include "hopper.cuh"

namespace {

using dtile::DC;
using dtile::FULL;
using dtile::PSTRIDE;
using dtile::QB;
using dtile::RB;
using dtile::THREADS;
using dtile::TQ;
using dtile::TR;

constexpr int BULK_MAX_D = 32;      // widest row the bulk route stages whole
constexpr int STAGES = 3;           // bulk route: row tiles in flight
constexpr int RESIDENT_MAX = 57344; // bytes of resident centroids and norms
constexpr int NARROW_ROWS = 8;      // rows of a narrow block, one a warp
constexpr int ROWS_MAX_D = 4;       // widest row of the rows route
constexpr int ROWS_THREADS = 128;   // threads of a rows block
constexpr int RPT = 4;              // rows of a thread on the rows route
constexpr int KS = 4;               // threads of a row group: K in KS slices

enum Route { BULK = 0, PLAIN = 1, STREAM = 2, NARROW = 3, ROWS = 4 };

__host__ __device__ constexpr size_t up128(size_t n) {
    return (n + 127) & ~static_cast<size_t>(127);
}

// bytes of the resident centroids: every 128-centroid tile, transposed,
// and its norms
__host__ __device__ inline size_t resident_bytes(int K, int d) {
    const size_t tiles = (K + QB - 1) / QB;
    return tiles * QB * (static_cast<size_t>(d) + 1) * 4;
}

struct Layout {
    size_t stage_bytes, c_t, cn, an, red, bar, total;
};

// byte offsets of the dynamic shared memory (host and device agree)
__host__ __device__ inline Layout layout(int route, int K, int d) {
    Layout L{};
    const size_t tiles = (K + QB - 1) / QB;
    const bool resident = route != STREAM;
    if (route == ROWS) {   // a record of d + 1 floats a centroid
        L.c_t = 0;
        L.total = up128(static_cast<size_t>(K) * (d + 1) * 4);
        return L;
    }
    if (route == NARROW) {
        L.stage_bytes = up128(static_cast<size_t>(NARROW_ROWS) * d * 4);
    } else {
        L.stage_bytes = up128(static_cast<size_t>(RB) *
                              (route == BULK ? d : PSTRIDE) * 4);
    }
    size_t off = L.stage_bytes * (route == BULK ? STAGES : 1);
    L.c_t = off;
    off += up128((resident ? tiles * d : static_cast<size_t>(DC)) * QB * 4);
    L.cn = off;
    off += up128((resident ? tiles : 1) * QB * 4);
    L.an = off;
    off += RB * 4;
    L.red = off;          // [2][RB] values, then [2][RB] indices
    off += 2 * RB * 8;
    L.bar = off;
    L.total = off + 8 * STAGES;
    return L;
}

// every 128-centroid tile, transposed and scaled by -2 (c_t, d features a
// tile), and the norms (cn), resident for the whole kernel
__device__ __forceinline__ void stage_centroids(float* c_t, float* cn_s,
                                                const float* __restrict__ C,
                                                int K, int d) {
    for (int q0 = 0; q0 < K; q0 += QB) {
        dtile::stage_queries(c_t + static_cast<size_t>(q0) * d, C, q0, K, d,
                             0, d);
        dtile::query_norms(cn_s + q0, C, q0, K, d);
    }
}

// the smaller of (v, i) and (w, j): value first, then index
__device__ __forceinline__ void take_min(float& v, int& i, float w, int j) {
    if (w < v || (w == v && j < i)) {
        v = w;
        i = j;
    }
}

// Persistent blocks walk the 128-row tiles t = blockIdx.x, + gridDim.x, ..;
// the block's i-th tile lands in ring stage i % STAGES (bulk route).
template <bool RING>
__global__ void __launch_bounds__(THREADS, 2)
argmin_wide(const float* __restrict__ A, const float* __restrict__ C,
            float* __restrict__ out_v, int* __restrict__ out_i, int N, int K,
            int d, int resident, int bulk_order) {
    extern __shared__ __align__(128) unsigned char smem[];
    const Layout lay = layout(RING ? BULK : resident ? PLAIN : STREAM, K, d);
    float* stage = reinterpret_cast<float*>(smem);
    float* c_t = reinterpret_cast<float*>(smem + lay.c_t);
    float* cn_s = reinterpret_cast<float*>(smem + lay.cn);
    float* an_s = reinterpret_cast<float*>(smem + lay.an);
    float* red_v = reinterpret_cast<float*>(smem + lay.red);
    int* red_i = reinterpret_cast<int*>(smem + lay.red + 2 * RB * 4);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar);
    const int stage_floats = static_cast<int>(lay.stage_bytes / 4);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // a warp covers 8 centroid groups x 4 row groups (B1's layout); the 16
    // threads of a row are 8 lanes of each of the warps 2p and 2p + 1
    const int tq = (warp & 1) * 8 + (lane & 7);
    const int tr = (warp >> 1) * 4 + (lane >> 3);
    const int k_tiles = (K + QB - 1) / QB;
    const int row_tiles = (N + RB - 1) / RB;
    const int mine = (row_tiles - static_cast<int>(blockIdx.x) +
                      static_cast<int>(gridDim.x) - 1) / gridDim.x;
    const int nch = RING ? 1 : (d + DC - 1) / DC;

    if (resident) stage_centroids(c_t, cn_s, C, K, d);
    if (RING && tid == 0) {
        for (int s = 0; s < STAGES; ++s) hop::mbar_init(&full[s], 1);
        hop::fence_barrier_init();
    }
    __syncthreads();
    auto issue = [&](int i) {   // the rows of the block's i-th tile
        const int row0 = (blockIdx.x + i * gridDim.x) * RB;
        dtile::issue_rows(stage + (i % STAGES) * stage_floats,
                          A + static_cast<size_t>(row0) * d,
                          min(RB, N - row0) * d, &full[i % STAGES]);
    };
    if (RING && tid == 0)
        for (int i = 0; i < STAGES && i < mine; ++i) issue(i);

    // the two warps of each row meet in red: the row's nearest centroid
    auto finish = [&](int row0, int rows) {
        if (tid < rows) {
            float v = red_v[tid];
            int i = red_i[tid];
            take_min(v, i, red_v[RB + tid], red_i[RB + tid]);
            out_v[row0 + tid] = v;
            out_i[row0 + tid] = i;
        }
    };

    for (int i = 0; i < mine; ++i) {
        const int row0 = (blockIdx.x + i * gridDim.x) * RB;
        const int rows = min(RB, N - row0);
        if (i > 0) {
            __syncthreads();   // tile i - 1 is consumed and its red written
            finish(row0 - gridDim.x * RB, RB);
            if (RING && tid == 0 && i - 1 + STAGES < mine)
                issue(i - 1 + STAGES);
        }
        float bv[TR];
        int bi[TR];
#pragma unroll
        for (int ri = 0; ri < TR; ++ri) {
            bv[ri] = CUDART_INF_F;
            bi[ri] = 0;
        }
        // the running minimum over centroid tile kt: ascending index
        auto select = [&](const float (&acc)[TQ][TR], int kt) {
            bool ok[TQ];
            int id[TQ];
#pragma unroll
            for (int qi = 0; qi < TQ; ++qi) {
                id[qi] = kt * QB + dtile::slot(tq, qi);
                ok[qi] = id[qi] < K;
            }
#pragma unroll
            for (int ri = 0; ri < TR; ++ri)
#pragma unroll
                for (int qi = 0; qi < TQ; ++qi)
                    if (ok[qi] && acc[qi][ri] < bv[ri]) {
                        bv[ri] = acc[qi][ri];
                        bi[ri] = id[qi];
                    }
        };
        if (RING) {
            const float* a_s = stage + (i % STAGES) * stage_floats;
            hop::mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
            float s = dtile::half_norm(a_s, d, 1, d);
            s += __shfl_xor_sync(FULL, s, 1);
            if ((tid & 1) == 0) an_s[tid >> 1] = s;
            __syncthreads();   // an_s is set; the last finish is done
            for (int kt = 0; kt < k_tiles; ++kt) {
                const float* ct = c_t + static_cast<size_t>(kt) * d * QB;
                float acc[TQ][TR];
#pragma unroll
                for (int qi = 0; qi < TQ; ++qi)
#pragma unroll
                    for (int ri = 0; ri < TR; ++ri)
                        acc[qi][ri] = an_s[tr + 16 * ri] +
                                      cn_s[kt * QB + dtile::slot(tq, qi)];
                dtile::dots<false, 2>(a_s, d, ct, d, tq, tr, acc);
                select(acc, kt);
            }
        } else {
            {   // ||a||^2 of the tile's rows, chunked as the plain route
                const int r = tid >> 1;
                float s = r < rows ? dtile::chunked_half_norm(
                    A + static_cast<size_t>(row0 + r) * d, d, tid & 1) : 0.f;
                s += __shfl_xor_sync(FULL, s, 1);
                if ((tid & 1) == 0) an_s[r] = s;
            }
            for (int kt = 0; kt < k_tiles; ++kt) {
                float acc[TQ][TR];
                for (int ch = 0; ch < nch; ++ch) {
                    const int c0 = ch * DC, dc = min(DC, d - c0);
                    __syncthreads();   // the stage and c_t are free
                    if (nch > 1 || kt == 0)
                        dtile::stage_rows(stage, A, row0, rows, d, c0, dc);
                    if (!resident) {
                        dtile::stage_queries(c_t, C, kt * QB, K, d, c0, dc);
                        if (ch == 0) dtile::query_norms(cn_s, C, kt * QB, K, d);
                    }
                    __syncthreads();
                    const float* cn_t = cn_s + (resident ? kt * QB : 0);
                    if (ch == 0) {
#pragma unroll
                        for (int qi = 0; qi < TQ; ++qi)
#pragma unroll
                            for (int ri = 0; ri < TR; ++ri) {
                                const float cn = cn_t[dtile::slot(tq, qi)];
                                acc[qi][ri] = bulk_order
                                    ? an_s[tr + 16 * ri] + cn : cn;
                            }
                    }
                    const float* ct = resident
                        ? c_t + (static_cast<size_t>(kt) * d + c0) * QB : c_t;
                    dtile::dots<false>(stage, PSTRIDE, ct, dc, tq, tr, acc);
                }
                if (!bulk_order) {
#pragma unroll
                    for (int qi = 0; qi < TQ; ++qi)
#pragma unroll
                        for (int ri = 0; ri < TR; ++ri)
                            acc[qi][ri] += an_s[tr + 16 * ri];
                }
                select(acc, kt);
            }
        }
        // the 8 lanes of a row in this warp: the smallest value, then the
        // smallest index holding it; lane 8g writes for the warp
#pragma unroll
        for (int ri = 0; ri < TR; ++ri) {
            float m = bv[ri];
            m = fminf(m, __shfl_xor_sync(FULL, m, 1));
            m = fminf(m, __shfl_xor_sync(FULL, m, 2));
            m = fminf(m, __shfl_xor_sync(FULL, m, 4));
            int c = bv[ri] == m ? bi[ri] : INT_MAX;
            c = min(c, __shfl_xor_sync(FULL, c, 1));
            c = min(c, __shfl_xor_sync(FULL, c, 2));
            c = min(c, __shfl_xor_sync(FULL, c, 4));
            if ((lane & 7) == 0) {
                red_v[(warp & 1) * RB + tr + 16 * ri] = m;
                red_i[(warp & 1) * RB + tr + 16 * ri] = c;
            }
        }
    }
    __syncthreads();
    if (mine > 0) {
        const int row0 = (blockIdx.x + (mine - 1) * gridDim.x) * RB;
        finish(row0, min(RB, N - row0));
    }
}

// Block b: rows 8 b .. 8 b + 7, warp w the row 8 b + w; lane l the
// centroid groups g = l, l + 32, .. (tile g / 16, slots of tq = g % 16).
__global__ void __launch_bounds__(THREADS)
argmin_narrow(const float* __restrict__ A, const float* __restrict__ C,
              float* __restrict__ out_v, int* __restrict__ out_i, int N,
              int K, int d, int bulk_order) {
    extern __shared__ __align__(128) unsigned char smem[];
    const Layout lay = layout(NARROW, K, d);
    float* a_s = reinterpret_cast<float*>(smem);
    float* c_t = reinterpret_cast<float*>(smem + lay.c_t);
    float* cn_s = reinterpret_cast<float*>(smem + lay.cn);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int row0 = blockIdx.x * NARROW_ROWS;
    const int rows = min(NARROW_ROWS, N - row0);

    stage_centroids(c_t, cn_s, C, K, d);
    for (int e = tid; e < rows * d; e += THREADS)
        a_s[e] = A[static_cast<size_t>(row0) * d + e];
    __syncthreads();
    if (warp >= rows) return;
    const float* a = a_s + warp * d;
    // lanes 0 and 1 hold the two halves; every lane sums one of them
    float an = dtile::chunked_half_norm(a, d, lane & 1);
    an += __shfl_xor_sync(FULL, an, 1);

    float bv = CUDART_INF_F;
    int bi = 0;
    const int groups = (K + QB - 1) / QB * (QB / TQ);
    for (int g = lane; g < groups; g += 32) {
        const int kt = g / (QB / TQ), tq = g % (QB / TQ);
        const float* cq = c_t + static_cast<size_t>(kt) * d * QB + 4 * tq;
        float acc[TQ];
#pragma unroll
        for (int qi = 0; qi < TQ; ++qi) {
            const float cn = cn_s[kt * QB + dtile::slot(tq, qi)];
            acc[qi] = bulk_order ? an + cn : cn;
        }
        for (int j = 0; j < d; ++j) {
            const float aj = a[j];
            const float4 c0 = *reinterpret_cast<const float4*>(cq + j * QB);
            const float4 c1 =
                *reinterpret_cast<const float4*>(cq + j * QB + 64);
            const float c[TQ] = {c0.x, c0.y, c0.z, c0.w,
                                 c1.x, c1.y, c1.z, c1.w};
#pragma unroll
            for (int qi = 0; qi < TQ; ++qi) acc[qi] = fmaf(c[qi], aj, acc[qi]);
        }
#pragma unroll
        for (int qi = 0; qi < TQ; ++qi) {
            const float v = bulk_order ? acc[qi] : acc[qi] + an;
            const int id = kt * QB + dtile::slot(tq, qi);
            if (id < K && v < bv) {
                bv = v;
                bi = id;
            }
        }
    }
    float m = bv;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
        m = fminf(m, __shfl_xor_sync(FULL, m, off));
    int c = bv == m ? bi : INT_MAX;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
        c = min(c, __shfl_xor_sync(FULL, c, off));
    if (lane == 0) {
        out_v[row0 + warp] = m;
        out_i[row0 + warp] = c;
    }
}

// Thread t of block b: the RPT rows (b ROWS_THREADS + t) / KS RPT ..,
// held in registers with their norms, against the centroids q = t % KS,
// + KS, .. (ascending), each from a record in shared memory (-2 c, then
// ||c||^2); the KS threads of a row group (adjacent lanes) then reduce by
// shuffles, the smallest value and then the smallest index holding it.
template <int D>
__global__ void __launch_bounds__(ROWS_THREADS)
argmin_rows(const float* __restrict__ A, const float* __restrict__ C,
            float* __restrict__ out_v, int* __restrict__ out_i, int N, int K,
            int bulk_order) {
    extern __shared__ __align__(128) unsigned char smem[];
    float* rec = reinterpret_cast<float*>(smem);
    for (int q = threadIdx.x; q < K; q += ROWS_THREADS) {
        // ||c||^2 as dtile::query_norms sums it: the even features' and
        // the odd features' fused multiply-add chains, added
        float e = 0.f, o = 0.f;
#pragma unroll
        for (int j = 0; j < D; ++j) {
            const float x = C[static_cast<size_t>(q) * D + j];
            rec[q * (D + 1) + j] = -2.f * x;
            if (j & 1)
                o = fmaf(x, x, o);
            else
                e = fmaf(x, x, e);
        }
        rec[q * (D + 1) + D] = e + o;
    }
    __syncthreads();
    const int slice = threadIdx.x % KS;
    const int row0 = (blockIdx.x * ROWS_THREADS + threadIdx.x) / KS * RPT;
    float a[RPT][D], an[RPT], bv[RPT];
    int bi[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        float e = 0.f, o = 0.f;
#pragma unroll
        for (int j = 0; j < D; ++j) {
            a[r][j] = row0 + r < N ? A[static_cast<size_t>(row0 + r) * D + j]
                                   : 0.f;
            if (j & 1)
                o = fmaf(a[r][j], a[r][j], o);
            else
                e = fmaf(a[r][j], a[r][j], e);
        }
        an[r] = e + o;
        bv[r] = CUDART_INF_F;
        bi[r] = 0;
    }
#pragma unroll 4
    for (int q = slice; q < K; q += KS) {
        float c[D + 1];
#pragma unroll
        for (int j = 0; j <= D; ++j) c[j] = rec[q * (D + 1) + j];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            float acc = bulk_order ? an[r] + c[D] : c[D];
#pragma unroll
            for (int j = 0; j < D; ++j) acc = fmaf(c[j], a[r][j], acc);
            if (!bulk_order) acc += an[r];
            if (acc < bv[r]) {
                bv[r] = acc;
                bi[r] = q;
            }
        }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        float m = bv[r];
#pragma unroll
        for (int off = 1; off < KS; off <<= 1)
            m = fminf(m, __shfl_xor_sync(FULL, m, off));
        int c = bv[r] == m ? bi[r] : INT_MAX;
#pragma unroll
        for (int off = 1; off < KS; off <<= 1)
            c = min(c, __shfl_xor_sync(FULL, c, off));
        if (slice == 0 && row0 + r < N) {
            out_v[row0 + r] = m;
            out_i[row0 + r] = c;
        }
    }
}

template <typename Kernel>
cudaError_t allow(Kernel kernel, size_t bytes, size_t& allowed) {
    if (bytes <= allowed) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess) allowed = bytes;
    return err;
}

}  // namespace

extern "C" {

int distance_argmin_bulk_max_d() { return BULK_MAX_D; }
int distance_argmin_resident_max() { return RESIDENT_MAX; }
int distance_argmin_narrow_rows() { return NARROW_ROWS; }
int distance_argmin_rows_max_d() { return ROWS_MAX_D; }
int distance_argmin_rows_block() { return ROWS_THREADS / KS * RPT; }

// A (N, d), C (K, d) fp32 row-major -> out_v (N,) f32, out_i (N,) int32.
// route: 0 bulk (A 16-byte aligned, d <= BULK_MAX_D, centroids resident),
// 1 plain (centroids resident), 2 stream (centroids not resident: K d past
// RESIDENT_MAX bytes), 3 narrow (centroids resident), 4 rows (d <=
// ROWS_MAX_D, centroids resident); grid: the persistent blocks of bulk,
// plain and stream (at most the 128-row tiles), ceil(N / NARROW_ROWS) for
// narrow, ceil(N / (ROWS_THREADS / KS RPT)) for rows.  Returns the first
// CUDA error.
int distance_argmin_f32(const float* A, const float* C, float* out_v,
                        int* out_i, int N, int K, int d, int route, int grid,
                        void* stream) {
    const bool aligned = reinterpret_cast<uintptr_t>(A) % 16 == 0;
    const bool resident = resident_bytes(K, d) <= RESIDENT_MAX;
    const int row_tiles = (N + RB - 1) / RB;
    const int per_block = route == NARROW ? NARROW_ROWS
                        : route == ROWS ? ROWS_THREADS / KS * RPT : 0;
    if (N < 1 || K < 1 || d < 1 || grid < 1 || route < BULK ||
        route > ROWS || (route == STREAM) == resident ||
        (route == BULK && (d > BULK_MAX_D || !aligned)) ||
        (route == ROWS && d > ROWS_MAX_D) ||
        (per_block ? grid != (N + per_block - 1) / per_block
                   : grid > row_tiles))
        return static_cast<int>(cudaErrorInvalidValue);
    const int bulk_order = d <= BULK_MAX_D && aligned;
    const size_t bytes = layout(route, K, d).total;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (route == ROWS) {
        static size_t allowed[ROWS_MAX_D] = {48 * 1024, 48 * 1024, 48 * 1024,
                                             48 * 1024};
        auto* kernel = d == 1 ? argmin_rows<1> : d == 2 ? argmin_rows<2>
                     : d == 3 ? argmin_rows<3> : argmin_rows<4>;
        err = allow(kernel, bytes, allowed[d - 1]);
        if (err != cudaSuccess) return static_cast<int>(err);
        kernel<<<grid, ROWS_THREADS, bytes, s>>>(A, C, out_v, out_i, N, K,
                                                 bulk_order);
    } else if (route == NARROW) {
        static size_t allowed = 48 * 1024;
        err = allow(argmin_narrow, bytes, allowed);
        if (err != cudaSuccess) return static_cast<int>(err);
        argmin_narrow<<<grid, THREADS, bytes, s>>>(A, C, out_v, out_i, N, K,
                                                   d, bulk_order);
    } else if (route == BULK) {
        static size_t allowed = 48 * 1024;
        err = allow(argmin_wide<true>, bytes, allowed);
        if (err != cudaSuccess) return static_cast<int>(err);
        argmin_wide<true><<<grid, THREADS, bytes, s>>>(
            A, C, out_v, out_i, N, K, d, 1, 1);
    } else {
        static size_t allowed = 48 * 1024;
        err = allow(argmin_wide<false>, bytes, allowed);
        if (err != cudaSuccess) return static_cast<int>(err);
        argmin_wide<false><<<grid, THREADS, bytes, s>>>(
            A, C, out_v, out_i, N, K, d, static_cast<int>(resident),
            bulk_order);
    }
    return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
