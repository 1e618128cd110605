// Full squared-distance matrix, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel B4 of the JAX package:
//   kernels/distance.py::_dist_kernel (pairwise_sq_dist):
//   A (N, d), C (K, d) -> E (N, K),  E[n, k] = ||a_n||^2 - 2 a_n.c_k + ||c_k||^2
// It is the first pass of the blocked two-pass arm of kNN (E stored
// column-major, so that B5 reads E's transpose in place) and of K-Means
// (row-major).
//
// What bounds it on an H100: the bytes of E.  At the kNN shape (N = 2^20,
// K = Q = 1024, d = 21) it writes 4.29 GB, 1.28 ms at 3.35 TB/s, against
// 22.5 G fused multiply-adds, 0.67 ms at the 67 TFLOP/s fp32 peak.  At the
// K-Means fit shape (N = 262144, K = 256) it writes 268 MB.  So the FMAs
// must run under the stores, and the stores must be whole runs.
//
// The design:
//  * Arithmetic: csrc/distance_tile.cuh, B1's.  A tile is 128 rows x 128
//    queries; each of 256 threads owns an 8 x 8 micro-tile; the queries
//    are staged transposed and scaled by -2, norms are summed by two
//    threads each over every other feature, and on the bulk route a
//    distance starts from ||a||^2 + ||c||^2 and takes one FMA a feature in
//    feature order (dtile::dots, the loop B1 runs).  So at a shape where
//    B1 takes its bulk route too (the kNN shape), B4's distances are B1's
//    bit for bit, and the blocked and fused arms rank the same floats
//    (chip_smoke.py checks it at k = 32).  A thread's rows are four
//    consecutive rows in each half of the tile, so that its values go to
//    the staging buffer as float4.
//  * Work: tile w is row tile w / q_tiles and query tile w % q_tiles (the
//    query tile fastest), and ``grid`` persistent blocks (about two an SM,
//    a multiple of q_tiles where q_tiles is small) walk the tiles w = b,
//    b + grid, ...: so a block keeps one query tile, staged once, and the
//    blocks that read the same row tile run together, which reads A from
//    device memory about once (C is small and stays in L2).
//  * Staging, the bulk route (A's base 16-byte aligned and d <= 32, the
//    rule of B1's bulk route): a row tile is one span of 512 d bytes; one
//    thread copies it with a 1-D bulk asynchronous copy
//    (hop::bulk_load_1d) into a ring of three stages, two tiles ahead of
//    the one computed; a ragged last span is copied to its 16-byte part,
//    the rest by the copying thread.  Any other A (a view such as A[1:],
//    or d > 32) takes the plain route: each tile loads 32-feature chunks
//    of its rows and queries with element loads between barriers, and its
//    sum starts from ||c||^2 and adds ||a||^2 last, as B1's plain route.
//  * Epilogue: a finished tile is written through shared memory, so that
//    E receives whole runs along its contiguous axis (512 bytes a line of
//    the tile).  The staging buffer is double-buffered by halves of the
//    tile: half h of tile t is written into buffer h, stored, and buffer h
//    is taken again only by tile t + 1, once the stores of tile t's half
//    h have read it; so tile t's stores run under tile t + 1's FMAs.
//    Each thread writes its values into the buffer as float4 (lanes are
//    laid out so that a quarter-warp writes 128 consecutive bytes).  The
//    stores, chosen by the entry from E's alignment:
//      - tma: where E's base and row pitch are multiples of 16 bytes
//        (N % 4 == 0 column-major, K % 4 == 0 row-major), one thread
//        stores the 64 x 128 half tile with one 2-D TMA tensor store
//        (cp.async.bulk.tensor.2d, a tensor map of E; the parts past E's
//        edges are not written);
//      - scalar: element streaming stores read back from the buffer, any
//        pitch.
//    tma was chosen by measurement against two other mechanisms on the
//    same aligned pitch, since removed: 64 threads each issuing a 1-D
//    bulk store of a 512-byte line, and every thread storing 16 bytes at
//    a time.  Measured (launch/blocked_breakdown.py, NVIDIA H100 80GB
//    HBM3, 700 W): at the kNN shape tma 1.654 ms, 16-byte stores 2.024,
//    1-D bulk 2.081, scalar 2.818; at the K-Means fit shape tma 0.1141,
//    16-byte 0.1278, 1-D bulk 0.1356, scalar 0.1740.
//  * E is written row-major (N, K), or with ``a_fast`` as (K, N): the
//    transposed matrix whose rows the kNN arm's top-k pass reads.
//  * Ragged N and K are masked in the kernel; nothing is padded.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "distance_tile.cuh"
#include "hopper.cuh"

namespace {

using dtile::QB;
using dtile::RB;
using dtile::THREADS;
using dtile::TQ;
using dtile::TR;

constexpr int BULK_MAX_D = 32;   // widest row the bulk route stages whole
constexpr int HALF = 64;         // lines of a staging buffer
constexpr int LINE = 128;        // floats of a staging line

constexpr int STAGES = 3;        // bulk route: row tiles in flight
using dtile::DC;
using dtile::PSTRIDE;

struct Layout {
    size_t stage_bytes, c_t, an, cn, out, bar, total;
};

__host__ __device__ constexpr size_t up128(size_t n) {
    return (n + 127) & ~static_cast<size_t>(127);
}

// byte offsets of the dynamic shared memory (host and device agree)
__host__ __device__ inline Layout layout(bool bulk, int d) {
    Layout L{};
    L.stage_bytes = up128(static_cast<size_t>(RB) * (bulk ? d : PSTRIDE) * 4);
    L.c_t = L.stage_bytes * (bulk ? STAGES : 1);
    L.an = L.c_t + up128(static_cast<size_t>(d < DC ? d : DC) * QB * 4);
    L.cn = L.an + RB * 4;
    L.out = up128(L.cn + QB * 4);
    L.bar = L.out + 2 * HALF * LINE * 4;
    L.total = L.bar + 8 * STAGES;
    return L;
}

// Write a finished tile through the two staging buffers.  The major axis
// (the tile's lines) is the query axis when A_FAST, else the row axis; a
// line is 128 values along E's contiguous axis.  (tf, ts): the thread's
// slot indices along the contiguous and the major axis.  TMA: the 2-D
// tensor store of each half, else element stores.
template <bool A_FAST, bool TMA>
__device__ __forceinline__ void epilogue(const float (&acc)[TQ][TR],
                                         float* out_s, float* __restrict__ E,
                                         const CUtensorMap* tm_e,
                                         long long pitch, int major0,
                                         int n_major, int minor0, int ext,
                                         int tf, int ts) {
    const int tid = threadIdx.x;
    const bool issuer = TMA && tid == 0;   // the thread of the bulk groups
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float* buf = out_s + h * HALF * LINE;
        if (issuer) hop::bulk_wait_read<1>();
        __syncthreads();   // buffer h is free: read by its last stores
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            // major slot 4 h + i: line 4 ts + i of this half
            float4 lo, hi;
            if (A_FAST) {   // acc[query slot][row slot], rows along a line
                const int qi = 4 * h + i;
                lo = make_float4(acc[qi][0], acc[qi][1], acc[qi][2],
                                 acc[qi][3]);
                hi = make_float4(acc[qi][4], acc[qi][5], acc[qi][6],
                                 acc[qi][7]);
            } else {        // queries along a line
                const int ri = 4 * h + i;
                lo = make_float4(acc[0][ri], acc[1][ri], acc[2][ri],
                                 acc[3][ri]);
                hi = make_float4(acc[4][ri], acc[5][ri], acc[6][ri],
                                 acc[7][ri]);
            }
            float* line = buf + (4 * ts + i) * LINE;
            *reinterpret_cast<float4*>(line + 4 * tf) = lo;
            *reinterpret_cast<float4*>(line + 64 + 4 * tf) = hi;
        }
        if (TMA) hop::fence_proxy_async();
        __syncthreads();   // the half is in the buffer
        const int first = major0 + h * HALF;
        if (TMA) {
            if (tid == 0) {
                hop::tma_store_2d(tm_e, buf, minor0, first);
                hop::bulk_commit();
            }
        } else {
            for (int e = tid; e < HALF * LINE; e += THREADS) {
                const int l = e / LINE, c = e - l * LINE;
                if (first + l < n_major && c < ext)
                    __stcs(E + (first + l) * pitch + minor0 + c,
                           buf[l * LINE + c]);
            }
        }
    }
}

// Tile w: row tile w / q_tiles, query tile w % q_tiles.  Block b takes
// tiles b, b + gridDim.x, ..; its i-th tile's rows land in stage i % STAGES.
template <bool BULK, bool A_FAST, bool TMA>
__global__ void __launch_bounds__(THREADS, 2)
pairwise_kernel(const float* __restrict__ A, const float* __restrict__ C,
                float* __restrict__ E,
                const __grid_constant__ CUtensorMap tm_e, int N, int K,
                int d, int tiles) {
    extern __shared__ __align__(128) unsigned char smem[];
    const Layout lay = layout(BULK, d);
    float* stage = reinterpret_cast<float*>(smem);
    float* c_t = reinterpret_cast<float*>(smem + lay.c_t);
    float* an_s = reinterpret_cast<float*>(smem + lay.an);
    float* cn_s = reinterpret_cast<float*>(smem + lay.cn);
    float* out_s = reinterpret_cast<float*>(smem + lay.out);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar);
    const int stage_floats = static_cast<int>(lay.stage_bytes / 4);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // tf: the slot along E's contiguous axis, 8 consecutive values in a
    // quarter-warp (so its float4 writes of a line are 128 bytes in a row)
    const int tf = (lane & 7) + 8 * (warp & 1);
    const int ts = (lane >> 3) + 4 * (warp >> 1);
    const int tr = A_FAST ? tf : ts, tq = A_FAST ? ts : tf;
    const int q_tiles = (K + QB - 1) / QB;
    const long long pitch = A_FAST ? N : K;

    if (BULK && tid == 0) {
        for (int s = 0; s < STAGES; ++s) hop::mbar_init(&full[s], 1);
        hop::fence_barrier_init();
    }
    __syncthreads();
    auto issue = [&](int i) {   // the rows of the block's i-th tile
        const int w = blockIdx.x + i * gridDim.x;
        const int row0 = (w / q_tiles) * RB;
        dtile::issue_rows(stage + (i % STAGES) * stage_floats,
                   A + static_cast<size_t>(row0) * d,
                   min(RB, N - row0) * d, &full[i % STAGES]);
    };
    if (BULK && tid == 0)
        for (int i = 0; i < STAGES && blockIdx.x + i * gridDim.x < tiles; ++i)
            issue(i);

    int cur_qt = -1;
    int i = 0;
    for (int w = blockIdx.x; w < tiles; w += gridDim.x, ++i) {
        const int rt = w / q_tiles, qt = w - rt * q_tiles;
        const int row0 = rt * RB, rows = min(RB, N - row0), q0 = qt * QB;
        // a new query tile (every thread sees the same qt); the last
        // reads of c_t and cn_s ended before the last epilogue's barriers
        if (qt != cur_qt) {
            dtile::query_norms(cn_s, C, q0, K, d);
            if (BULK) dtile::stage_queries(c_t, C, q0, K, d, 0, d);
            cur_qt = qt;
        }
        float acc[TQ][TR];
        if (BULK) {
            const float* a_s = stage + (i % STAGES) * stage_floats;
            hop::mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
            float s = dtile::half_norm(a_s, d, 1, d);
            s += __shfl_xor_sync(dtile::FULL, s, 1);
            if ((tid & 1) == 0) an_s[tid >> 1] = s;
            __syncthreads();   // an_s, and a new c_t and cn_s, are set
#pragma unroll
            for (int qi = 0; qi < TQ; ++qi)
#pragma unroll
                for (int ri = 0; ri < TR; ++ri)
                    acc[qi][ri] = an_s[dtile::slot(tr, ri)] +
                                  cn_s[dtile::slot(tq, qi)];
            dtile::dots<true>(a_s, d, c_t, d, tq, tr, acc);
        } else {
            float s = 0.f;
            for (int c0 = 0; c0 < d; c0 += DC) {
                const int dc = min(DC, d - c0);
                if (c0 > 0) __syncthreads();
                dtile::stage_rows(stage, A, row0, rows, d, c0, dc);
                dtile::stage_queries(c_t, C, q0, K, d, c0, dc);
                __syncthreads();
                if (c0 == 0) {
#pragma unroll
                    for (int qi = 0; qi < TQ; ++qi)
#pragma unroll
                        for (int ri = 0; ri < TR; ++ri)
                            acc[qi][ri] = cn_s[dtile::slot(tq, qi)];
                }
                s += dtile::half_norm(stage, PSTRIDE, 1, dc);
                dtile::dots<true>(stage, PSTRIDE, c_t, dc, tq, tr, acc);
            }
            s += __shfl_xor_sync(dtile::FULL, s, 1);
            if ((tid & 1) == 0) an_s[tid >> 1] = s;
            __syncthreads();
#pragma unroll
            for (int qi = 0; qi < TQ; ++qi)
#pragma unroll
                for (int ri = 0; ri < TR; ++ri)
                    acc[qi][ri] += an_s[dtile::slot(tr, ri)];
        }
        // the epilogue's first barrier also ends every read of this tile's
        // stage, c_t, cn_s and an_s
        if (A_FAST)
            epilogue<true, TMA>(acc, out_s, E, &tm_e, pitch, q0, K, row0,
                                  rows, tf, ts);
        else
            epilogue<false, TMA>(acc, out_s, E, &tm_e, pitch, row0, N, q0,
                                   min(QB, K - q0), tf, ts);
        if (BULK && tid == 0 && w + STAGES * gridDim.x < tiles)
            issue(i + STAGES);
    }
    if (TMA && tid == 0) hop::bulk_wait<0>();
}

template <bool BULK, bool A_FAST, bool TMA>
cudaError_t launch(const float* A, const float* C, float* E,
                   const CUtensorMap& tm_e, int N, int K, int d, int tiles,
                   int grid, cudaStream_t s) {
    const size_t bytes = layout(BULK, d).total;
    static size_t allowed = 48 * 1024;   // the dynamic size allowed so far
    if (bytes > allowed) {
        auto* kernel = pairwise_kernel<BULK, A_FAST, TMA>;
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes));
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return err;
        allowed = bytes;
    }
    pairwise_kernel<BULK, A_FAST, TMA><<<grid, THREADS, bytes, s>>>(
        A, C, E, tm_e, N, K, d, tiles);
    return cudaGetLastError();
}

template <bool BULK, bool A_FAST>
cudaError_t launch_store(bool tma, const float* A, const float* C, float* E,
                         const CUtensorMap& tm_e, int N, int K, int d,
                         int tiles, int grid, cudaStream_t s) {
    return tma ? launch<BULK, A_FAST, true>(A, C, E, tm_e, N, K, d, tiles,
                                            grid, s)
               : launch<BULK, A_FAST, false>(A, C, E, tm_e, N, K, d, tiles,
                                             grid, s);
}

}  // namespace

extern "C" {

int pairwise_bulk_max_d() { return BULK_MAX_D; }
int pairwise_tile() { return RB; }

// A (N, d), C (K, d) fp32 row-major -> E: (N, K) row-major, or (K, N)
// row-major when a_fast != 0.  bulk: 1 for the bulk route (A 16-byte
// aligned, d <= BULK_MAX_D), 0 for the plain route.  ``grid`` persistent
// blocks walk the 128 x 128 tiles; the tiles are stored by TMA where E
// and its pitch are 16-byte aligned, else element by element.  Returns
// the first CUDA error.
int pairwise_sq_dist_f32(const float* A, const float* C, float* E, int N,
                         int K, int d, int a_fast, int bulk, int grid,
                         void* stream) {
    const long long tiles = static_cast<long long>((N + RB - 1) / RB) *
                            ((K + QB - 1) / QB);
    const long long pitch = a_fast ? N : K;
    const bool tma = pitch % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(E) % 16 == 0;
    if (N < 1 || K < 1 || d < 1 || grid < 1 || tiles > INT_MAX ||
        (bulk && (d > BULK_MAX_D ||
                  reinterpret_cast<uintptr_t>(A) % 16 != 0)))
        return static_cast<int>(cudaErrorInvalidValue);
    // the tma store: a map of E, lines of 128 along its contiguous axis,
    // 64 lines a box (a half of a tile)
    CUtensorMap tm_e{};
    if (tma) {
        const uint64_t dims[2] = {static_cast<uint64_t>(a_fast ? N : K),
                                  static_cast<uint64_t>(a_fast ? K : N)};
        const uint64_t strides[1] = {static_cast<uint64_t>(pitch) * 4};
        const uint32_t box[2] = {LINE, HALF};
        if (!hop::tensor_map<2>(&tm_e, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, E,
                                dims, strides, box,
                                CU_TENSOR_MAP_SWIZZLE_NONE))
            return static_cast<int>(cudaErrorInvalidValue);
    }
    const int n = static_cast<int>(tiles);
    grid = grid < n ? grid : n;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (bulk)
        err = a_fast ? launch_store<true, true>(tma, A, C, E, tm_e, N, K, d,
                                                n, grid, s)
                     : launch_store<true, false>(tma, A, C, E, tm_e, N, K,
                                                 d, n, grid, s);
    else
        err = a_fast ? launch_store<false, true>(tma, A, C, E, tm_e, N, K,
                                                 d, n, grid, s)
                     : launch_store<false, false>(tma, A, C, E, tm_e, N, K,
                                                  d, n, grid, s);
    return static_cast<int>(err);
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
