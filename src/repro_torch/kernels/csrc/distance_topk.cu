// Fused squared distance -> nearest rows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel B1 of the JAX package:
//   kernels/distance_topk.py::_fused_kernel (distance_topk, kNN OP1+OP2).
// (B2, the same file's _argmin_kernel, is csrc/distance_argmin.cu.)
//
// B1 scores rows of A against queries with the expansion
// ||a||^2 - 2 a.c + ||c||^2 in fp32 on the CUDA cores.  TF32 tensor cores
// are not used: they keep ~10 mantissa bits, which reorders near neighbours.
//
// What bounds it on an H100: fp32 CUDA-core throughput.  At the kNN
// serving shape (N = 2^20 rows, Q = 1024 queries, d = 21) B1 does
// 2*N*Q*d = 45 GFLOP against 88 MB of A, ~510 flop per byte, far above the
// card's ~20 flop/byte fp32 ridge.
//
// B1's design.  The TPU walks N as one sequential grid with a carried
// (Q, k) accumulator.  Here a block takes QB = 128 queries and a split of
// the rows (the grid is splits x query tiles, about two blocks an SM), and
// a second kernel merges the splits' lists of each query.
//  * Arithmetic: each of the 256 threads computes an 8-query x 8-row
//    micro-tile.  Per feature it loads its 8 query values as two float4
//    (the queries sit transposed in shared memory, scaled by -2) and 8 row
//    values, and issues 64 FMAs: 6.4 FMAs a shared load, against 0.9 in
//    the per-lane list design this replaces, whose inner loop the load
//    unit bounded.  The sum starts from ||a||^2 + ||c||^2, so after the
//    last feature it is the distance.  The order of these operations is
//    csrc/distance_tile.cuh's, which B4 shares, so that the blocked arm's
//    distances are these bit for bit.  The feature loop is not unrolled:
//    with 64 accumulators the registers of a deeper unroll spill at the
//    two blocks an SM that hide the loads' latency.
//  * Staging (the bulk route): rows are contiguous, so a 128-row tile is
//    one span of 512*d bytes.  One thread copies it into a ring of three
//    shared-memory stages with a 1-D bulk asynchronous copy
//    (hop::bulk_load_1d) that completes an mbarrier; the copies of the
//    next two tiles run under the current tile's arithmetic.  Tiled TMA
//    cannot be used: a tensor map needs 16-byte global strides and a row
//    of d = 21 floats is 84 bytes.  The row norms come from the staged
//    tile, two threads a row, all rows at once.
//  * Selection: csrc/block_select.cuh, one list per query per block.  A
//    thread reads its queries' thresholds once a tile, ors the compares of
//    a push group (one branch for 16 candidates) and queues every
//    candidate whose value is not above its query's threshold with one
//    shared atomic; the merge settles ties and NaN.  Rows are arranged so
//    that a query takes at most 32 candidates in one push group (two of a
//    thread's eight rows, 16 threads a query); after each group the block
//    merges early if any queue holds more than bsel::FILL, so a queue
//    (bsel::QCAP slots) never overflows and no candidate is dropped.
//    The merge kernel reads n_splits * k candidates a query.
//  * What bounds it: the CUDA cores' FMA issue in the dot products, then
//    the selection's queue traffic while the thresholds are still loose
//    (the first tiles of a block, or rows in an order that keeps every
//    row ahead of the threshold).
//  * Order: ascending by (value, row), ties to the smallest row, a NaN
//    distance (a NaN or Inf in a query or row) after every number, every
//    index a real row of A; k <= TOPK_K_MAX.
//  * The alignment rule (routes, counted by the wrapper): the bulk route
//    needs A's base 16-byte aligned and d <= BULK_MAX_D (three stages of
//    128 rows stay within 48 KB); rows_per_split is a multiple of 32, so
//    every tile starts 16-byte aligned.  The last tile's span may end off
//    a 16-byte multiple: the bulk copy takes its 16-byte part and the
//    copying thread loads the last (rows*d) % 4 floats itself before it
//    arrives on the barrier.  Any other A (a view such as A[1:], or
//    d > BULK_MAX_D) takes the plain route: the block loads 32-feature
//    chunks of each tile with element loads into one buffer, between
//    barriers, and adds the row norms after the last chunk.  Both routes
//    share the arithmetic and the selection.
//  * Tenants (the grouped launch of a multi-tenant model group): G
//    same-shape tenants, A (G, N, d) against queries (G, Q, d), run as one
//    launch with the tenant on blockIdx.z; a block offsets A, C and its
//    split lists to its tenant and is otherwise the G = 1 block, and the
//    merge kernel takes the G Q queries as one run of lists.  A tenant's
//    values come from the same operations in the same order as its own
//    G = 1 launch, and the (value, row) order of the selection does not
//    depend on the splits, so a lane is bit-equal to that launch.  The bulk
//    route needs every tenant's base 16-byte aligned (N d a multiple of 4
//    or G = 1); else the plain route runs, and on it a tenant whose base is
//    aligned with d <= BULK_MAX_D (where its own launch takes the bulk
//    route) sums in the bulk route's order: its norms before the dot
//    products, the distance from ||a||^2 + ||c||^2.  The tenant code is a
//    template parameter: a G = 1 launch runs the kernel without it, as
//    before the axis was added.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

#include "block_select.cuh"
#include "distance_tile.cuh"
#include "hopper.cuh"

namespace {

using bsel::QB;
using bsel::RB;
using bsel::THREADS;

constexpr int TOPK_K_MAX = bsel::K_MAX;
constexpr int BULK_MAX_D = 32;   // widest row the bulk route stages whole
constexpr int STAGES = 3;        // bulk route: tiles in flight
using dtile::DC;                 // plain route: features of a chunk
using dtile::PSTRIDE;            // plain route: padded row of a chunk
using dtile::TQ;                 // queries of a thread
using dtile::TR;                 // rows of a thread: tr + 16 i
static_assert(dtile::QB == QB && dtile::RB == RB &&
              dtile::THREADS == THREADS, "B1's tile is distance_tile.cuh's");

struct F32Layout {
    size_t stage_bytes, c_t, cn, an, lists, bars, total;
};

// byte offsets of B1's dynamic shared memory (host and device agree)
__host__ __device__ inline F32Layout f32_layout(bool bulk, int d, int k) {
    F32Layout L{};
    const int floats = bulk ? RB * d : RB * PSTRIDE;
    L.stage_bytes = (static_cast<size_t>(floats) * 4 + 127) & ~size_t{127};
    size_t off = L.stage_bytes * (bulk ? STAGES : 1);
    L.c_t = off;
    off += bsel::align16(static_cast<size_t>(d < DC ? d : DC) * QB * 4);
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

template <bool BULK, bool TENANTS>
__global__ void __launch_bounds__(THREADS, 2)
topk_partial_kernel(const float* __restrict__ A, const float* __restrict__ C,
                    float* __restrict__ part_v, int* __restrict__ part_i,
                    int N, int Q, int d, int k, int rows_per_split) {
    extern __shared__ __align__(128) unsigned char smem[];
    const F32Layout lay = f32_layout(BULK, d, k);
    if (TENANTS) {   // the tenant's operands
        const size_t g = blockIdx.z;
        A += g * N * d;
        C += g * Q * d;
        part_v += g * Q * gridDim.x * k;
        part_i += g * Q * gridDim.x * k;
    }
    // the plain route in the bulk route's order: a tenant of a grouped
    // launch whose own launch would take the bulk route (never at G = 1,
    // whose plain route is for unaligned rows or d > BULK_MAX_D)
    const bool bulk_order = TENANTS && !BULK && d <= BULK_MAX_D &&
                            reinterpret_cast<uintptr_t>(A) % 16 == 0;
    float* stage = reinterpret_cast<float*>(smem);
    float* c_t = reinterpret_cast<float*>(smem + lay.c_t);
    float* cn_s = reinterpret_cast<float*>(smem + lay.cn);
    float* an_s = reinterpret_cast<float*>(smem + lay.an);
    const bsel::Lists<float> L = bsel::carve<float>(smem + lay.lists, k);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
    const int stage_floats = static_cast<int>(lay.stage_bytes / 4);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // a warp covers 8 query groups x 4 row groups
    const int tq = (warp & 1) * 8 + (lane & 7);
    const int tr = (warp >> 1) * 4 + (lane >> 3);
    const int split = blockIdx.x, q0 = blockIdx.y * QB;
    const int row_lo = split * rows_per_split;
    const int row_hi = min(N, row_lo + rows_per_split);
    const int n_tiles = (row_hi - row_lo + RB - 1) / RB;
    const int nch = BULK ? 1 : (d + DC - 1) / DC;

    bsel::init(L);
    dtile::query_norms(cn_s, C, q0, Q, d);
    if (nch == 1) dtile::stage_queries(c_t, C, q0, Q, d, 0, d);
    if (BULK && tid == 0) {
        for (int s = 0; s < STAGES; ++s) hop::mbar_init(&full[s], 1);
        hop::fence_barrier_init();
    }
    __syncthreads();

    auto issue = [&](int t) {   // tile t into stage t % STAGES
        const int row0 = row_lo + t * RB;
        dtile::issue_rows(stage + (t % STAGES) * stage_floats,
                   A + static_cast<size_t>(row0) * d,
                   min(RB, row_hi - row0) * d, &full[t % STAGES]);
    };
    if (BULK && tid == 0)
        for (int t = 0; t < STAGES && t < n_tiles; ++t) issue(t);

    bool flag = false;   // a queue this thread pushed to passed FILL
    auto sync_merge = [&]() {   // true if the block merged
        const bool merged = __syncthreads_or(flag);
        if (merged) {
            bsel::merge(L);
            __syncthreads();
        }
        flag = false;
        return merged;
    };

    for (int t = 0; t < n_tiles; ++t) {
        const int row0 = row_lo + t * RB;
        const int rows = min(RB, row_hi - row0);
        if (t > 0) {
            sync_merge();   // also: every thread is done with tile t - 1
            if (BULK && tid == 0 && t - 1 + STAGES < n_tiles)
                issue(t - 1 + STAGES);
        }
        float acc[TQ][TR];
        if (BULK) {
            const float* a_s = stage + (t % STAGES) * stage_floats;
            hop::mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
            float s = dtile::half_norm(a_s, d, 1, d);
            s += __shfl_xor_sync(bsel::FULL, s, 1);
            if ((tid & 1) == 0) an_s[tid >> 1] = s;
            __syncthreads();
#pragma unroll
            for (int qi = 0; qi < TQ; ++qi)
#pragma unroll
                for (int ri = 0; ri < TR; ++ri)
                    acc[qi][ri] = an_s[tr + 16 * ri] + cn_s[dtile::slot(tq, qi)];
            dtile::dots<false>(a_s, d, c_t, d, tq, tr, acc);
        } else if (bulk_order) {   // one chunk: d <= BULK_MAX_D = DC
            dtile::stage_rows(stage, A, row0, rows, d, 0, d);
            __syncthreads();
            float s = dtile::half_norm(stage, PSTRIDE, 1, d);
            s += __shfl_xor_sync(bsel::FULL, s, 1);
            if ((tid & 1) == 0) an_s[tid >> 1] = s;
            __syncthreads();
#pragma unroll
            for (int qi = 0; qi < TQ; ++qi)
#pragma unroll
                for (int ri = 0; ri < TR; ++ri)
                    acc[qi][ri] = an_s[tr + 16 * ri] + cn_s[dtile::slot(tq, qi)];
            dtile::dots<false>(stage, PSTRIDE, c_t, d, tq, tr, acc);
        } else {
#pragma unroll
            for (int qi = 0; qi < TQ; ++qi)
#pragma unroll
                for (int ri = 0; ri < TR; ++ri)
                    acc[qi][ri] = cn_s[dtile::slot(tq, qi)];
            float s = 0.f;
            for (int ch = 0; ch < nch; ++ch) {
                const int c0 = ch * DC, dc = min(DC, d - c0);
                if (ch > 0) __syncthreads();
                dtile::stage_rows(stage, A, row0, rows, d, c0, dc);
                if (nch > 1) dtile::stage_queries(c_t, C, q0, Q, d, c0, dc);
                __syncthreads();
                s += dtile::half_norm(stage, PSTRIDE, 1, dc);
                dtile::dots<false>(stage, PSTRIDE, c_t, dc, tq, tr, acc);
            }
            s += __shfl_xor_sync(bsel::FULL, s, 1);
            if ((tid & 1) == 0) an_s[tid >> 1] = s;
            __syncthreads();
#pragma unroll
            for (int qi = 0; qi < TQ; ++qi)
#pragma unroll
                for (int ri = 0; ri < TR; ++ri)
                    acc[qi][ri] += an_s[tr + 16 * ri];
        }
        // the thresholds of the thread's queries, read here so that they
        // take no registers across the dot products (-inf past Q, which
        // only a NaN distance passes, to be dropped by the q0 + ql < Q test)
        float tau[TQ];
        auto load_tau = [&]() {
#pragma unroll
            for (int qi = 0; qi < TQ; ++qi)
                tau[qi] = q0 + dtile::slot(tq, qi) < Q
                    ? L.threshold(dtile::slot(tq, qi)) : -CUDART_INF_F;
        };
        load_tau();
        // four push groups of two rows each: at most 32 candidates a query.
        // One branch a group: the 16 compares are or-ed first.
#pragma unroll
        for (int g = 0; g < TR / 2; ++g) {
            if (g > 0 && sync_merge()) load_tau();
            bool any = false;
#pragma unroll
            for (int ri = 2 * g; ri < 2 * g + 2; ++ri)
#pragma unroll
                for (int qi = 0; qi < TQ; ++qi)
                    any |= !(acc[qi][ri] > tau[qi]);
            if (any) {
#pragma unroll
                for (int ri = 2 * g; ri < 2 * g + 2; ++ri) {
                    const int rl = tr + 16 * ri;
#pragma unroll
                    for (int qi = 0; qi < TQ; ++qi)
                        if (rl < rows && q0 + dtile::slot(tq, qi) < Q &&
                            !(acc[qi][ri] > tau[qi]))
                            flag |= bsel::queue(L, dtile::slot(tq, qi), acc[qi][ri],
                                                row0 + rl);
                }
            }
        }
    }
    __syncthreads();
    bsel::merge(L);
    __syncthreads();
    bsel::write_lists(L, part_v, part_i, q0, Q, split, gridDim.x);
}

template <bool BULK, bool TENANTS>
cudaError_t launch_partial_t(const float* A, const float* C,
                             float* part_v, int* part_i, int N, int Q, int d,
                             int k, int n_splits, int rows_per_split, int G,
                             cudaStream_t s) {
    const size_t bytes = f32_layout(BULK, d, k).total;
    static size_t allowed = 48 * 1024;   // the dynamic size allowed so far
    if (bytes > allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            topk_partial_kernel<BULK, TENANTS>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes));
        if (err != cudaSuccess) return err;
        allowed = bytes;
    }
    const dim3 grid(n_splits, (Q + QB - 1) / QB, G);
    topk_partial_kernel<BULK, TENANTS><<<grid, THREADS, bytes, s>>>(
        A, C, part_v, part_i, N, Q, d, k, rows_per_split);
    return cudaGetLastError();
}

template <bool BULK>
cudaError_t launch_partial(const float* A, const float* C, float* part_v,
                           int* part_i, int N, int Q, int d, int k,
                           int n_splits, int rows_per_split, int G,
                           cudaStream_t s) {
    return G > 1
        ? launch_partial_t<BULK, true>(A, C, part_v, part_i, N, Q, d, k,
                                       n_splits, rows_per_split, G, s)
        : launch_partial_t<BULK, false>(A, C, part_v, part_i, N, Q, d, k,
                                        n_splits, rows_per_split, G, s);
}

}  // namespace

extern "C" {

int distance_topk_k_max() { return TOPK_K_MAX; }
int distance_topk_query_tile() { return QB; }
int distance_topk_tile_rows() { return RB; }
int distance_topk_bulk_max_d() { return BULK_MAX_D; }

// A (G, N, d), C (G, Q, d) fp32 row-major, G tenants (G = 1: one model);
// part_v/part_i scratch of G * Q * n_splits * k; vals/idx (G, Q, k).  bulk:
// 1 for the bulk route (every tenant's A 16-byte aligned, d <= BULK_MAX_D),
// 0 for the plain route.  The splits must cover N with none empty, in
// multiples of 32 rows.  Returns the first CUDA error.
int distance_topk_f32(const float* A, const float* C, float* part_v,
                      int* part_i, float* vals, int* idx, int N, int Q, int d,
                      int k, int n_splits, int rows_per_split, int bulk,
                      int G, void* stream) {
    if (k < 1 || k > TOPK_K_MAX || Q < 1 || N < 1 || d < 1 || n_splits < 1 ||
        G < 1 || G > 65535 ||
        rows_per_split < 1 || rows_per_split % 32 ||
        static_cast<long long>(n_splits - 1) * rows_per_split >= N ||
        static_cast<long long>(n_splits) * rows_per_split < N ||
        (bulk && (d > BULK_MAX_D ||
                  reinterpret_cast<uintptr_t>(A) % 16 != 0 ||
                  (G > 1 && (static_cast<long long>(N) * d) % 4 != 0))))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = bulk
        ? launch_partial<true>(A, C, part_v, part_i, N, Q, d, k, n_splits,
                               rows_per_split, G, s)
        : launch_partial<false>(A, C, part_v, part_i, N, Q, d, k, n_splits,
                                rows_per_split, G, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    // the G tenants' Q queries are one run of G Q lists
    const int per_block = bsel::MERGE_THREADS / 32;
    const long long GQ = static_cast<long long>(G) * Q;
    bsel::merge_splits_kernel<float>
        <<<static_cast<int>((GQ + per_block - 1) / per_block),
           bsel::MERGE_THREADS, 0, s>>>(part_v, part_i, vals, idx,
                                        static_cast<int>(GQ), n_splits * k, k);
    return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
