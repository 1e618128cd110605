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
// in exact int32 arithmetic: __dp4a takes four int8 products a cycle and
// sums them into an int32, and for d <= 832 every sum stays far inside
// int32 (4 * 832 * 127^2 < 2^26).  So both kernels are bit-equal to the
// plain versions, whatever order they sum in.  The TPU kernels fed the
// int8 operands to the f32 matrix unit, offset the distance by OFF, left a
// norm to be restored outside and packed (distance, lane) into one int32
// key; none of that is needed here.  Ranking by (distance, row) gives the
// same order and the same ties.  d <= 832 stays the wrappers' contract,
// as in the reference.
//
// Rows are int8 with a stride of d bytes, so a row is not 4-byte aligned
// in general (d = 21).  The kernels stage rows in shared memory as 4-byte
// words, zero-padded past d; zero lanes add nothing to a dot product or a
// norm.
//
// What bounds them on an H100: operations.  At the kNN serving shape
// (N = 2^20 rows, Q = 1024 queries, d = 21) B6 does 2*N*Q*d = 45 G integer
// operations against 22 MB of A.  Against the int8 tensor-core peak that is
// 0.023 ms; these kernels use the CUDA cores' dp4a, a rate far below the
// tensor cores' (int8 mma/wgmma is work for a later change).
//
// What the design does about it:
//  * B6, k <= TOPK_K_MAX: B1's structure (csrc/distance_topk.cu).  N is
//    split across blocks; a block takes 32 queries (one per lane) and a
//    range of rows, stages 64-row tiles of A as words in shared memory and
//    register-blocks 8 rows per thread, so a row word is a shared-memory
//    broadcast to the warp.  Each thread keeps a sorted (distance, row)
//    list of its k best, and a second kernel merges the n_splits * 8
//    partial lists of each query on the (distance, row) rule.
//  * B6, larger k: the reference takes every 1 <= k <= N.  For k past the
//    lists the wrapper has this file write the int32 (Q, N) lattice matrix,
//    one query per row so B5 reads rows contiguously, in chunks of queries
//    that bound its bytes; B5 (csrc/topk_select.cu) then selects in its
//    int32 key mode.  The matrix tile puts rows on the lanes, so the
//    stores of a warp are contiguous.
//  * B7: one row per thread; centroids are staged in shared memory in tiles
//    of 32 (so any K fits) and read as broadcasts into 32 running dot
//    products in registers.  The scan compares (distance, column) with
//    strict < in ascending column order: the first index wins ties, so the
//    reference's packed/unpacked fork is not needed.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int TOPK_K_MAX = 32;  // longest per-query list a thread keeps
constexpr int QT = 32;          // queries per block, one per lane
constexpr int RL = 8;           // row lanes (warps) per block
constexpr int RPT = 8;          // rows per thread in a tile
constexpr int TILE_ROWS = RL * RPT;
constexpr int WC = 16;          // 4-byte feature words staged per chunk
constexpr int MERGE_THREADS = 256;
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

// (distance, row) order; the empty slot (INT_MAX, INT_MAX) ranks after
// every real row, whose distance is below INT_MAX
__device__ __forceinline__ bool rank_less(int v, int i, int w, int j) {
    return v < w || (v == w && i < j);
}

__global__ void __launch_bounds__(QT * RL)
q8_topk_partial_kernel(const int8_t* __restrict__ A,
                       const int8_t* __restrict__ C, int* __restrict__ part_v,
                       int* __restrict__ part_i, int N, int Q, int d, int k,
                       int rows_per_split) {
    __shared__ int a_s[TILE_ROWS][WC + 1];
    __shared__ int c_s[WC][QT + 1];
    __shared__ int an_s[TILE_ROWS];

    const int lane = threadIdx.x;
    const int rl = threadIdx.y;
    const int tid = rl * QT + lane;
    const int q = blockIdx.y * QT + lane;
    const bool q_ok = q < Q;
    const int row_lo = blockIdx.x * rows_per_split;
    const int row_hi = min(N, row_lo + rows_per_split);
    const int dw = (d + 3) / 4;
    const int nchunks = (dw + WC - 1) / WC;

    int cn = 0;  // this lane's query norm
    if (q_ok) {
        for (int j = 0; j < d; ++j) {
            const int v = C[(size_t)q * d + j];
            cn += v * v;
        }
    }

    int tv[TOPK_K_MAX];
    int ti[TOPK_K_MAX];
    for (int r = 0; r < TOPK_K_MAX; ++r) {
        tv[r] = INT_MAX;
        ti[r] = INT_MAX;
    }
    int worst = INT_MAX, worst_i = INT_MAX;

    for (int row0 = row_lo; row0 < row_hi; row0 += TILE_ROWS) {
        int acc[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[r] = 0;
        int an_part = 0;
        for (int ch = 0; ch < nchunks; ++ch) {
            const int w0 = ch * WC;
            const int wc = min(WC, dw - w0);
            __syncthreads();  // every thread is done with the last tile
            for (int e = tid; e < TILE_ROWS * WC; e += QT * RL) {
                const int r = e / WC, w = e % WC;
                const int row = row0 + r;
                a_s[r][w] = (row < row_hi && w < wc)
                    ? row_word(A + (size_t)row * d, 4 * (w0 + w), d) : 0;
            }
            if (nchunks > 1 || row0 == row_lo) {  // queries: once if small d
                for (int e = tid; e < QT * WC; e += QT * RL) {
                    const int qq = e / WC, w = e % WC;
                    const int qg = blockIdx.y * QT + qq;
                    c_s[w][qq] = (qg < Q && w < wc)
                        ? row_word(C + (size_t)qg * d, 4 * (w0 + w), d) : 0;
                }
            }
            __syncthreads();
            if (tid < TILE_ROWS) {
                for (int w = 0; w < wc; ++w)
                    an_part = __dp4a(a_s[tid][w], a_s[tid][w], an_part);
            }
            for (int w = 0; w < wc; ++w) {
                const int cw = c_s[w][lane];
#pragma unroll
                for (int r = 0; r < RPT; ++r)
                    acc[r] = __dp4a(a_s[rl * RPT + r][w], cw, acc[r]);
            }
        }
        if (tid < TILE_ROWS) an_s[tid] = an_part;
        __syncthreads();
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            const int row = row0 + rl * RPT + r;
            const int dist = an_s[rl * RPT + r] - 2 * acc[r] + cn;
            if (row < row_hi && rank_less(dist, row, worst, worst_i)) {
                int p = k - 1;
                while (p > 0 && rank_less(dist, row, tv[p - 1], ti[p - 1])) {
                    tv[p] = tv[p - 1];
                    ti[p] = ti[p - 1];
                    --p;
                }
                tv[p] = dist;
                ti[p] = row;
                worst = tv[k - 1];
                worst_i = ti[k - 1];
            }
        }
    }

    if (q_ok) {
        const int n_lists = gridDim.x * RL;
        const size_t base = ((size_t)q * n_lists + blockIdx.x * RL + rl) * k;
        for (int r = 0; r < k; ++r) {
            part_v[base + r] = tv[r];
            part_i[base + r] = ti[r];
        }
    }
}

// One block per query: k rounds, each taking the smallest (distance, row)
// strictly after the previous pick.  Rows are unique across the lists and
// k <= N real rows rank before the empty slots.
__global__ void __launch_bounds__(MERGE_THREADS)
q8_topk_merge_kernel(const int* __restrict__ part_v,
                     const int* __restrict__ part_i, int* __restrict__ vals,
                     int* __restrict__ idx, int n_cand, int k) {
    __shared__ int wv[MERGE_THREADS / 32];
    __shared__ int wi[MERGE_THREADS / 32];
    __shared__ int prev_v, prev_i;
    const int q = blockIdx.x;
    const int* v = part_v + (size_t)q * n_cand;
    const int* ix = part_i + (size_t)q * n_cand;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
        prev_v = INT_MIN;
        prev_i = INT_MIN;
    }
    __syncthreads();
    for (int r = 0; r < k; ++r) {
        const int pv = prev_v, pi = prev_i;
        int bv = INT_MAX, bi = INT_MAX;
        for (int t = threadIdx.x; t < n_cand; t += MERGE_THREADS) {
            const int cv = v[t], ci = ix[t];
            if (rank_less(pv, pi, cv, ci) && rank_less(cv, ci, bv, bi)) {
                bv = cv;
                bi = ci;
            }
        }
        for (int off = 16; off > 0; off >>= 1) {
            const int ov = __shfl_down_sync(0xffffffffu, bv, off);
            const int oi = __shfl_down_sync(0xffffffffu, bi, off);
            if (rank_less(ov, oi, bv, bi)) {
                bv = ov;
                bi = oi;
            }
        }
        if (lane == 0) {
            wv[warp] = bv;
            wi[warp] = bi;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            bv = wv[0];
            bi = wi[0];
            for (int w = 1; w < MERGE_THREADS / 32; ++w) {
                if (rank_less(wv[w], wi[w], bv, bi)) {
                    bv = wv[w];
                    bi = wi[w];
                }
            }
            vals[(size_t)q * k + r] = bv;
            idx[(size_t)q * k + r] = bi;
            prev_v = bv;
            prev_i = bi;
        }
        __syncthreads();
    }
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
int q8_lists_per_split() { return RL; }
int q8_tile_rows() { return TILE_ROWS; }
int q8_max_d() { return MAX_D; }

// A (N, d), C (Q, d) int8 row-major; part_v/part_i scratch of
// Q * n_splits * RL * k; vals/idx (Q, k) int32.  Returns the first CUDA
// error.
int distance_topk_q8(const int8_t* A, const int8_t* C, int* part_v,
                     int* part_i, int* vals, int* idx, int N, int Q, int d,
                     int k, int n_splits, int rows_per_split, void* stream) {
    if (k < 1 || k > TOPK_K_MAX || k > N || Q < 1 || N < 1 || d < 1 ||
        d > MAX_D || n_splits < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(n_splits, (Q + QT - 1) / QT);
    q8_topk_partial_kernel<<<grid, dim3(QT, RL), 0, s>>>(
        A, C, part_v, part_i, N, Q, d, k, rows_per_split);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    q8_topk_merge_kernel<<<Q, MERGE_THREADS, 0, s>>>(
        part_v, part_i, vals, idx, n_splits * RL * k, k);
    return (int)cudaGetLastError();
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
