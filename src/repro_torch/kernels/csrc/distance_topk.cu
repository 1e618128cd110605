// Fused squared distance -> nearest rows, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   B1  kernels/distance_topk.py::_fused_kernel  (distance_topk, kNN OP1+OP2)
//   B2  kernels/distance_topk.py::_argmin_kernel (distance_argmin, K-Means
//       OP1+OP2, Selection Sort with k = 1)
//
// Both score rows of A against queries/centroids with the expansion
// ||a||^2 - 2 a.c + ||c||^2 in fp32 on the CUDA cores.  TF32 tensor cores
// are not used: they keep ~10 mantissa bits, which reorders near neighbours.
//
// What bounds them on an H100: fp32 CUDA-core throughput.  At the kNN
// serving shape (N = 2^20 rows, Q = 1024 queries, d = 21) B1 does
// 2*N*Q*d = 45 GFLOP against 88 MB of A, ~510 flop per byte, far above the
// card's ~20 flop/byte fp32 ridge; B2 at the K-Means fit shape (N = 262144,
// K = 256, d = 21) does 2.8 GFLOP against 22 MB, ~128 flop per byte.
//
// What the design does about it:
//  * B1: the TPU walks N as one sequential grid with a carried (Q, k)
//    accumulator, which on this card would occupy one SM.  Here N is split
//    across blocks.  A block takes 32 queries (one per lane) and a range of
//    rows, stages 64-row x 32-feature tiles of A in shared memory and
//    register-blocks 8 rows per thread, so each row value is a shared-memory
//    broadcast to the warp.  Each thread keeps a sorted (value, row) list of
//    its k best; after the first few tiles an insertion is rare, so the list
//    costs one compare per row.  A second small kernel merges the
//    n_splits * 8 partial lists of each query by (value, global row), the
//    rule of core/cluster.py::_butterfly_topk_merge, so ties go to the
//    smallest row as in the reference.  A NaN distance (a NaN or Inf in a
//    query or row) ranks after every number, as a stable sort puts it
//    last, so every output is a real row of A.  Rows past N are masked in
//    the kernel; nothing is padded.  k is limited to TOPK_K_MAX.
//  * B2: one row per thread; centroids are staged in shared memory in tiles
//    of 32 (so any K*d fits) and read as float4 broadcasts into 32 running
//    dot products held in registers.  The scan uses strict < in ascending
//    centroid order: the first index wins ties.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

namespace {

constexpr int TOPK_K_MAX = 32;  // longest per-query list a thread keeps
constexpr int QT = 32;          // queries per block, one per lane
constexpr int RL = 8;           // row lanes (warps) per block
constexpr int RPT = 8;          // rows per thread in a tile
constexpr int TILE_ROWS = RL * RPT;
constexpr int DC = 32;          // features staged per chunk
constexpr int MERGE_THREADS = 256;

// (value, row) order: NaN after every number, equal values (NaN with NaN
// too) to the smaller row.  The empty slot (NaN, INT_MAX) ranks after
// every real row.
__device__ __forceinline__ bool rank_less(float v, int i, float w, int j) {
    const bool vn = v != v, wn = w != w;
    if (vn || wn) return vn ? (wn && i < j) : true;
    return v < w || (v == w && i < j);
}

__global__ void __launch_bounds__(QT * RL)
topk_partial_kernel(const float* __restrict__ A, const float* __restrict__ C,
                    float* __restrict__ part_v, int* __restrict__ part_i,
                    int N, int Q, int d, int k, int rows_per_split) {
    __shared__ float a_s[TILE_ROWS][DC + 1];
    __shared__ float c_s[DC][QT + 1];
    __shared__ float an_s[TILE_ROWS];

    const int lane = threadIdx.x;
    const int rl = threadIdx.y;
    const int tid = rl * QT + lane;
    const int q = blockIdx.y * QT + lane;
    const bool q_ok = q < Q;
    const int row_lo = blockIdx.x * rows_per_split;
    const int row_hi = min(N, row_lo + rows_per_split);
    const int nchunks = (d + DC - 1) / DC;

    float cn = 0.f;  // this lane's query norm, read once from global memory
    if (q_ok) {
        for (int j = 0; j < d; ++j) {
            const float v = C[(size_t)q * d + j];
            cn += v * v;
        }
    }

    float tv[TOPK_K_MAX];
    int ti[TOPK_K_MAX];
    for (int r = 0; r < TOPK_K_MAX; ++r) {
        tv[r] = CUDART_NAN_F;
        ti[r] = INT_MAX;
    }
    float worst = CUDART_NAN_F;
    int worst_i = INT_MAX;

    for (int row0 = row_lo; row0 < row_hi; row0 += TILE_ROWS) {
        float acc[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
        float an_part = 0.f;
        for (int ch = 0; ch < nchunks; ++ch) {
            const int c0 = ch * DC;
            const int dc = min(DC, d - c0);
            __syncthreads();  // every thread is done with the last tile
            for (int e = tid; e < TILE_ROWS * DC; e += QT * RL) {
                const int r = e / DC, j = e % DC;
                const int row = row0 + r;
                a_s[r][j] = (row < row_hi && j < dc)
                    ? A[(size_t)row * d + c0 + j] : 0.f;
            }
            if (nchunks > 1 || row0 == row_lo) {  // queries: once if d <= DC
                for (int e = tid; e < QT * DC; e += QT * RL) {
                    const int qq = e / DC, j = e % DC;
                    const int qg = blockIdx.y * QT + qq;
                    c_s[j][qq] = (qg < Q && j < dc)
                        ? C[(size_t)qg * d + c0 + j] : 0.f;
                }
            }
            __syncthreads();
            if (tid < TILE_ROWS) {
                for (int j = 0; j < dc; ++j)
                    an_part += a_s[tid][j] * a_s[tid][j];
            }
            for (int j = 0; j < dc; ++j) {
                const float cj = c_s[j][lane];
#pragma unroll
                for (int r = 0; r < RPT; ++r)
                    acc[r] += a_s[rl * RPT + r][j] * cj;
            }
        }
        if (tid < TILE_ROWS) an_s[tid] = an_part;
        __syncthreads();
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            const int row = row0 + rl * RPT + r;
            const float dist = (an_s[rl * RPT + r] - 2.0f * acc[r]) + cn;
            // one compare rejects the common row; ties and NaN take the
            // full (value, row) order
            if (row < row_hi && !(dist > worst) &&
                rank_less(dist, row, worst, worst_i)) {
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

// One block per query: k rounds, each taking the smallest (value, row)
// strictly after the previous pick.  Rows are unique across the lists, and
// k <= N real rows rank before the empty slots, so this is the k smallest
// by (value, row).
__global__ void __launch_bounds__(MERGE_THREADS)
topk_merge_kernel(const float* __restrict__ part_v,
                  const int* __restrict__ part_i, float* __restrict__ vals,
                  int* __restrict__ idx, int n_cand, int k) {
    __shared__ float wv[MERGE_THREADS / 32];
    __shared__ int wi[MERGE_THREADS / 32];
    __shared__ float prev_v;
    __shared__ int prev_i;
    const int q = blockIdx.x;
    const float* v = part_v + (size_t)q * n_cand;
    const int* ix = part_i + (size_t)q * n_cand;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
        prev_v = -CUDART_INF_F;
        prev_i = INT_MIN;
    }
    __syncthreads();
    for (int r = 0; r < k; ++r) {
        const float pv = prev_v;
        const int pi = prev_i;
        float bv = CUDART_NAN_F;
        int bi = INT_MAX;
        for (int t = threadIdx.x; t < n_cand; t += MERGE_THREADS) {
            const float cv = v[t];
            const int ci = ix[t];
            if (rank_less(pv, pi, cv, ci) && rank_less(cv, ci, bv, bi)) {
                bv = cv;
                bi = ci;
            }
        }
        for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_down_sync(0xffffffffu, bv, off);
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

constexpr int AM_ROWS = 128;  // rows per block, one per thread
constexpr int KT = 32;        // centroids per shared-memory tile
constexpr int ADC = 32;       // features staged per chunk

__global__ void __launch_bounds__(AM_ROWS)
argmin_kernel(const float* __restrict__ A, const float* __restrict__ C,
              float* __restrict__ out_v, int* __restrict__ out_i,
              int N, int K, int d) {
    __shared__ float a_s[AM_ROWS][ADC + 1];
    __shared__ __align__(16) float c_s[ADC][KT];
    __shared__ float cn_s[KT];

    const int t = threadIdx.x;
    const int row0 = blockIdx.x * AM_ROWS;
    const int row = row0 + t;
    const int nchunks = (d + ADC - 1) / ADC;
    float an = 0.f;
    float best = CUDART_INF_F;
    int best_i = 0;

    for (int k0 = 0; k0 < K; k0 += KT) {
        const int kt = min(KT, K - k0);
        float acc[KT];
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) acc[kk] = 0.f;
        float cn_part = 0.f;
        for (int ch = 0; ch < nchunks; ++ch) {
            const int c0 = ch * ADC;
            const int dc = min(ADC, d - c0);
            __syncthreads();
            if (nchunks > 1 || k0 == 0) {  // rows: once if d <= ADC
                for (int e = t; e < AM_ROWS * ADC; e += AM_ROWS) {
                    const int r = e / ADC, j = e % ADC;
                    a_s[r][j] = (row0 + r < N && j < dc)
                        ? A[(size_t)(row0 + r) * d + c0 + j] : 0.f;
                }
            }
            for (int e = t; e < KT * ADC; e += AM_ROWS) {
                const int kk = e % KT, j = e / KT;
                c_s[j][kk] = (kk < kt && j < dc)
                    ? C[(size_t)(k0 + kk) * d + c0 + j] : 0.f;
            }
            __syncthreads();
            if (k0 == 0) {
                for (int j = 0; j < dc; ++j) an += a_s[t][j] * a_s[t][j];
            }
            if (t < KT) {
                for (int j = 0; j < dc; ++j) cn_part += c_s[j][t] * c_s[j][t];
            }
            for (int j = 0; j < dc; ++j) {
                const float aj = a_s[t][j];
                const float4* c4 = reinterpret_cast<const float4*>(&c_s[j][0]);
#pragma unroll
                for (int q4 = 0; q4 < KT / 4; ++q4) {
                    const float4 cv = c4[q4];
                    acc[4 * q4 + 0] += aj * cv.x;
                    acc[4 * q4 + 1] += aj * cv.y;
                    acc[4 * q4 + 2] += aj * cv.z;
                    acc[4 * q4 + 3] += aj * cv.w;
                }
            }
        }
        if (t < KT) cn_s[t] = cn_part;
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
            const float dist = (an - 2.0f * acc[kk]) + cn_s[kk];
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

int distance_topk_k_max() { return TOPK_K_MAX; }
int distance_topk_lists_per_split() { return RL; }
int distance_topk_tile_rows() { return TILE_ROWS; }

// A (N, d), C (Q, d) fp32 row-major; part_v/part_i scratch of
// Q * n_splits * RL * k; vals/idx (Q, k).  Returns the first CUDA error.
int distance_topk_f32(const float* A, const float* C, float* part_v,
                      int* part_i, float* vals, int* idx, int N, int Q, int d,
                      int k, int n_splits, int rows_per_split, void* stream) {
    if (k < 1 || k > TOPK_K_MAX || Q < 1 || N < 1 || d < 1 || n_splits < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(n_splits, (Q + QT - 1) / QT);
    topk_partial_kernel<<<grid, dim3(QT, RL), 0, s>>>(
        A, C, part_v, part_i, N, Q, d, k, rows_per_split);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    topk_merge_kernel<<<Q, MERGE_THREADS, 0, s>>>(
        part_v, part_i, vals, idx, n_splits * RL * k, k);
    return (int)cudaGetLastError();
}

// A (N, d), C (K, d) fp32 row-major -> out_v (N,), out_i (N,).
int distance_argmin_f32(const float* A, const float* C, float* out_v,
                        int* out_i, int N, int K, int d, void* stream) {
    if (N < 1 || K < 1 || d < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    argmin_kernel<<<(N + AM_ROWS - 1) / AM_ROWS, AM_ROWS, 0, s>>>(
        A, C, out_v, out_i, N, K, d);
    return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
