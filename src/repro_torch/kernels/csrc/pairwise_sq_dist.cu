// Full squared-distance matrix, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel B4 of the JAX package:
//   kernels/distance.py::_dist_kernel (pairwise_sq_dist):
//   A (N, d), C (K, d) -> E (N, K),  E[n, k] = ||a_n||^2 - 2 a_n.c_k + ||c_k||^2
// It is the first pass of the blocked two-pass arm of kNN and K-Means.
//
// What bounds it on an H100: the bytes of E.  At the kNN shape (N = 2^20,
// K = Q = 1024, d = 21) it writes 4.29 GB, 1.28 ms at 3.35 TB/s, against
// 46 GFLOP, 0.69 ms at the 67 TFLOP/s fp32 peak.  At the K-Means fit shape
// (N = 262144, K = 256) it writes 268 MB.
//
// What the design does about it:
//  * One block of 256 threads computes a 64 x 64 tile of E.  Features are
//    staged in chunks of 32 in shared memory, so any d fits.  Each thread
//    keeps a 4 x 4 tile in registers: 4 values along E's contiguous axis,
//    16 apart, so that a warp's store of one register covers 16
//    consecutive floats; and 4 consecutive values along the other axis,
//    read as one float4 broadcast.  The stores are the whole cost, and
//    each lands once, coalesced.
//  * E is written row-major (N, K), or with ``a_fast`` as (K, N): the
//    transposed matrix whose rows the kNN arm's top-k pass reads.  So no
//    transpose of E is ever copied.
//  * Blocks walk every C tile of one A tile before the next A tile: each
//    A tile comes from device memory once, and C (queries or centroids)
//    stays in L2.
//  * The norms and the cross term are summed here, on the CUDA cores in
//    fp32, not by a library product and not in TF32.  The arithmetic is
//    B1's (fused multiply-adds over the features in order, from zero, then
//    (an - 2 acc) + cn), so the blocked arm's distances are those of the
//    fused arm.
//  * Ragged N and K are masked in the kernel; nothing is padded.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int PT = 64;        // tile extent along each operand
constexpr int PDC = 32;       // features staged per chunk
constexpr int PTHREADS = 256;

// F: the operand along E's contiguous axis (A if A_FAST, else C);
// S: the other operand.
template <bool A_FAST>
__global__ void __launch_bounds__(PTHREADS)
pairwise_kernel(const float* __restrict__ A, const float* __restrict__ C,
                float* __restrict__ E, int N, int K, int d) {
    __shared__ float f_s[PDC][PT + 1];
    __shared__ __align__(16) float s_s[PDC][PT];
    __shared__ float fn_s[PT];
    __shared__ float sn_s[PT];

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const unsigned c_tiles = (K + PT - 1) / PT;
    const int a0 = (int)(blockIdx.x / c_tiles) * PT;
    const int c0 = (int)(blockIdx.x % c_tiles) * PT;
    const float* F = A_FAST ? A : C;
    const float* S = A_FAST ? C : A;
    const int f0 = A_FAST ? a0 : c0, s0 = A_FAST ? c0 : a0;
    const int nf = A_FAST ? N : K, ns = A_FAST ? K : N;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float fn_part = 0.f, sn_part = 0.f;

    for (int j0 = 0; j0 < d; j0 += PDC) {
        const int dc = min(PDC, d - j0);
        __syncthreads();  // every thread is done with the last chunk
        // F: feature-fast reads (coalesced); the padded row keeps the
        // transposing store free of bank conflicts
        for (int e = tid; e < PT * PDC; e += PTHREADS) {
            const int r = e / PDC, j = e % PDC;
            f_s[j][r] = (f0 + r < nf && j < dc)
                ? F[(size_t)(f0 + r) * d + j0 + j] : 0.f;
        }
        // S: row-fast, so the store is conflict-free; the strided reads
        // hit lines that the next iterations use
        for (int e = tid; e < PT * PDC; e += PTHREADS) {
            const int r = e % PT, j = e / PT;
            s_s[j][r] = (s0 + r < ns && j < dc)
                ? S[(size_t)(s0 + r) * d + j0 + j] : 0.f;
        }
        __syncthreads();
        if (tid < PT) {
            for (int j = 0; j < dc; ++j) fn_part += f_s[j][tid] * f_s[j][tid];
        } else if (tid < 2 * PT) {
            for (int j = 0; j < dc; ++j)
                sn_part += s_s[j][tid - PT] * s_s[j][tid - PT];
        }
        for (int j = 0; j < dc; ++j) {
            const float4 sv = *reinterpret_cast<const float4*>(&s_s[j][ty * 4]);
            const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float fv = f_s[j][tx + 16 * i];
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[i][q] += fv * s4[q];
            }
        }
    }
    if (tid < PT) fn_s[tid] = fn_part;
    else if (tid < 2 * PT) sn_s[tid - PT] = sn_part;
    __syncthreads();

#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int s = s0 + ty * 4 + q;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int f = f0 + tx + 16 * i;
            if (f < nf && s < ns) {
                const float an = A_FAST ? fn_s[tx + 16 * i] : sn_s[ty * 4 + q];
                const float cn = A_FAST ? sn_s[ty * 4 + q] : fn_s[tx + 16 * i];
                E[(size_t)s * nf + f] = (an - 2.0f * acc[i][q]) + cn;
            }
        }
    }
}

}  // namespace

extern "C" {

// A (N, d), C (K, d) fp32 row-major -> E: (N, K) row-major, or (K, N)
// row-major when a_fast != 0.  Returns the first CUDA error.
int pairwise_sq_dist_f32(const float* A, const float* C, float* E, int N,
                         int K, int d, int a_fast, void* stream) {
    if (N < 1 || K < 1 || d < 1) return (int)cudaErrorInvalidValue;
    const long long blocks = (long long)((N + PT - 1) / PT) *
                             ((K + PT - 1) / PT);
    if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (a_fast)
        pairwise_kernel<true><<<(unsigned)blocks, PTHREADS, 0, s>>>(A, C, E,
                                                                   N, K, d);
    else
        pairwise_kernel<false><<<(unsigned)blocks, PTHREADS, 0, s>>>(A, C, E,
                                                                    N, K, d);
    return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
