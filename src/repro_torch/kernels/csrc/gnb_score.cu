// Batched Gaussian Naive Bayes joint log-likelihood, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel B3 of the JAX package:
//   kernels/gnb_score.py::_gnb_batch_kernel (gnb_scores_batch, paper Fig. 5
//   OP1 + OP2):  out[b, c] = sum_f -1/2 ((x - mu)^2 / var + log var
//                                       + log 2 pi) + log_prior[c]
//
// What bounds it on an H100: at the GNB serving shape (B = 1024 queries,
// C = 10 classes, d = 784) the call reads 3.2 MB of X and does 7 fp32
// operations on each of B*C*d = 8.0 M terms (one of them a division), about
// a microsecond either way; at this size launch overhead and the division's
// latency dominate.
//
// What the design does about it: the TPU walks the feature axis as a
// sequential grid dimension that accumulates into the output block.  Here
// one block owns a (32 query x 8 class) output tile and loops over d
// inside the block, staging 64-feature chunks of X, mu and var in shared
// memory; nothing is carried between blocks and each output is written
// once.  log var is computed in the kernel, once per (class, feature) per
// block while staging, not per query.  The ragged feature edge is masked
// in the kernel, so the reference wrapper's padding and its
// 1/2 log(2 pi) n_pad correction do not exist here.  The division is the
// IEEE-rounded one (no fast math), as in the plain version.
#include <cuda_runtime.h>

namespace {

constexpr int GCT = 8;    // classes per block (threadIdx.x)
constexpr int GBT = 32;   // queries per block (threadIdx.y)
constexpr int GDC = 64;   // features staged per chunk
constexpr float LOG2PI = 1.8378770664093453f;

__global__ void __launch_bounds__(GCT * GBT)
gnb_batch_kernel(const float* __restrict__ X, const float* __restrict__ mu,
                 const float* __restrict__ var,
                 const float* __restrict__ log_prior, float* __restrict__ out,
                 int B, int C, int d) {
    __shared__ float x_s[GBT][GDC + 1];
    __shared__ float mu_s[GCT][GDC + 1];
    __shared__ float var_s[GCT][GDC + 1];
    __shared__ float lv_s[GCT][GDC + 1];

    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * GCT + tx;
    const int b0 = blockIdx.x * GBT, c0 = blockIdx.y * GCT;
    float acc = 0.f;

    for (int f0 = 0; f0 < d; f0 += GDC) {
        const int dc = min(GDC, d - f0);
        __syncthreads();
        for (int e = tid; e < GBT * GDC; e += GCT * GBT) {
            const int r = e / GDC, j = e % GDC;
            x_s[r][j] = (b0 + r < B && j < dc)
                ? X[(size_t)(b0 + r) * d + f0 + j] : 0.f;
        }
        for (int e = tid; e < GCT * GDC; e += GCT * GBT) {
            const int r = e / GDC, j = e % GDC;
            const bool ok = c0 + r < C && j < dc;
            const float v = ok ? var[(size_t)(c0 + r) * d + f0 + j] : 1.f;
            mu_s[r][j] = ok ? mu[(size_t)(c0 + r) * d + f0 + j] : 0.f;
            var_s[r][j] = v;
            lv_s[r][j] = logf(v);
        }
        __syncthreads();
        for (int j = 0; j < dc; ++j) {
            const float diff = x_s[ty][j] - mu_s[tx][j];
            acc += -0.5f * ((diff * diff) / var_s[tx][j] + lv_s[tx][j]
                            + LOG2PI);
        }
    }
    const int b = b0 + ty, c = c0 + tx;
    if (b < B && c < C) out[(size_t)b * C + c] = acc + log_prior[c];
}

}  // namespace

extern "C" {

// X (B, d), mu/var (C, d), log_prior (C,) fp32 row-major -> out (B, C).
int gnb_scores_batch_f32(const float* X, const float* mu, const float* var,
                         const float* log_prior, float* out, int B, int C,
                         int d, void* stream) {
    if (B < 1 || C < 1 || d < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid((B + GBT - 1) / GBT, (C + GCT - 1) / GCT);
    gnb_batch_kernel<<<grid, dim3(GCT, GBT), 0, s>>>(X, mu, var, log_prior,
                                                     out, B, C, d);
    return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
