// Batched Gaussian Naive Bayes joint log-likelihood, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels B3 and B9 of the JAX package:
//   kernels/gnb_score.py::_gnb_batch_kernel (gnb_scores_batch, paper Fig. 5
//   OP1 + OP2) and, launched with one query, kernels/gnb_score.py::
//   _gnb_kernel (gnb_scores):
//     out[b, c] = sum_f -1/2 ((x - mu)^2 / var + log var + log 2 pi)
//                 + log_prior[c]
//
// What bounds it on an H100: at the GNB serving shape (B = 1024 queries,
// C = 10 classes, d = 784) the call reads 3.3 MB, 0.0010 ms at the memory
// rate, and has B C d = 8.0 M terms of an IEEE-rounded division and four
// other operations: about 14 instructions a term, ~4 us of issue with every
// scheduler of the card busy.  So the issue rate, and filling the card with
// warps that keep it busy, set the pace; the bytes do not.
//
// The design.
//  * The terms that do not depend on the query, -1/2 sum_f (log var +
//    log 2 pi) + log_prior, are one constant a class, summed while the
//    block stages var and kept in shared memory: one logf a (class,
//    feature) a block, where the tile kernel took them in every chunk of
//    every block.  A second kernel taking them once a call was measured
//    (H100): 0.0020 ms of device time and ~11 us of host time a call,
//    which made a GNB classify from the card ~20% slower, host-bound as it
//    is; in the block they cost 0.0012-0.0014 ms.  The scores kernel sums
//    (x - mu)^2 / var and writes -1/2 sum + constant.  Each term rounds as
//    the plain version's (x - mu, its square, the IEEE-rounded division:
//    no fast math, no reciprocal); only the order of the sum differs,
//    which the plain version's tolerance covers.
//  * A warp or more a query (``split``, by the wrapper's plan): lane l of
//    warp w takes the features 32 j + l of the 32-feature stripes
//    j = w % split, + split, .. and keeps a running sum for every class of
//    a group of at most CG = 16 in registers; classes past 16 loop over
//    groups (C split as evenly as it goes: the kernel is a template on
//    the group's size, so its class loops unroll without a test).  The
//    split fills the card: at B = 1024 four warps a query make 256 blocks
//    of 16 warps, two an SM; at B = 1 (B9) sixteen warps share the query.
//    The warps of a query reduce by shuffles, then through shared memory.
//  * Every (mu, var) pair and numerator of a feature is formed before its
//    divisions: each division is nvcc's IEEE sequence with its own
//    slow-path branch, which no instruction crosses, so the loads and
//    subtractions of a feature overlap only when they come first.
//  * mu and var are staged in shared memory as (mu, var) pairs, a class's
//    features in a row: a lane's 8-byte load of its feature is
//    conflict-free and feeds one term.  Where a group's C d pairs fit
//    RESIDENT_MAX bytes (C = 10, d = 784: 62,720) they are staged once a
//    block and stay resident (route "resident"); else each block streams
//    chunks of ``chunk`` features of each group in turn, two barriers a
//    chunk (route "stream").
//  * X is read once, by the lane whose feature it is, coalesced, from
//    device memory (a group of 16 classes or fewer reads it once).
//  * Blocks are persistent (at most two an SM): a block walks its query
//    groups, so the resident pairs are staged once a block.
//  * Tenants (the grouped launch of a multi-tenant model group): G
//    same-shape tenants, queries X (G, B, d) against (mu, var) (G, C, d)
//    and log_prior (G, C), run as one launch on either route, the tenant on
//    blockIdx.y; a block offsets its operands and output to its tenant,
//    stages that tenant's pairs and sums its class constants, and is
//    otherwise the G = 1 block.  With the G = 1 launch's warps a query
//    (the wrapper plans the split from B, not G B) every sum runs in the
//    same order, so a lane is bit-equal to that launch.  The tenant code
//    is a template parameter: a G = 1 launch runs the kernel without it,
//    as before the axis was added.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 16;               // warps of a scores block
constexpr int THREADS = WARPS * 32;
constexpr int CG = 16;                  // classes of a group: a lane's sums
constexpr int RESIDENT_MAX = 98304;     // bytes of staged (mu, var) pairs
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2PI = 1.8378770664093453f;

// the classes a group holds where C classes split into the fewest groups
// of at most CG, as evenly as they go
__host__ __device__ inline int group_size(int C) {
    const int groups = (C + CG - 1) / CG;
    return (C + groups - 1) / groups;
}

// Block: WARPS / split queries, split warps each; see the notes above.
// NC: the classes of a group (group_size(C)); a group's slots past C hold
// (mu, var) = (0, 1) and are never written.  Shared memory: the (mu, var)
// pairs [NC][chunk], the warps' sums [WARPS][NC], the group's constants
// [NC].
template <int NC, bool TENANTS>
__global__ void __launch_bounds__(THREADS)
gnb_scores_kernel(const float* __restrict__ X, const float* __restrict__ mu,
                  const float* __restrict__ var,
                  const float* __restrict__ log_prior,
                  float* __restrict__ out, int B, int C, int d, int split,
                  int chunk) {
    extern __shared__ __align__(16) unsigned char smem[];
    if (TENANTS) {   // the tenant's operands
        const size_t g = blockIdx.y;
        X += g * B * d;
        mu += g * C * d;
        var += g * C * d;
        log_prior += g * C;
        out += g * B * C;
    }
    float2* mv = reinterpret_cast<float2*>(smem);
    float* red = reinterpret_cast<float*>(
        smem + static_cast<size_t>(NC) * chunk * sizeof(float2));
    float* cst = red + WARPS * NC;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int per_block = WARPS / split;
    const int wq = warp % split;
    const bool resident = C <= NC && chunk >= d;

    // the pairs of classes [g0, g0 + NC), features [f0, f0 + fc), and the
    // thread's part of each class's sum of log var + log 2 pi over them: a
    // feature's loads of every class are issued unconditionally (a slot
    // past C loads the last class again), so all are in flight before its
    // stores
    auto stage = [&](int g0, int f0, int fc, float (&lv)[NC]) {
        for (int f = tid; f < fc; f += THREADS) {
            float2 v[NC];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const size_t at =
                    static_cast<size_t>(min(g0 + c, C - 1)) * d + f0 + f;
                v[c] = g0 + c < C
                    ? make_float2(__ldg(mu + at), __ldg(var + at))
                    : make_float2(0.f, 1.f);
            }
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                mv[c * chunk + f] = v[c];
                lv[c] += logf(v[c].y) + LOG2PI;
            }
        }
    };
    // the block's sum of the threads' values of each class, through red
    auto block_sums = [&](float (&x)[NC]) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                x[c] += __shfl_xor_sync(FULL, x[c], o);
            if (lane == c) red[warp * NC + c] = x[c];
        }
        __syncthreads();
    };
    // the group's constants -1/2 sum_f (log var + log 2 pi) + log prior,
    // each summed over the block's warps in one order
    auto constants = [&](int g0, float (&lv)[NC]) {
        block_sums(lv);
        if (tid < NC && g0 + tid < C) {
            float t = 0.f;
            for (int w = 0; w < WARPS; ++w) t += red[w * NC + tid];
            cst[tid] = -0.5f * t + log_prior[g0 + tid];
        }
        __syncthreads();
    };
    if (resident) {
        float lv[NC] = {};
        stage(0, 0, d, lv);
        constants(0, lv);   // its barriers also publish the staged pairs
    }
    for (int q0 = blockIdx.x * per_block; q0 < B;
         q0 += gridDim.x * per_block) {
        const int b = q0 + warp / split;
        const float* x = X + static_cast<size_t>(min(b, B - 1)) * d;
        for (int g0 = 0; g0 < C; g0 += NC) {
            float acc[NC] = {}, lv[NC] = {};
            for (int f0 = 0; f0 < d; f0 += chunk) {
                const int fc = min(chunk, d - f0);
                if (!resident) {
                    __syncthreads();   // the last chunk is consumed
                    stage(g0, f0, fc, lv);
                    __syncthreads();
                }
                if (b >= B) continue;
                for (int f = 32 * wq + lane; f < fc; f += 32 * split) {
                    const float xv = __ldg(x + f0 + f);
                    // every numerator first, then the divisions, so the
                    // loads and subtractions of the classes overlap
                    float num[NC], den[NC];
#pragma unroll
                    for (int c = 0; c < NC; ++c) {
                        const float2 m = mv[c * chunk + f];
                        const float diff = xv - m.x;
                        num[c] = diff * diff;
                        den[c] = m.y;
                    }
#pragma unroll
                    for (int c = 0; c < NC; ++c) acc[c] += num[c] / den[c];
                }
            }
            if (!resident) constants(g0, lv);
            // the warps' sums of each query, then the scores
            block_sums(acc);
            if (tid < per_block * NC) {
                const int q = tid / NC, c = tid % NC;
                if (q0 + q < B && g0 + c < C) {
                    float s = 0.f;
                    for (int w = 0; w < split; ++w)
                        s += red[(q * split + w) * NC + c];
                    out[static_cast<size_t>(q0 + q) * C + g0 + c] =
                        fmaf(-0.5f, s, cst[c]);
                }
            }
            __syncthreads();   // red and cst are read before they are reused
        }
    }
}

template <int NC>
cudaError_t launch_scores(const float* X, const float* mu, const float* var,
                          const float* log_prior, float* out, int B, int C,
                          int d, int split, int chunk, int grid, int G,
                          cudaStream_t s) {
    if (NC != group_size(C))
        return launch_scores<NC - 1>(X, mu, var, log_prior, out, B, C, d,
                                     split, chunk, grid, G, s);
    const size_t bytes = static_cast<size_t>(NC) * chunk * sizeof(float2) +
                         (WARPS + 1) * NC * sizeof(float);
    static size_t allowed[2] = {48 * 1024, 48 * 1024};
    auto* kernel = G > 1 ? gnb_scores_kernel<NC, true>
                         : gnb_scores_kernel<NC, false>;
    if (bytes > allowed[G > 1]) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes));
        if (err != cudaSuccess) return err;
        allowed[G > 1] = bytes;
    }
    kernel<<<dim3(grid, G), THREADS, bytes, s>>>(
        X, mu, var, log_prior, out, B, C, d, split, chunk);
    return cudaGetLastError();
}

template <>
cudaError_t launch_scores<0>(const float*, const float*, const float*,
                             const float*, float*, int, int, int, int, int,
                             int, int, cudaStream_t) {
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int gnb_resident_max() { return RESIDENT_MAX; }
int gnb_class_group() { return CG; }
int gnb_warps() { return WARPS; }

// X (G, B, d), mu/var (G, C, d), log_prior (G, C) fp32 row-major, G
// tenants (G = 1: one model) -> out (G, B, C).  split: warps a query (a
// divisor of WARPS); chunk: features of mu/var staged at once (d where a
// group's pairs fit RESIDENT_MAX bytes); grid: a tenant's persistent
// blocks.  Returns the first CUDA error.
int gnb_scores_batch_f32(const float* X, const float* mu, const float* var,
                         const float* log_prior, float* out, int B, int C,
                         int d, int split, int chunk, int grid, int G,
                         void* stream) {
    const int fc = chunk < d ? chunk : d;
    if (B < 1 || C < 1 || d < 1 || grid < 1 || split < 1 || G < 1 ||
        G > 65535 ||
        split > WARPS || WARPS % split || chunk < 1 ||
        static_cast<size_t>(group_size(C)) * fc * sizeof(float2) >
            RESIDENT_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_scores<CG>(
        X, mu, var, log_prior, out, B, C, d, split, fc, grid, G,
        static_cast<cudaStream_t>(stream)));
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
