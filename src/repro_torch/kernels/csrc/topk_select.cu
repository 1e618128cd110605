// The k smallest of each row, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel B5 of the JAX package:
//   kernels/topk_select.py::_topk_kernel (topk_smallest): x (R, n) ->
//   values (R, k) f32, indices (R, k) int32, ascending, ties to the first
//   index.  It is the second pass of the blocked kNN arm, where it reads
//   the (Q, N) distance matrix that B4 wrote, and it takes every k from 1
//   to n: it serves each k that B1's per-thread lists cannot hold.
//   Its int32 key mode (``topk_smallest_i32``) selects on exact integer
//   rows: the int8 lattice distances of B6 past its lists and the ADC
//   distances of B8.  A float key would not do there: lattice distances
//   reach 4 * d * 127^2, past the 2^24 that fp32 holds exactly.
//
// The order: each element gets the 64-bit key (order(x), index), where
// order() maps a float to an unsigned int that sorts like the float, with
// -0 equal to +0 and every NaN after +inf.  Keys are distinct, so the k
// smallest keys are k distinct indices, ascending by value, ties to the
// first index, NaN last: the rule of the reference's oracle (lax.top_k)
// and of B1.  The Pallas kernel takes k masked-min passes that write +inf
// over each pick, so once a row's k smallest reach +inf it returns the
// same index again; this kernel does not rewrite x and cannot.
//
// What bounds it on an H100: the bytes of x.  At the kNN shape (R = 1024
// queries, n = 2^20 rows, k = 64) one read of x is 4.29 GB, 1.28 ms at
// 3.35 TB/s.
//
// What the design does about it: one block per row, no scratch in device
// memory.  A round selects the next t <= SORT_CAP keys of the row:
//  * radix select over the key, 12 or 8 bits a pass from the top: a pass
//    reads the row once and builds, in shared memory, the histogram of the
//    next digit over the keys that match the prefix found so far.  It stops
//    as soon as the keys at or below the prefix are exactly the t wanted;
//    for distinct floats that is the second or third pass.  Equal values
//    go on into the index bits, so ties cost passes, not correctness;
//  * one more read gathers those t keys into shared memory, a bitonic sort
//    orders them, and they are written out with their values.
// A round starts strictly after the previous round's last key, so any k
// up to n takes ceil(k / SORT_CAP) rounds.  On the kNN path (k = 64) that
// is one round, about 3 to 4 reads of the row, where the bound counts
// one.  Fewer reads (compacting the candidates after the first pass) is
// work for a later change.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int TK_THREADS = 512;
constexpr int SORT_CAP = 2048;        // keys sorted in shared memory per round
constexpr int BINS = 4096;            // 2^12: the widest digit
constexpr int BINS_PER_THREAD = BINS / TK_THREADS;
constexpr int UNROLL = 4;             // loads in flight per thread

__device__ __forceinline__ unsigned long long sort_key(float v, int e) {
    unsigned int b;
    if (v != v) {
        b = 0xFFFFFFFFu;              // every NaN, after +inf
    } else if (v == 0.f) {
        b = 0x80000000u;              // -0 sorts as +0
    } else {
        b = __float_as_uint(v);
        b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    }
    return ((unsigned long long)b << 32) | (unsigned int)e;
}

// int32 key mode: flipping the sign bit maps signed order onto unsigned
// order (INT_MIN -> 0, INT_MAX -> 0xFFFFFFFF)
__device__ __forceinline__ unsigned long long sort_key(int v, int e) {
    const unsigned int b = (unsigned int)v ^ 0x80000000u;
    return ((unsigned long long)b << 32) | (unsigned int)e;
}

// digit width below ``shift``: 64 -> 52 -> 40 -> 32 | -> 20 -> 8 -> 0
__device__ __forceinline__ int digit_bits(int shift) {
    return (shift == 40 || shift == 8) ? 8 : 12;
}

template <typename T>
__global__ void __launch_bounds__(TK_THREADS)
topk_kernel(const T* __restrict__ x, long long ld, int n, int k,
            T* __restrict__ vals, int* __restrict__ idx) {
    __shared__ unsigned int hist[BINS];
    __shared__ unsigned long long keys[SORT_CAP];
    __shared__ unsigned int warp_sum[TK_THREADS / 32];
    __shared__ unsigned int sel_bin, sel_below, sel_count, gathered;

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const T* row = x + (size_t)blockIdx.x * ld;
    T* out_v = vals + (size_t)blockIdx.x * k;
    int* out_i = idx + (size_t)blockIdx.x * k;
    unsigned long long last = 0;   // the previous round's last key
    bool after = false;            // false: no round before this one

    for (int done = 0; done < k;) {
        const unsigned int t = min(SORT_CAP, k - done);
        // ---- radix select: (prefix, shift) such that exactly t keys K
        // after ``last`` have (K >> shift) <= prefix
        unsigned long long prefix = 0;
        int shift = 64;
        unsigned int below = 0;   // keys after ``last`` under the prefix
        for (;;) {
            const int w = digit_bits(shift);
            const int nshift = shift - w;
            const unsigned int mask = (1u << w) - 1u;
            for (int b = tid; b < BINS; b += TK_THREADS) hist[b] = 0;
            __syncthreads();
            for (int base = 0; base < n; base += UNROLL * TK_THREADS) {
                T v[UNROLL];
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    const int e = base + u * TK_THREADS + tid;
                    v[u] = e < n ? row[e] : T(0);
                }
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    const int e = base + u * TK_THREADS + tid;
                    if (e >= n) continue;
                    const unsigned long long key = sort_key(v[u], e);
                    if (after && key <= last) continue;
                    if (shift < 64 && (key >> shift) != prefix) continue;
                    atomicAdd(&hist[(unsigned int)(key >> nshift) & mask], 1u);
                }
            }
            __syncthreads();
            // the first bin at which the running count reaches t: each
            // thread sums its bins, a block scan gives its offset
            unsigned int mine = 0;
            const int b0 = tid * BINS_PER_THREAD;
#pragma unroll
            for (int q = 0; q < BINS_PER_THREAD; ++q) mine += hist[b0 + q];
            unsigned int incl = mine;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const unsigned int o = __shfl_up_sync(0xffffffffu, incl, off);
                if (lane >= off) incl += o;
            }
            if (lane == 31) warp_sum[warp] = incl;
            __syncthreads();
            unsigned int woff = 0;
            for (int q = 0; q < warp; ++q) woff += warp_sum[q];
            unsigned int run = below + woff + incl - mine;
            if (run < t && run + mine >= t) {
                for (int q = 0; q < BINS_PER_THREAD; ++q) {
                    const unsigned int h = hist[b0 + q];
                    if (run + h >= t) {
                        sel_bin = b0 + q;
                        sel_below = run;
                        sel_count = h;
                        break;
                    }
                    run += h;
                }
            }
            __syncthreads();
            prefix = (prefix << w) | sel_bin;
            below = sel_below;
            shift = nshift;
            const bool exact = below + sel_count == t;
            __syncthreads();  // sel_* are rewritten by the next pass
            if (exact || shift == 0) break;
        }

        // ---- gather the t keys, sort them, write them out
        if (tid == 0) gathered = 0;
        __syncthreads();
        for (int base = 0; base < n; base += UNROLL * TK_THREADS) {
            T v[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int e = base + u * TK_THREADS + tid;
                v[u] = e < n ? row[e] : T(0);
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int e = base + u * TK_THREADS + tid;
                if (e >= n) continue;
                const unsigned long long key = sort_key(v[u], e);
                if ((after && key <= last) || (key >> shift) > prefix)
                    continue;
                const unsigned int p = atomicAdd(&gathered, 1u);
                if (p < SORT_CAP) keys[p] = key;   // exactly t arrive
            }
        }
        __syncthreads();
        unsigned int p2 = 1;
        while (p2 < t) p2 <<= 1;
        for (unsigned int j = t + tid; j < p2; j += TK_THREADS)
            keys[j] = ~0ull;
        __syncthreads();
        for (unsigned int size = 2; size <= p2; size <<= 1) {
            for (unsigned int stride = size >> 1; stride > 0; stride >>= 1) {
                for (unsigned int i = tid; i < p2; i += TK_THREADS) {
                    const unsigned int j = i ^ stride;
                    if (j > i) {
                        const unsigned long long a = keys[i], b = keys[j];
                        if ((a > b) == ((i & size) == 0)) {
                            keys[i] = b;
                            keys[j] = a;
                        }
                    }
                }
                __syncthreads();
            }
        }
        for (unsigned int j = tid; j < t; j += TK_THREADS) {
            const int e = (int)(unsigned int)keys[j];
            out_i[done + j] = e;
            out_v[done + j] = row[e];
        }
        last = keys[t - 1];
        after = true;
        done += t;
        __syncthreads();  // keys are refilled by the next round
    }
}

template <typename T>
int launch_topk(const T* x, long long ld, int R, int n, int k, T* vals,
                int* idx, void* stream) {
    if (R < 1 || n < 1 || k < 1 || k > n || ld < n ||
        n > INT_MAX - UNROLL * TK_THREADS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    topk_kernel<T><<<R, TK_THREADS, 0, s>>>(x, ld, n, k, vals, idx);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: R rows of n fp32, row r at x + r * ld (ld >= n) -> vals/idx (R, k)
// row-major.  1 <= k <= n.  Returns the first CUDA error.
int topk_smallest_f32(const float* x, long long ld, int R, int n, int k,
                      float* vals, int* idx, void* stream) {
    return launch_topk<float>(x, ld, R, n, k, vals, idx, stream);
}

// The int32 key mode: the same contract on int32 rows.
int topk_smallest_i32(const int* x, long long ld, int R, int n, int k,
                      int* vals, int* idx, void* stream) {
    return launch_topk<int>(x, ld, R, n, k, vals, idx, stream);
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
