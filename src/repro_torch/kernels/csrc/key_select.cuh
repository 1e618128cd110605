// The selection by 64-bit keys shared by B5's filter route
// (topk_select.cu) and B8's fused route (adc_topk.cu): both keep a sorted
// list of the k smallest keys seen so far in shared memory, queue the keys
// that rank before its last one, and merge list and queue by one bitonic
// sort; rows split across blocks meet in the split merge kernel.
//
// A key is (order(value), index): order() maps a float to an unsigned int
// that sorts like the float, -0 equal to +0 and every NaN after +inf, and
// an int32 to its bits with the sign flipped.  Keys are distinct, so the k
// smallest are k distinct indices, ascending by value, ties to the
// smallest index.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace ksel {

constexpr unsigned long long NONE = ~0ull;   // the empty key
constexpr unsigned FULL = 0xffffffffu;
constexpr int MERGE_KEYS = 2048;      // most keys the split merge sorts
constexpr int MERGE_THREADS = 256;    // threads of a split merge block

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

// int32 keys: flipping the sign bit maps signed order onto unsigned order
// (INT_MIN -> 0, INT_MAX -> 0xFFFFFFFF)
__device__ __forceinline__ unsigned long long sort_key(int v, int e) {
    const unsigned int b = (unsigned int)v ^ 0x80000000u;
    return ((unsigned long long)b << 32) | (unsigned int)e;
}

// the int32 value and the index of an int32 key
__device__ __forceinline__ int key_value(unsigned long long key) {
    return static_cast<int>(static_cast<unsigned int>(key >> 32) ^
                            0x80000000u);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
    return static_cast<int>(static_cast<unsigned int>(key));
}

// Ascending bitonic sort of keys[0, p2), p2 a power of two, by the whole
// block; ends with a barrier.
__device__ void bitonic(unsigned long long* keys, int p2) {
    for (int size = 2; size <= p2; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int i = threadIdx.x; i < p2 / 2; i += blockDim.x) {
                const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
                const unsigned long long a = keys[lo], b = keys[hi];
                if ((a > b) == ((lo & size) == 0)) {
                    keys[lo] = b;
                    keys[hi] = a;
                }
            }
            __syncthreads();
        }
    }
}

// keys[0, k) the sorted list, keys[k, k + *cnt) the queue: sort both
// together, so the first k are the new list; *cnt = 0.  By the whole
// block, after a barrier; ends with one.  Returns the new threshold.
__device__ unsigned long long merge_list(unsigned long long* keys, int k,
                                         unsigned* cnt) {
    const int total = k + static_cast<int>(*cnt);
    int p2 = 1;
    while (p2 < total) p2 <<= 1;
    for (int i = total + threadIdx.x; i < p2; i += blockDim.x) keys[i] = NONE;
    __syncthreads();   // every thread has read *cnt, the padding is set
    bitonic(keys, p2);
    if (threadIdx.x == 0) *cnt = 0;
    const unsigned long long tau = keys[k - 1];
    __syncthreads();
    return tau;
}

// Reserve ``c`` queue slots for this lane, with one shared atomic a warp.
// Returns (the lane's first slot, the queue's length after the warp's
// push); the length is 0 if the warp pushes nothing.
__device__ __forceinline__ uint2 reserve(unsigned* cnt, unsigned c) {
    const int lane = threadIdx.x & 31;
    unsigned incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += y;
    }
    const unsigned total = __shfl_sync(FULL, incl, 31);
    if (total == 0) return make_uint2(0, 0);
    unsigned base = 0;
    if (lane == 31) base = atomicAdd(cnt, total);
    base = __shfl_sync(FULL, base, 31);
    return make_uint2(base + incl - c, base + total);
}

// The n_splits lists of k keys of each row (n_splits * k <= MERGE_KEYS)
// -> its k smallest: one block a row sorts them all.  A row holds at least
// k real keys, and the empty keys sort after every real one.  The values
// are read back from x at the chosen indices (x's own bits) or, with
// FROM_KEY (int32 keys), taken from the keys.
template <typename T, bool FROM_KEY>
__global__ void __launch_bounds__(MERGE_THREADS)
split_merge_kernel(const T* __restrict__ x, long long ld, int k,
                   int n_splits, const unsigned long long* __restrict__ part,
                   T* __restrict__ vals, int* __restrict__ idx) {
    __shared__ unsigned long long keys[MERGE_KEYS];
    const int r = blockIdx.x, total = n_splits * k;
    int p2 = 1;
    while (p2 < total) p2 <<= 1;
    const unsigned long long* src = part + static_cast<size_t>(r) * total;
    for (int i = threadIdx.x; i < p2; i += MERGE_THREADS)
        keys[i] = i < total ? src[i] : NONE;
    __syncthreads();
    bitonic(keys, p2);
    const T* row = x + static_cast<size_t>(r) * ld;
    for (int j = threadIdx.x; j < k; j += MERGE_THREADS) {
        const int e = key_index(keys[j]);
        idx[static_cast<size_t>(r) * k + j] = e;
        if constexpr (FROM_KEY)
            vals[static_cast<size_t>(r) * k + j] = key_value(keys[j]);
        else
            vals[static_cast<size_t>(r) * k + j] = row[e];
    }
}

}  // namespace ksel
