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
// -0 equal to +0 and every NaN after +inf (int32: the sign bit flipped).
// Keys are distinct, so the k smallest keys are k distinct indices,
// ascending by value, ties to the first index, NaN last: the rule of the
// reference's oracle (lax.top_k) and of B1.  The Pallas kernel takes k
// masked-min passes that write +inf over each pick, so once a row's k
// smallest reach +inf it returns the same index again; this kernel does
// not rewrite x and cannot.  Values are read back from x at the chosen
// indices, so they are x's own bits (a NaN's payload, a zero's sign).
//
// What bounds it on an H100: the bytes of x.  At the kNN shape (R = 1024
// queries, n = 2^20 rows, k = 64) one read of x is 4.29 GB, 1.28 ms at
// 3.35 TB/s.  The radix design that came before read each row three
// times (two radix passes on average, then a gather: 4.26 ms; one pass
// alone 1.39 ms, and without its shared atomics no faster) and ran one
// block a row, 7x slower than eight blocks a row at R = 16
// (launch/blocked_breakdown.py; PERF.md §6).
//
// Two routes, by k (``topk_select.route``), counted by the wrapper:
//
// filter (k <= FILTER_K_MAX): one read of each element.  A block takes a
// segment of a row and keeps, in shared memory, one sorted list of the k
// smallest keys seen so far; its threshold tau is the list's k-th key.
//  * Staging: the 16-byte-aligned middle of the segment streams in stages
//    of F_STAGE elements, each thread reading its 16 elements of a stage
//    with four 16-byte streaming loads into registers, one stage ahead of
//    the stage it filters (two register buffers).  The at most three
//    elements before the first aligned one and after the last whole 16
//    bytes are element loads.  So any row stride and offset is read once
//    (the transposed and row-strided views of B4's output included).
//    A ring of 1-D bulk asynchronous copies into shared memory was tried
//    first: it was no faster, and its 48 KB came out of the room of the
//    list and its queue (so two blocks an SM instead of three).
//    With no element passing the compare, the loads, compares and
//    barriers alone stream the rows as fast as one ``amax`` reads them
//    (launch/blocked_breakdown.py --new; PERF.md §6).
//  * Filter: a thread compares each element with tau's value (kept in a
//    register): most elements cost that one compare.  Where a warp holds
//    an element that may rank before tau, its lanes form their keys, and
//    the keys below tau go to the block's queue, which follows the list in
//    one shared buffer of F_CAP keys: a warp scan and one shared atomic a
//    warp reserve their slots.
//  * The keys, the bitonic sort, the list merge, the queue reservation and
//    the split merge are csrc/key_select.cuh's, which B8's fused route
//    (adc_topk.cu) selects with too.
//  * Merge: after each push group (a stage; the first stage in F_FIRST
//    groups) the block synchronises with __syncthreads_or("my warp's push
//    took the queue to EAGER = max(k, F_EAGER) keys"), and if so sorts
//    list and queue together (a bitonic sort of the next power of two,
//    padded with the empty key ~0); the first k become the list, its k-th
//    key the new tau.  Merging early keeps tau tight: tau moves only at a
//    merge, and a queue allowed to grow to thousands of keys left tau at
//    the 6% quantile of a row's first thousand elements for tens of
//    thousands more, with a candidate in nearly every warp.  EAGER is at
//    most FILL + 1 = F_CAP - k - F_STAGE + 1 and a group pushes at most
//    F_STAGE keys, so the queue never overflows and no candidate is ever
//    dropped: the block merges early instead.  A row in descending order
//    pushes every element and merges every group (chip_smoke.py times
//    it); a random row merges a handful of times.
//  * Rows split across blocks where R is small (``topk_select.split_rows``
//    plans it until the grid holds about two blocks an SM, each split at
//    least MIN_SPLIT elements and n_splits * k <= MERGE_KEYS): each split
//    writes its list of k keys (empty keys where it had fewer than k
//    elements) to scratch, and a second kernel, one block a row, sorts the
//    n_splits * k keys and writes the first k.
//
// radix (k > FILTER_K_MAX), the earlier design: one block per row, no
// scratch in device memory.  A round selects the next t <= SORT_CAP keys
// of the row:
//  * radix select over the key, 12 or 8 bits a pass from the top: a pass
//    reads the row once and builds, in shared memory, the histogram of the
//    next digit over the keys that match the prefix found so far.  It stops
//    as soon as the keys at or below the prefix are exactly the t wanted.
//    Equal values go on into the index bits, so ties cost passes, not
//    correctness;
//  * one more read gathers those t keys into shared memory, a bitonic sort
//    orders them, and they are written out with their values.
// A round starts strictly after the previous round's last key, so any k
// up to n takes ceil(k / SORT_CAP) rounds.
//
// Neither route falls back to the plain version.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "key_select.cuh"

namespace {

constexpr int TK_THREADS = 512;
constexpr int SORT_CAP = 2048;        // keys sorted in shared memory per round
constexpr int BINS = 4096;            // 2^12: the widest digit
constexpr int BINS_PER_THREAD = BINS / TK_THREADS;
constexpr int UNROLL = 4;             // loads in flight per thread

constexpr int F_THREADS = 256;
constexpr int F_STAGE = 4096;         // elements of a stage (16 KB)
constexpr int F_PER = F_STAGE / F_THREADS;   // elements of a thread a stage
constexpr int F_FIRST = 4;            // push groups of the first stage
constexpr int F_EAGER = 128;          // merge once the queue holds this many
constexpr int F_CAP = 8192;           // keys of the list and its queue
// the longest list: list, a stage's pushes and a queue as long as the
// list fit in F_CAP (64 KB, three blocks an SM)
constexpr int FILTER_K_MAX = 2048;
using ksel::bitonic;
using ksel::FULL;
using ksel::merge_list;
using ksel::MERGE_KEYS;
using ksel::NONE;
using ksel::reserve;
using ksel::sort_key;
constexpr size_t F_SMEM = static_cast<size_t>(F_CAP) * 8 + 16;
static_assert(FILTER_K_MAX + F_STAGE <= F_CAP, "a list and a stage fit");
static_assert((F_CAP & (F_CAP - 1)) == 0, "F_CAP is a power of two");

// digit width below ``shift``: 64 -> 52 -> 40 -> 32 | -> 20 -> 8 -> 0
__device__ __forceinline__ int digit_bits(int shift) {
    return (shift == 40 || shift == 8) ? 8 : 12;
}

template <typename T>
__global__ void __launch_bounds__(TK_THREADS)
radix_kernel(const T* __restrict__ x, long long ld, int n, int k,
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
        int p2 = 1;
        while (p2 < static_cast<int>(t)) p2 <<= 1;
        for (int j = static_cast<int>(t) + tid; j < p2; j += TK_THREADS)
            keys[j] = NONE;
        __syncthreads();
        bitonic(keys, p2);
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

// ------------------------------------------------------------ filter route

// The value that a key's order bits ``hi`` stand for, as a bound: an
// element above it has a key above every key with these order bits, so
// ``!(v > bound(tau >> 32))`` passes every key below tau (and some
// others, which the key compare then rejects).  The empty key and NaN's
// order bits give NaN (float) or INT_MAX (int32): everything passes.
__device__ __forceinline__ float bound(unsigned hi, float) {
    if (hi == 0xFFFFFFFFu) return __uint_as_float(0x7FC00000u);
    return __uint_as_float(hi & 0x80000000u ? hi & 0x7FFFFFFFu : ~hi);
}

__device__ __forceinline__ int bound(unsigned hi, int) {
    return static_cast<int>(hi ^ 0x80000000u);
}

// four elements from 16 aligned bytes of device memory, read once
// (streaming: evict first)
__device__ __forceinline__ void load4(const float* p, float* v) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const int* p, int* v) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// Block b: split b % n_splits of row b / n_splits (splits of a row are
// adjacent blocks).  One split: the row's k smallest into vals/idx; more:
// the split's list of k keys into part[b * k ..].
template <typename T>
__global__ void __launch_bounds__(F_THREADS, 3)
filter_kernel(const T* __restrict__ x, long long ld, int n, int k, int seg,
              int n_splits, T* __restrict__ vals, int* __restrict__ idx,
              unsigned long long* __restrict__ part) {
    extern __shared__ __align__(128) unsigned char smem[];
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
    unsigned* cnt = reinterpret_cast<unsigned*>(keys + F_CAP);

    const int tid = threadIdx.x;
    const int r = blockIdx.x / n_splits, split = blockIdx.x - r * n_splits;
    const int lo = split * seg, hi = min(n, lo + seg);
    const T* row = x + static_cast<size_t>(r) * ld;
    // [a0, a1): the 16-byte-aligned middle, a whole number of 16 bytes
    const int mis = static_cast<int>(
        (reinterpret_cast<uintptr_t>(row + lo) >> 2) & 3);
    const int a0 = min(hi, lo + ((4 - mis) & 3));
    const int a1 = a0 + ((hi - a0) & ~3);
    const int n_st = (a1 - a0 + F_STAGE - 1) / F_STAGE;
    // merge once the queue holds max(k, F_EAGER) keys, so that tau tightens
    // while it is loose, and at the latest past FILL = F_CAP - k - F_STAGE,
    // so that the next group's at most F_STAGE pushes still fit
    const unsigned eager = static_cast<unsigned>(
        min(F_CAP - k - F_STAGE + 1, max(k, F_EAGER)));

    for (int i = tid; i < k; i += F_THREADS) keys[i] = NONE;
    if (tid == 0) *cnt = 0;
    __syncthreads();
    {   // the ragged head and tail, at most three elements each: the list
        // is empty, so each goes to the queue
        const int nh = a0 - lo, nt = hi - a1;
        if (tid < nh + nt) {
            const int e = tid < nh ? lo + tid : a1 + (tid - nh);
            keys[k + atomicAdd(cnt, 1u)] = sort_key(row[e], e);
        }
    }
    // thread tid's elements of stage st: 4 (tid + u F_THREADS) + q
    auto fetch = [&](int st, T (&v)[F_PER]) {
        const int e0 = a0 + st * F_STAGE, m = min(F_STAGE, a1 - e0);
#pragma unroll
        for (int u = 0; u < F_PER / 4; ++u) {
            const int off = 4 * (tid + u * F_THREADS);
            if (off < m) load4(row + e0 + off, v + 4 * u);
        }
    };
    unsigned long long tau = NONE;
    T lim = bound(static_cast<unsigned>(tau >> 32), T());
    auto filter = [&](int st, const T (&v)[F_PER]) {
        const int e0 = a0 + st * F_STAGE, m = min(F_STAGE, a1 - e0);
        // the first stage goes in F_FIRST push groups, so that the first
        // merge sorts a short queue; later stages in one
        const int groups = st == 0 ? F_FIRST : 1;
        for (int g = 0; g < groups; ++g) {
            const int u0 = g * (F_PER / 4) / groups;
            const int u1 = (g + 1) * (F_PER / 4) / groups;
            bool any = false;
#pragma unroll
            for (int u = 0; u < F_PER / 4; ++u)
                if (u >= u0 && u < u1 && 4 * (tid + u * F_THREADS) < m)
#pragma unroll
                    for (int q = 0; q < 4; ++q) any |= !(v[4 * u + q] > lim);
            unsigned len = 0;
            if (__any_sync(FULL, any)) {   // the warp has a candidate
                // the lane's keys below tau, as a mask; one atomic a warp
                // reserves their slots, and they are formed again to store
                unsigned mask = 0;
#pragma unroll
                for (int u = 0; u < F_PER / 4; ++u) {
                    const int off = 4 * (tid + u * F_THREADS);
                    if (u >= u0 && u < u1 && off < m)
#pragma unroll
                        for (int q = 0; q < 4; ++q)
                            if (sort_key(v[4 * u + q], e0 + off + q) < tau)
                                mask |= 1u << (4 * u + q);
                }
                const uint2 slot = reserve(cnt, __popc(mask));
                unsigned at = k + slot.x;
#pragma unroll
                for (int i = 0; i < F_PER; ++i)
                    if (mask >> i & 1u)
                        keys[at++] = sort_key(
                            v[i], e0 + 4 * (tid + (i / 4) * F_THREADS) + i % 4);
                len = slot.y;
            }
            const bool over = len >= eager;
            // the group is consumed and every push has landed
            if (__syncthreads_or(over)) {
                tau = merge_list(keys, k, cnt);
                lim = bound(static_cast<unsigned>(tau >> 32), T());
            }
        }
    };
    // two register buffers: stage st + 1 loads while stage st is filtered
    T va[F_PER], vb[F_PER];
    if (n_st > 0) fetch(0, va);
    for (int st = 0; st < n_st; st += 2) {
        if (st + 1 < n_st) fetch(st + 1, vb);
        filter(st, va);
        if (st + 1 >= n_st) break;
        if (st + 2 < n_st) fetch(st + 2, va);
        filter(st + 1, vb);
    }
    __syncthreads();
    if (*cnt > 0) merge_list(keys, k, cnt);
    if (n_splits == 1) {
        for (int j = tid; j < k; j += F_THREADS) {
            const int e = static_cast<int>(static_cast<unsigned>(keys[j]));
            idx[static_cast<size_t>(r) * k + j] = e;
            vals[static_cast<size_t>(r) * k + j] = row[e];
        }
    } else {
        for (int j = tid; j < k; j += F_THREADS)
            part[static_cast<size_t>(blockIdx.x) * k + j] = keys[j];
    }
}

template <typename T>
int launch_topk(const T* x, long long ld, int R, int n, int k, T* vals,
                int* idx, unsigned long long* part, int n_splits, int seg,
                int filter, void* stream) {
    if (R < 1 || n < 1 || k < 1 || k > n || ld < n ||
        n > INT_MAX - UNROLL * TK_THREADS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (!filter) {
        radix_kernel<T><<<R, TK_THREADS, 0, s>>>(x, ld, n, k, vals, idx);
        return (int)cudaGetLastError();
    }
    if (k > FILTER_K_MAX || n_splits < 1 || seg < 1 ||
        static_cast<long long>(n_splits - 1) * seg >= n ||
        static_cast<long long>(n_splits) * seg < n ||
        (n_splits > 1 && (part == nullptr || n_splits * k > MERGE_KEYS)))
        return (int)cudaErrorInvalidValue;
    if (static_cast<long long>(R) * n_splits > INT_MAX)
        return (int)cudaErrorInvalidConfiguration;
    static bool sized = false;
    if (!sized) {
        cudaError_t err = cudaFuncSetAttribute(
            filter_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(F_SMEM));
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                filter_kernel<T>,
                cudaFuncAttributePreferredSharedMemoryCarveout,
                cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return (int)err;
        sized = true;
    }
    filter_kernel<T><<<R * n_splits, F_THREADS, F_SMEM, s>>>(
        x, ld, n, k, seg, n_splits, vals, idx, part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_splits == 1) return (int)err;
    ksel::split_merge_kernel<T, false><<<R, ksel::MERGE_THREADS, 0, s>>>(
        x, ld, k, n_splits, part, vals, idx);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int topk_filter_k_max() { return FILTER_K_MAX; }
int topk_merge_keys() { return MERGE_KEYS; }

// x: R rows of n fp32, row r at x + r * ld (ld >= n) -> vals/idx (R, k)
// row-major.  1 <= k <= n.  filter: 1 for the filter route (k <=
// FILTER_K_MAX), 0 for the radix route; the filter route's rows go in
// n_splits splits of seg elements (none empty), and with more than one
// split ``part`` holds R * n_splits * k keys of scratch (n_splits * k <=
// MERGE_KEYS).  Returns the first CUDA error.
int topk_smallest_f32(const float* x, long long ld, int R, int n, int k,
                      float* vals, int* idx, unsigned long long* part,
                      int n_splits, int seg, int filter, void* stream) {
    return launch_topk<float>(x, ld, R, n, k, vals, idx, part, n_splits, seg,
                              filter, stream);
}

// The int32 key mode: the same contract on int32 rows.
int topk_smallest_i32(const int* x, long long ld, int R, int n, int k,
                      int* vals, int* idx, unsigned long long* part,
                      int n_splits, int seg, int filter, void* stream) {
    return launch_topk<int>(x, ld, R, n, k, vals, idx, part, n_splits, seg,
                            filter, stream);
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
