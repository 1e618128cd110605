// The selection stage shared by B1 (distance_topk.cu, fp32 keys) and B6
// (quantized.cu, int32 keys): one sorted list of the k best (value, row)
// per query of a block, fed through short queues in shared memory, and the
// kernel that merges the blocks' lists of one query.
//
// A block scores QB queries against its rows.  Each query has
//  * a list of its k best so far, sorted by (value, row), in shared memory;
//  * a threshold tau, the list's last entry: the threads that score the
//    query compare each candidate with tau's value, so a candidate that
//    cannot rank before it is rejected with one compare;
//  * a queue of QCAP (value, row) slots: a candidate whose value is not
//    above tau's takes a slot by a shared-memory atomic.
// The scoring threads push in groups: within one push group a query takes
// at most GROUP candidates (the kernels arrange their rows so).  After a
// group the block synchronises (__syncthreads_or of "a queue passed
// FILL"), and if any queue holds more than FILL candidates, thread q of
// the block inserts the queue of query q into its list, which moves the
// threshold.  So a queue holds at most FILL + GROUP = QCAP candidates
// and no candidate is ever dropped: the block merges early instead.  Keys
// are (value, row) pairs with rows unique within a query, so the order is
// total and ties go to the smaller row.  The empty slot is Key<T>::none()
// with row INT_MAX, after every real row.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace bsel {

constexpr int QB = 128;          // queries of a block
constexpr int RB = 128;          // rows of a tile
constexpr int THREADS = 256;     // threads of a scoring block
constexpr int K_MAX = 32;        // longest list
constexpr int GROUP = 32;        // most pushes per query in one push group
constexpr int FILL = 8;          // a merge follows a group that leaves more
constexpr int QCAP = FILL + GROUP;
constexpr int MERGE_THREADS = 256;   // the split merge: a warp per query
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Key;

// fp32 (B1): NaN after every number, equal values (NaN with NaN too) to
// the smaller row; the empty slot is (NaN, INT_MAX)
template <>
struct Key<float> {
    __device__ static float none() { return CUDART_NAN_F; }
    __device__ static float lowest() { return -CUDART_INF_F; }
    __device__ static bool less(float v, int i, float w, int j) {
        const bool vn = v != v, wn = w != w;
        if (vn || wn) return vn ? (wn && i < j) : true;
        return v < w || (v == w && i < j);
    }
};

// int32 (B6): plain (value, row) order; real lattice distances stay far
// below INT_MAX, so (INT_MAX, INT_MAX) is the empty slot
template <>
struct Key<int> {
    __device__ static int none() { return INT_MAX; }
    __device__ static int lowest() { return INT_MIN; }
    __device__ static bool less(int v, int i, int w, int j) {
        return v < w || (v == w && i < j);
    }
};

__host__ __device__ constexpr size_t align16(size_t n) {
    return (n + 15) & ~static_cast<size_t>(15);
}

// bytes of the lists, queues and queue lengths of QB queries
__host__ __device__ constexpr size_t lists_bytes(int k) {
    return align16(static_cast<size_t>(QB) * k * 8) +
           static_cast<size_t>(QB) * QCAP * 8 + static_cast<size_t>(QB) * 4;
}

template <typename T>
struct Lists {
    T* lv;      // [k][QB] list values, sorted along k
    int* li;    // [k][QB] list rows
    T* qv;      // [QCAP][QB] queued values
    int* qi;    // [QCAP][QB] queued rows
    int* cnt;   // [QB] queue lengths
    int k;

    // query q's threshold: the value of its list's last entry
    __device__ T threshold(int q) const { return lv[(k - 1) * QB + q]; }
};

template <typename T>
__device__ __forceinline__ Lists<T> carve(unsigned char* base, int k) {
    Lists<T> L;
    L.lv = reinterpret_cast<T*>(base);
    L.li = reinterpret_cast<int*>(base + static_cast<size_t>(QB) * k * 4);
    unsigned char* p = base + align16(static_cast<size_t>(QB) * k * 8);
    L.qv = reinterpret_cast<T*>(p);
    L.qi = reinterpret_cast<int*>(p + static_cast<size_t>(QB) * QCAP * 4);
    p += static_cast<size_t>(QB) * QCAP * 8;
    L.cnt = reinterpret_cast<int*>(p);
    L.k = k;
    return L;
}

// every list empty, every queue empty; the caller synchronises after
template <typename T>
__device__ void init(const Lists<T>& L) {
    for (int e = threadIdx.x; e < QB * L.k; e += blockDim.x) {
        L.lv[e] = Key<T>::none();
        L.li[e] = INT_MAX;
    }
    for (int q = threadIdx.x; q < QB; q += blockDim.x) L.cnt[q] = 0;
}

// Queue (v, row) for query q.  The caller queues every candidate whose
// value is not above the threshold's (ties and NaN go on to the merge,
// which keeps only those that rank before the list's last entry).
// Returns true if the queue now holds more than FILL.
template <typename T>
__device__ __forceinline__ bool queue(const Lists<T>& L, int q, T v, int row) {
    const int slot = atomicAdd(&L.cnt[q], 1);
    L.qv[slot * QB + q] = v;
    L.qi[slot * QB + q] = row;
    return slot >= FILL;
}

// Thread q < QB merges the queue of query q into its list, one candidate
// at a time: a candidate that still ranks before the list's last entry
// moves the entries that rank after it one place down.  Lists and queues
// are stored query-minor, so the threads of a warp touch consecutive
// words.  Call between two block barriers.
template <typename T>
__device__ void merge(const Lists<T>& L) {
    const int q = threadIdx.x, k = L.k;
    if (q >= QB) return;
    const int c = L.cnt[q];
    if (c == 0) return;
    T wv = L.lv[(k - 1) * QB + q];
    int wi = L.li[(k - 1) * QB + q];
    for (int s = 0; s < c; ++s) {
        const T v = L.qv[s * QB + q];
        const int i = L.qi[s * QB + q];
        if (!Key<T>::less(v, i, wv, wi)) continue;
        int p = k - 1;
        for (; p > 0; --p) {
            const T pv = L.lv[(p - 1) * QB + q];
            const int pi = L.li[(p - 1) * QB + q];
            if (!Key<T>::less(v, i, pv, pi)) break;
            L.lv[p * QB + q] = pv;
            L.li[p * QB + q] = pi;
        }
        L.lv[p * QB + q] = v;
        L.li[p * QB + q] = i;
        wv = L.lv[(k - 1) * QB + q];
        wi = L.li[(k - 1) * QB + q];
    }
    L.cnt[q] = 0;
}

// the block's lists, as split ``split`` of queries q0.. (Q in all):
// part[(q * n_splits + split) * k + j]
template <typename T>
__device__ void write_lists(const Lists<T>& L, T* part_v, int* part_i, int q0,
                            int Q, int split, int n_splits) {
    const int k = L.k;
    for (int e = threadIdx.x; e < QB * k; e += blockDim.x) {
        const int q = e / k, j = e - q * k;
        if (q0 + q < Q) {
            const size_t at = (static_cast<size_t>(q0 + q) * n_splits + split)
                              * k + j;
            part_v[at] = L.lv[j * QB + q];
            part_i[at] = L.li[j * QB + q];
        }
    }
}

// The n_splits lists of each query -> its k best.  A warp per query:
// k rounds, each taking the smallest (value, row) strictly after the
// previous pick (rows are unique across the lists, and k <= N real rows
// rank before the empty slots).
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_splits_kernel(const T* __restrict__ part_v,
                    const int* __restrict__ part_i, T* __restrict__ vals,
                    int* __restrict__ idx, int Q, int n_cand, int k) {
    const int q = (blockIdx.x * MERGE_THREADS + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (q >= Q) return;
    const T* v = part_v + static_cast<size_t>(q) * n_cand;
    const int* ix = part_i + static_cast<size_t>(q) * n_cand;
    T pv = Key<T>::lowest();
    int pi = INT_MIN;
    for (int r = 0; r < k; ++r) {
        T bv = Key<T>::none();
        int bi = INT_MAX;
        for (int t = lane; t < n_cand; t += 32) {
            const T cv = v[t];
            const int ci = ix[t];
            if (Key<T>::less(pv, pi, cv, ci) && Key<T>::less(cv, ci, bv, bi)) {
                bv = cv;
                bi = ci;
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const T ov = __shfl_xor_sync(FULL, bv, off);
            const int oi = __shfl_xor_sync(FULL, bi, off);
            if (Key<T>::less(ov, oi, bv, bi)) {
                bv = ov;
                bi = oi;
            }
        }
        if (lane == 0) {
            vals[static_cast<size_t>(q) * k + r] = bv;
            idx[static_cast<size_t>(q) * k + r] = bi;
        }
        pv = bv;
        pi = bi;
    }
}

}  // namespace bsel
