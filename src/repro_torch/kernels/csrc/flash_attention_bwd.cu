// The backward pass of attention (B12), causal or full, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package computes its LM's attention
// in plain jnp ops (models/attention.py::full_attention) and trains it by
// XLA's autodiff, so it has no backward kernel.  The port's forward runs
// in the hand-written B11 (flash_attention.cu), whose output carries no
// autograd graph, so the port's training path needs this kernel for the
// gradient: given q, k, v, the forward's output o and the output's
// gradient dO, all (B, H, S, d),
//   P  = softmax(q k^T / sqrt(d))       (causal: keys past the query masked)
//   dV = P^T dO
//   dP = dO V^T,  D = rowsum(dO * o),  dS = P * (dP - D)
//   dQ = dS K / sqrt(d),  dK = dS^T Q / sqrt(d)
// in fp32, each output rounded once to q's dtype.
//
// What bounds it on an H100.  At the training path's shape (stablelm-3b:
// batch 8, 32 heads, S = 128, d = 80, bf16, causal) one call must read q,
// k, v, o and dO and write dq, dk and dv once: 42 MB, 12.5 us at
// 3.35 TB/s, while its 10·d multiply-adds per unmasked (query, key) pair
// come to 1.7 GFLOP, 1.7 us at the bf16 tensor-core peak (3.4 us with
// the split below).  So bytes bind, if the products run on the tensor
// cores: on the CUDA cores in fp32 (67 TFLOP/s) the same work takes
// about 25 us at best.
//
// Two routes, by a rule the caller applies (flash_attention_bwd.py::route)
// and the C entry checks:
//  * wgmma: bf16, d a multiple of 16 up to 128, every (batch, head,
//    position) stride of the eight tensors a multiple of 8 elements and
//    every base 16-byte aligned (B11's TMA rules; past d = 128 the dK and
//    dV sums, two 64 x d fp32 accumulators, do not fit a thread's
//    registers).  Two launches, below.
//  * cuda_core: every other case (fp32, any d <= 256): three launches of
//    fp32 sums on the CUDA cores, below the wgmma route in this file.
// Both are the FlashAttention-2 split with no atomics and a fixed
// schedule, so every run gives the same bits (remat and resume are
// bit-equal).
//
// The wgmma route:
//  * ``bwd_q_wgmma``, a block a query tile of 64 rows of one (batch,
//    head): a first walk over the key tiles the tile sees recomputes each
//    row's log-sum-exp L (an online softmax, as B11 does, so B11's source
//    is not touched) while D = rowsum(dO * o) is read from device memory,
//    and writes both for the second kernel; a second walk computes S =
//    Q K^T, P = exp(S·scale - L), dP = dO V^T, dS = P (dP - D) and dQ +=
//    dS K.  Causal query tiles go heaviest first: block y takes tile
//    n - 1 - y, and the grid's x axis runs over (batch, head), as in B11.
//  * ``bwd_kv_wgmma``, a block a key tile of 64 keys: keeps its K and V
//    tiles in shared memory and its dK and dV sums in registers, and
//    walks the query tiles that see it (causal: from the diagonal on, so
//    tile 0, the heaviest, comes first): S^T = K Q^T, P^T, dP^T = V
//    dO^T, dS^T, dV += P^T dO, dK += dS^T Q.
//  A block is one warpgroup, whose thread 0 loads tiles by TMA into a
//  ring of two stages and refills a stage once every warp is done with it.
//  It has no producer warp: the dK/dV kernel takes about 200 registers a
//  thread at d = 80, so a fifth warp would keep a second block off an
//  SM.  The tiles come through 4-D
//  TMA descriptors over the (batch, head, position) strides, as in B11,
//  so the models' (B, S, H, d) layout goes in without a copy and
//  positions past S load as zeros;
//  16-column boxes (32 bytes) with the 32-byte swizzle, which fits every
//  d that is a multiple of 16.  The score products (wgmma m64n64k16) take
//  both tiles from shared memory, K-major.  P (or P^T) and dS (or dS^T)
//  stay in registers as the A operand of the products that take them,
//  whose B tile (dO, Q or K: positions x d) goes in MN-major through the
//  descriptor's transpose bit, as B11 feeds v.  P and dS are fp32 values:
//  rounded once to bf16 (8 significant bits), the three products that
//  take them would miss the bar they are held to (1e-4 of the summed
//  terms), so each goes in as two bf16 terms, hi = bf16(x) and lo =
//  bf16(x - hi), each of those products is issued twice into one fp32
//  accumulator, and the operand keeps 16 bits.  The score products take
//  their bf16 inputs exactly, once each.  Folding the row statistics
//  into the dQ kernel saves a launch and a second read of each q tile
//  against a launch of their own (as the CUDA-core route has), and timed
//  faster so on an H100.
//
// The CUDA-core route (the first design, kept for what the wgmma route
// does not take):
//  * ``bwd_rows``, over query tiles of 32 rows: recomputes each row's max
//    and log-sum-exp L over its keys (an online softmax) and D =
//    rowsum(dO * o), into two fp32 (B, H, S) scratch vectors;
//  * ``bwd_dkdv``, over key tiles of 32 keys: holds its k and v tile and
//    its dK and dV sums (registers) and walks the query tiles that can
//    see it (causal: from the diagonal on), recomputing P = exp(s - L)
//    and dS for each (query, key) pair of the tile;
//  * ``bwd_dq``, over query tiles of 32 rows: holds its q and dO tile and
//    its dQ sums and walks the key tiles it can see (causal: up to the
//    diagonal), recomputing P and dS the same way.
// Every score is the same fp32 dot product in the same order in all three
// kernels, so P and dS are the same numbers in the two that use them.
// Tiles live in shared memory as fp32, rows padded to an odd length so
// that 32 lanes reading 32 different rows hit 32 banks; a block is 8
// warps, a warp 4 rows of the tile, a lane one key of a score tile and
// d/32 columns of a sum.  Any (batch, head, position) strides with d
// contiguous; any S >= 1 (rows and keys past S are masked, never stored);
// any d <= 256 (the column sums are templated on ceil(d / 32)).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <mutex>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int D_MAX = 256;
constexpr int TILE = 32;                // rows of a query tile, keys of a key tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = TILE / WARPS;       // tile rows a warp: 4

// the tensors' order in the strides array
enum { TQ = 0, TK, TV, TO, TG, TDQ, TDK, TDV, NT };

struct View {
    long long b, h, s;
};
struct Strides {
    View t[NT];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
    return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// padded row length of a tile in shared memory: odd, so the rows of 32
// lanes start in 32 different banks
__host__ __device__ __forceinline__ int row_len(int d) { return d | 1; }

__host__ __device__ __forceinline__ long long base(const View& v, int b,
                                                   int h) {
    return (long long)b * v.b + (long long)h * v.h;
}

// rows [r0, r0 + TILE) of one (batch, head) into dst[TILE][ld] as fp32,
// rows past S as zeros
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long rs, int r0, int S, int d,
                                          int ld) {
    for (int e = threadIdx.x; e < TILE * d; e += THREADS) {
        const int r = e / d, c = e % d;
        dst[r * ld + c] =
            (r0 + r < S) ? to_f(src[(long long)(r0 + r) * rs + c]) : 0.f;
    }
}

// the scaled score of one (query, key) pair: the same fp32 sum in the
// same order in every kernel of this file
__device__ __forceinline__ float score(const float* q, const float* k, int d,
                                       float scale) {
    float s = 0.f;
    for (int c = 0; c < d; ++c) s = fmaf(q[c], k[c], s);
    return s * scale;
}

__device__ __forceinline__ bool visible(int qrow, int key, int S,
                                        int causal) {
    return qrow < S && key < S && (!causal || key <= qrow);
}

// Row statistics: L = max + log(sum exp(s - max)) over each query row's
// visible keys, and D = rowsum(dO * o).
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_rows(const T* __restrict__ Q, const T* __restrict__ K,
         const T* __restrict__ O, const T* __restrict__ G,
         float* __restrict__ lse, float* __restrict__ delta, int H, int S,
         int d, int causal, float scale, Strides st) {
    extern __shared__ float smem[];
    const int ld = row_len(d);
    float* qs = smem;                   // [TILE][ld]
    float* ks = qs + TILE * ld;         // [TILE][ld]
    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int q0 = blockIdx.y * TILE;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    load_tile(qs, Q + base(st.t[TQ], b, h), st.t[TQ].s, q0, S, d, ld);
    float m[RPW], l[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
    }
    int n_tiles = (S + TILE - 1) / TILE;
    if (causal) n_tiles = min(n_tiles, q0 / TILE + 1);
    const T* kb = K + base(st.t[TK], b, h);
    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * TILE;
        __syncthreads();
        load_tile(ks, kb, st.t[TK].s, k0, S, d, ld);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
            const int r = warp * RPW + i;
            const bool ok = visible(q0 + r, k0 + lane, S, causal);
            const float s =
                ok ? score(qs + r * ld, ks + lane * ld, d, scale) : -INFINITY;
            const float mn = fmaxf(m[i], warp_max(s));
            if (mn == -INFINITY) continue;          // the whole warp alike
            const float p = ok ? expf(s - mn) : 0.f;
            l[i] = l[i] * expf(m[i] - mn) + warp_sum(p);
            m[i] = mn;
        }
    }
    const T* ob = O + base(st.t[TO], b, h);
    const T* gb = G + base(st.t[TG], b, h);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        const int qrow = q0 + warp * RPW + i;
        if (qrow >= S) continue;
        float acc = 0.f;
        for (int c = lane; c < d; c += 32)
            acc = fmaf(to_f(gb[qrow * st.t[TG].s + c]),
                       to_f(ob[qrow * st.t[TO].s + c]), acc);
        acc = warp_sum(acc);
        if (lane == 0) {
            lse[(long long)bh * S + qrow] = m[i] + logf(l[i]);
            delta[(long long)bh * S + qrow] = acc;
        }
    }
}

// dK and dV of one key tile, over the query tiles that see it.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv(const T* __restrict__ Q, const T* __restrict__ K,
         const T* __restrict__ V, const T* __restrict__ G,
         const float* __restrict__ lse, const float* __restrict__ delta,
         T* __restrict__ dK, T* __restrict__ dV, int H, int S, int d,
         int causal, float scale, Strides st) {
    extern __shared__ float smem[];
    const int ld = row_len(d);
    float* ks = smem;                   // [TILE][ld]
    float* vs = ks + TILE * ld;         // [TILE][ld]
    float* qs = vs + TILE * ld;         // [TILE][ld]
    float* gs = qs + TILE * ld;         // [TILE][ld]  dO
    float* ps = gs + TILE * ld;         // [TILE][TILE + 1]  P (query, key)
    float* dss = ps + TILE * (TILE + 1);  // [TILE][TILE + 1]  dS
    float* ls = dss + TILE * (TILE + 1);  // [TILE]
    float* dl = ls + TILE;                // [TILE]
    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int k0 = blockIdx.y * TILE;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    load_tile(ks, K + base(st.t[TK], b, h), st.t[TK].s, k0, S, d, ld);
    load_tile(vs, V + base(st.t[TV], b, h), st.t[TV].s, k0, S, d, ld);
    float acc_k[RPW][NJ], acc_v[RPW][NJ];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

    const T* qb = Q + base(st.t[TQ], b, h);
    const T* gb = G + base(st.t[TG], b, h);
    const int n_tiles = (S + TILE - 1) / TILE;
    for (int t = causal ? k0 / TILE : 0; t < n_tiles; ++t) {
        const int q0 = t * TILE;
        __syncthreads();
        load_tile(qs, qb, st.t[TQ].s, q0, S, d, ld);
        load_tile(gs, gb, st.t[TG].s, q0, S, d, ld);
        if (threadIdx.x < TILE) {
            const int qrow = q0 + threadIdx.x;
            ls[threadIdx.x] = qrow < S ? lse[(long long)bh * S + qrow] : 0.f;
            dl[threadIdx.x] = qrow < S ? delta[(long long)bh * S + qrow] : 0.f;
        }
        __syncthreads();
        // P and dS of the tile: a warp's 4 query rows, a lane's key
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
            const int r = warp * RPW + i;
            float p = 0.f, ds = 0.f;
            if (visible(q0 + r, k0 + lane, S, causal)) {
                p = expf(score(qs + r * ld, ks + lane * ld, d, scale) - ls[r]);
                ds = p * (score(gs + r * ld, vs + lane * ld, d, 1.f) - dl[r]);
            }
            ps[r * (TILE + 1) + lane] = p;
            dss[r * (TILE + 1) + lane] = ds;
        }
        __syncthreads();
        // dV += P^T dO, dK += dS^T Q over the tile's query rows: a warp's
        // 4 keys, a lane's columns
        for (int r = 0; r < TILE; ++r) {
            float pr[RPW], dr[RPW];
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
                pr[i] = ps[r * (TILE + 1) + warp * RPW + i];
                dr[i] = dss[r * (TILE + 1) + warp * RPW + i];
            }
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int c = lane + 32 * j;
                if (c < d) {
                    const float g = gs[r * ld + c], q = qs[r * ld + c];
#pragma unroll
                    for (int i = 0; i < RPW; ++i) {
                        acc_v[i][j] = fmaf(pr[i], g, acc_v[i][j]);
                        acc_k[i][j] = fmaf(dr[i], q, acc_k[i][j]);
                    }
                }
            }
        }
    }
    T* dkb = dK + base(st.t[TDK], b, h);
    T* dvb = dV + base(st.t[TDV], b, h);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        const int key = k0 + warp * RPW + i;
        if (key >= S) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int c = lane + 32 * j;
            if (c < d) {
                dkb[key * st.t[TDK].s + c] = from_f<T>(acc_k[i][j] * scale);
                dvb[key * st.t[TDV].s + c] = from_f<T>(acc_v[i][j]);
            }
        }
    }
}

// dQ of one query tile, over the key tiles it sees.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
bwd_dq(const T* __restrict__ Q, const T* __restrict__ K,
       const T* __restrict__ V, const T* __restrict__ G,
       const float* __restrict__ lse, const float* __restrict__ delta,
       T* __restrict__ dQ, int H, int S, int d, int causal, float scale,
       Strides st) {
    extern __shared__ float smem[];
    const int ld = row_len(d);
    float* qs = smem;                   // [TILE][ld]
    float* gs = qs + TILE * ld;         // [TILE][ld]  dO
    float* ks = gs + TILE * ld;         // [TILE][ld]
    float* vs = ks + TILE * ld;         // [TILE][ld]
    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int q0 = blockIdx.y * TILE;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    load_tile(qs, Q + base(st.t[TQ], b, h), st.t[TQ].s, q0, S, d, ld);
    load_tile(gs, G + base(st.t[TG], b, h), st.t[TG].s, q0, S, d, ld);
    float lr[RPW], dr[RPW], acc[RPW][NJ];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        const int qrow = q0 + warp * RPW + i;
        lr[i] = qrow < S ? lse[(long long)bh * S + qrow] : 0.f;
        dr[i] = qrow < S ? delta[(long long)bh * S + qrow] : 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    }
    const T* kb = K + base(st.t[TK], b, h);
    const T* vb = V + base(st.t[TV], b, h);
    int n_tiles = (S + TILE - 1) / TILE;
    if (causal) n_tiles = min(n_tiles, q0 / TILE + 1);
    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * TILE;
        __syncthreads();
        load_tile(ks, kb, st.t[TK].s, k0, S, d, ld);
        load_tile(vs, vb, st.t[TV].s, k0, S, d, ld);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
            const int r = warp * RPW + i;
            float ds = 0.f;
            if (visible(q0 + r, k0 + lane, S, causal)) {
                const float p =
                    expf(score(qs + r * ld, ks + lane * ld, d, scale) - lr[i]);
                ds = p * (score(gs + r * ld, vs + lane * ld, d, 1.f) - dr[i]);
            }
            // dQ += dS K: lane kk's dS against key kk's row
            for (int kk = 0; kk < TILE; ++kk) {
                const float dsk = __shfl_sync(0xffffffffu, ds, kk);
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    const int c = lane + 32 * j;
                    if (c < d) acc[i][j] = fmaf(dsk, ks[kk * ld + c], acc[i][j]);
                }
            }
        }
    }
    T* dqb = dQ + base(st.t[TDQ], b, h);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        const int qrow = q0 + warp * RPW + i;
        if (qrow >= S) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int c = lane + 32 * j;
            if (c < d) dqb[qrow * st.t[TDQ].s + c] = from_f<T>(acc[i][j] * scale);
        }
    }
}

__host__ constexpr int rows_smem(int d) {
    return 2 * TILE * (d | 1) * (int)sizeof(float);
}
__host__ constexpr int dkdv_smem(int d) {
    return (4 * TILE * (d | 1) + 2 * TILE * (TILE + 1) + 2 * TILE) *
           (int)sizeof(float);
}
__host__ constexpr int dq_smem(int d) {
    return 4 * TILE * (d | 1) * (int)sizeof(float);
}

template <typename T, int NJ>
cudaError_t run(const void* q, const void* k, const void* v, const void* o,
                const void* g, void* dq, void* dk, void* dv, float* lse,
                float* delta, int B, int H, int S, int d, int causal,
                float scale, const Strides& st, cudaStream_t s) {
    static std::once_flag once;
    static cudaError_t attr = cudaSuccess;
    std::call_once(once, [] {
        attr = cudaFuncSetAttribute(bwd_rows<T>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    rows_smem(D_MAX));
        if (attr == cudaSuccess)
            attr = cudaFuncSetAttribute(
                bwd_dkdv<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                dkdv_smem(32 * NJ));
        if (attr == cudaSuccess)
            attr = cudaFuncSetAttribute(
                bwd_dq<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                dq_smem(32 * NJ));
    });
    if (attr != cudaSuccess) return attr;
    const dim3 grid(B * H, (S + TILE - 1) / TILE);
    const T* Q = static_cast<const T*>(q);
    const T* K = static_cast<const T*>(k);
    const T* V = static_cast<const T*>(v);
    const T* O = static_cast<const T*>(o);
    const T* G = static_cast<const T*>(g);
    bwd_rows<T><<<grid, THREADS, rows_smem(d), s>>>(Q, K, O, G, lse, delta, H,
                                                    S, d, causal, scale, st);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_dkdv<T, NJ><<<grid, THREADS, dkdv_smem(d), s>>>(
        Q, K, V, G, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, S,
        d, causal, scale, st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_dq<T, NJ><<<grid, THREADS, dq_smem(d), s>>>(
        Q, K, V, G, lse, delta, static_cast<T*>(dq), H, S, d, causal, scale,
        st);
    return cudaGetLastError();
}

template <typename T>
cudaError_t run_d(const void* q, const void* k, const void* v, const void* o,
                  const void* g, void* dq, void* dk, void* dv, float* lse,
                  float* delta, int B, int H, int S, int d, int causal,
                  float scale, const Strides& st, cudaStream_t s) {
    switch ((d + 31) / 32) {
#define BWD_CASE(NJ)                                                        \
    case NJ:                                                                \
        return run<T, NJ>(q, k, v, o, g, dq, dk, dv, lse, delta, B, H, S, d, \
                          causal, scale, st, s);
        BWD_CASE(1) BWD_CASE(2) BWD_CASE(3) BWD_CASE(4) BWD_CASE(5)
        BWD_CASE(6) BWD_CASE(7) BWD_CASE(8)
#undef BWD_CASE
        default: return cudaErrorInvalidValue;
    }
}


// ------------------------------------------------------- bf16, wgmma

constexpr int WT = 64;           // rows of a query tile, keys of a key tile
constexpr int WG_D_MAX = 128;    // head dims of the wgmma route
constexpr int CHUNK = WT * 32;   // bytes of a 16-column chunk of a tile
constexpr float NEG_INF = -INFINITY;

template <int D>
struct BwCfg {
    static constexpr int THREADS = 128;        // one warpgroup
    static constexpr int DC = D / 16;          // 16-column chunks
    static constexpr int TILE = DC * CHUNK;    // bytes of a 64 x D tile
    static constexpr int STAGES = 2;
    static constexpr int STAGE = 2 * TILE;     // two tiles a stage
    // the block's own two tiles, the ring, then the barriers
    static constexpr int BAR_OFF = 2 * TILE + STAGES * STAGE;
    static constexpr int SMEM = BAR_OFF + (STAGES + 1) * 8 + 1024;
};

__device__ __forceinline__ uint8_t* align_smem(uint8_t* raw) {
    return reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) &
        ~static_cast<uintptr_t>(1023));
}

// wgmma descriptors of a tile's parts: its 16-column chunk kk, K-major (a
// score product's operand: 32-byte rows, 8-row atoms 256 B apart), and
// its 16 rows of k-step j, MN-major (the B operand of a product that
// takes P or dS: 16-column chunks CHUNK apart)
__device__ __forceinline__ uint64_t k_major(const uint8_t* tile, int kk) {
    return hop::make_desc(tile + kk * CHUNK, 16, 256, hop::SWIZZLE_32B);
}
__device__ __forceinline__ uint64_t mn_major(const uint8_t* tile, int j) {
    return hop::make_desc(tile + j * 16 * 32, CHUNK, 256, hop::SWIZZLE_32B);
}

// acc (64 x 64) += A B^T over the D columns of two 64 x D tiles
template <int DC>
__device__ __forceinline__ void scores(float (&acc)[32], const uint8_t* a,
                                       const uint8_t* b) {
#pragma unroll
    for (int kk = 0; kk < DC; ++kk)
        WgmmaSS<64>::template run<0, 0>(acc, k_major(a, kk), k_major(b, kk),
                                        1);
}

// x (64 x 64 in the accumulator's layout) as wgmma A fragments (16 keys
// or queries a k-step, four words a step) in two bf16 terms: hi =
// bf16(x), lo = bf16(x - hi), so hi + lo keeps 16 significant bits
__device__ __forceinline__ void split(const float (&x)[32], uint32_t (&hi)[16],
                                      uint32_t (&lo)[16]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
        const float2 hf = __bfloat1622float2(h);
        const __nv_bfloat162 l =
            __floats2bfloat162_rn(x[2 * i] - hf.x, x[2 * i + 1] - hf.y);
        hi[i] = *reinterpret_cast<const uint32_t*>(&h);
        lo[i] = *reinterpret_cast<const uint32_t*>(&l);
    }
}

// acc (64 x D) += X T: X as (hi, lo) fragments, T a 64 x D tile taken
// MN-major; each k-step issued for hi, then for lo
template <int D>
__device__ __forceinline__ void split_product(float (&acc)[D / 2],
                                              const uint32_t (&hi)[16],
                                              const uint32_t (&lo)[16],
                                              const uint8_t* t) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        WgmmaRS<D>::template run<1>(acc, hi[4 * j], hi[4 * j + 1],
                                    hi[4 * j + 2], hi[4 * j + 3],
                                    mn_major(t, j), 1);
        WgmmaRS<D>::template run<1>(acc, lo[4 * j], lo[4 * j + 1],
                                    lo[4 * j + 2], lo[4 * j + 3],
                                    mn_major(t, j), 1);
    }
}

// one 64 x D tile at position row0 of (batch b, head h) into dst by TMA,
// completing on bar
template <int DC>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row0, int h,
                                         int b) {
#pragma unroll
    for (int c = 0; c < DC; ++c)
        hop::tma_load_4d(dst + c * CHUNK, map, bar, c * 16, row0, h, b);
}

template <int STAGES>
__device__ __forceinline__ void init_barriers(uint64_t* full,
                                              uint64_t* fixed) {
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) hop::mbar_init(&full[s], 1);
        hop::mbar_init(fixed, 1);
        hop::fence_barrier_init();
    }
    __syncthreads();
}

// a thread's part of rowsum(g * o) over one row of D columns: the four
// threads of a row take its 16-byte chunks in turn
template <int D>
__device__ __forceinline__ float row_dot(const bf16* g, const bf16* o,
                                         int quarter) {
    float acc = 0.f;
#pragma unroll
    for (int c = quarter; c < D / 8; c += 4) {
        const uint4 x = *reinterpret_cast<const uint4*>(g + c * 8);
        const uint4 y = *reinterpret_cast<const uint4*>(o + c * 8);
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
            const float2 a = __bfloat1622float2(xp[w]);
            const float2 b = __bfloat1622float2(yp[w]);
            acc = fmaf(a.y, b.y, fmaf(a.x, b.x, acc));
        }
    }
    return acc;
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Query tiles: the row statistics L and D of the block's tile (written
// for bwd_kv_wgmma), then dQ.  grid (B·H, query tiles).
template <int D>
__global__ void __launch_bounds__(BwCfg<D>::THREADS, 1)
bwd_q_wgmma(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_g,
            const bf16* __restrict__ O, const bf16* __restrict__ G,
            bf16* __restrict__ dQ, float* __restrict__ lse,
            float* __restrict__ delta, int H, int S, int causal, float scale,
            Strides st) {
    using F = BwCfg<D>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = align_smem(smem_raw);
    uint8_t* qs = smem;                  // the block's q tile
    uint8_t* gs = smem + F::TILE;        // and its dO tile
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + F::BAR_OFF);
    uint64_t* fixed = full + F::STAGES;
    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int qt = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                          : (int)blockIdx.y;
    const int q0 = qt * WT;
    int n_tiles = (S + WT - 1) / WT;
    if (causal) n_tiles = min(n_tiles, qt + 1);
    // two walks over the key tiles: 0 the statistics (k), 1 dQ (k and
    // v); load i of the ring is walk i / n_tiles, key tile i % n_tiles
    const int n_loads = 2 * n_tiles;
    auto load = [&](int i) {
        const int walk = i / n_tiles, t = i % n_tiles;
        uint64_t* bar = &full[i % F::STAGES];
        uint8_t* ks = smem + 2 * F::TILE + (i % F::STAGES) * F::STAGE;
        hop::mbar_expect_tx(bar, walk ? 2 * F::TILE : F::TILE);
        tma_tile<F::DC>(ks, &tm_k, bar, t * WT, h, b);
        if (walk) tma_tile<F::DC>(ks + F::TILE, &tm_v, bar, t * WT, h, b);
    };
    init_barriers<F::STAGES>(full, fixed);
    if (threadIdx.x == 0) {
        hop::mbar_expect_tx(fixed, 2 * F::TILE);
        tma_tile<F::DC>(qs, &tm_q, fixed, q0, h, b);
        tma_tile<F::DC>(gs, &tm_g, fixed, q0, h, b);
        for (int i = 0; i < min(F::STAGES, n_loads); ++i) load(i);
    }
    // load i's stage once it has landed; once every warp is done with
    // it, thread 0 loads i + STAGES into it
    auto stage_of = [&](int i) {
        hop::mbar_wait(&full[i % F::STAGES], (i / F::STAGES) & 1);
        return smem + 2 * F::TILE + (i % F::STAGES) * F::STAGE;
    };
    auto release = [&](int i) {
        __syncthreads();
        if (threadIdx.x == 0 && i + F::STAGES < n_loads) load(i + F::STAGES);
    };

    // s[4n + e]: key 8n + 2(lane % 4) + (e & 1) of the key tile, row r_lo
    // (e < 2) or r_hi
    const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
    const int r_lo = q0 + warp * 16 + lane / 4, r_hi = r_lo + 8;
    const long long row0 = (long long)bh * S;
    int i_load = 0;
    // D = rowsum(dO * o) from device memory, while the tiles land
    const bf16* ob = O + base(st.t[TO], b, h);
    const bf16* gb = G + base(st.t[TG], b, h);
    const float D_lo =
        quad_sum(r_lo < S ? row_dot<D>(gb + r_lo * st.t[TG].s,
                                       ob + r_lo * st.t[TO].s, lane & 3)
                          : 0.f);
    const float D_hi =
        quad_sum(r_hi < S ? row_dot<D>(gb + r_hi * st.t[TG].s,
                                       ob + r_hi * st.t[TO].s, lane & 3)
                          : 0.f);
    hop::mbar_wait(fixed, 0);
    float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
    for (int t = 0; t < n_tiles; ++t, ++i_load) {
        const uint8_t* ks = stage_of(i_load);
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        hop::wg_fence();
        scores<F::DC>(s, qs, ks);
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::fence_regs(s);
        release(i_load);
        const int k0 = t * WT;
        float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
                const int row = (e < 2) ? r_lo : r_hi;
                const bool ok = key < S && (!causal || key <= row);
                s[4 * n + e] = ok ? s[4 * n + e] * scale : NEG_INF;
            }
            mx_lo = fmaxf(mx_lo, fmaxf(s[4 * n], s[4 * n + 1]));
            mx_hi = fmaxf(mx_hi, fmaxf(s[4 * n + 2], s[4 * n + 3]));
        }
        const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
        const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
        // nothing is summed while the max is still -inf
        const float corr_lo = (m_lo == NEG_INF) ? 0.f : expf(m_lo - mn_lo);
        const float corr_hi = (m_hi == NEG_INF) ? 0.f : expf(m_hi - mn_hi);
        m_lo = mn_lo;
        m_hi = mn_hi;
        float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float m = (e < 2) ? mn_lo : mn_hi;
                const float p = (s[4 * n + e] == NEG_INF)
                    ? 0.f : expf(s[4 * n + e] - m);
                if (e < 2) sum_lo += p; else sum_hi += p;
            }
        }
        l_lo = l_lo * corr_lo + sum_lo;   // this thread's keys only
        l_hi = l_hi * corr_hi + sum_hi;
    }
    const float L_lo = m_lo + logf(quad_sum(l_lo));
    const float L_hi = m_hi + logf(quad_sum(l_hi));
    if ((lane & 3) == 0) {
        if (r_lo < S) {
            lse[row0 + r_lo] = L_lo;
            delta[row0 + r_lo] = D_lo;
        }
        if (r_hi < S) {
            lse[row0 + r_hi] = L_hi;
            delta[row0 + r_hi] = D_hi;
        }
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    for (int t = 0; t < n_tiles; ++t, ++i_load) {
        const uint8_t* ks = stage_of(i_load);
        const uint8_t* vs = ks + F::TILE;
        // S = Q K^T and dP = dO V^T: 64 rows x 64 keys each
        float s[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
        hop::wg_fence();
        scores<F::DC>(s, qs, ks);
        scores<F::DC>(dp, gs, vs);
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::fence_regs(s);
        hop::fence_regs(dp);
        const int k0 = t * WT;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
                const int row = (e < 2) ? r_lo : r_hi;
                const bool ok =
                    key < S && row < S && (!causal || key <= row);
                const float p = ok ? expf(s[4 * n + e] * scale -
                                          ((e < 2) ? L_lo : L_hi))
                                   : 0.f;
                dp[4 * n + e] = p * (dp[4 * n + e] -
                                     ((e < 2) ? D_lo : D_hi));
            }
        }
        // dQ += dS K: K's (keys, d) tile MN-major
        uint32_t hi[16], lo[16];
        split(dp, hi, lo);
        hop::wg_fence();
        split_product<D>(acc, hi, lo, ks);
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::fence_regs(acc);
        hop::fence_regs(hi);
        hop::fence_regs(lo);
        release(i_load);
    }
    bf16* dq = dQ + base(st.t[TDQ], b, h);
    const long long ds = st.t[TDQ].s;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
        const int c = i * 8 + (lane & 3) * 2;
        if (r_lo < S)
            *reinterpret_cast<__nv_bfloat162*>(dq + r_lo * ds + c) =
                __floats2bfloat162_rn(acc[4 * i] * scale,
                                      acc[4 * i + 1] * scale);
        if (r_hi < S)
            *reinterpret_cast<__nv_bfloat162*>(dq + r_hi * ds + c) =
                __floats2bfloat162_rn(acc[4 * i + 2] * scale,
                                      acc[4 * i + 3] * scale);
    }
}

// Key tiles: dK and dV of the block's 64 keys over the query tiles that
// see them, from the L and D in lse and delta.  grid (B·H, key tiles).
template <int D>
__global__ void __launch_bounds__(BwCfg<D>::THREADS, 1)
bwd_kv_wgmma(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_g,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dK, bf16* __restrict__ dV, int H, int S,
             int causal, float scale, Strides st) {
    using F = BwCfg<D>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = align_smem(smem_raw);
    uint8_t* ks = smem;                  // the block's k tile
    uint8_t* vs = smem + F::TILE;        // and its v tile
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + F::BAR_OFF);
    uint64_t* fixed = full + F::STAGES;
    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int k0 = blockIdx.y * WT;
    // load i of the ring: query tile t0 + i (causal: from the diagonal)
    const int t0 = causal ? (int)blockIdx.y : 0;
    const int n_loads = (S + WT - 1) / WT - t0;
    auto load = [&](int i) {
        uint64_t* bar = &full[i % F::STAGES];
        uint8_t* qs = smem + 2 * F::TILE + (i % F::STAGES) * F::STAGE;
        hop::mbar_expect_tx(bar, 2 * F::TILE);
        tma_tile<F::DC>(qs, &tm_q, bar, (t0 + i) * WT, h, b);
        tma_tile<F::DC>(qs + F::TILE, &tm_g, bar, (t0 + i) * WT, h, b);
    };
    init_barriers<F::STAGES>(full, fixed);
    if (threadIdx.x == 0) {
        hop::mbar_expect_tx(fixed, 2 * F::TILE);
        tma_tile<F::DC>(ks, &tm_k, fixed, k0, h, b);
        tma_tile<F::DC>(vs, &tm_v, fixed, k0, h, b);
        for (int i = 0; i < min(F::STAGES, n_loads); ++i) load(i);
    }

    // s[4n + e]: query 8n + 2(lane % 4) + (e & 1) of the query tile, key
    // key_lo (e < 2) or key_hi
    const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
    const int key_lo = k0 + warp * 16 + lane / 4, key_hi = key_lo + 8;
    const float* lb = lse + (long long)bh * S;
    const float* db = delta + (long long)bh * S;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    hop::mbar_wait(fixed, 0);
    for (int i_load = 0; i_load < n_loads; ++i_load) {
        // the stage once it has landed
        hop::mbar_wait(&full[i_load % F::STAGES], (i_load / F::STAGES) & 1);
        const uint8_t* qs =
            smem + 2 * F::TILE + (i_load % F::STAGES) * F::STAGE;
        const uint8_t* gs = qs + F::TILE;
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each
        float s[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
        hop::wg_fence();
        scores<F::DC>(s, ks, qs);
        scores<F::DC>(dp, vs, gs);
        hop::wg_commit();
        // the L and D of this thread's 16 queries, while the products run
        const int q0 = (t0 + i_load) * WT;
        float Lq[16], Dq[16];
#pragma unroll
        for (int c = 0; c < 16; ++c) {
            const int q = q0 + (c / 2) * 8 + (lane & 3) * 2 + (c & 1);
            Lq[c] = q < S ? lb[q] : 0.f;
            Dq[c] = q < S ? db[q] : 0.f;
        }
        hop::wg_wait<0>();
        hop::fence_regs(s);
        hop::fence_regs(dp);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int q = q0 + n * 8 + (lane & 3) * 2 + e;
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int i = 4 * n + 2 * half + e;
                    const int key = half ? key_hi : key_lo;
                    const bool ok = q < S && key < S && (!causal || key <= q);
                    const float p =
                        ok ? expf(s[i] * scale - Lq[2 * n + e]) : 0.f;
                    s[i] = p;
                    dp[i] = p * (dp[i] - Dq[2 * n + e]);
                }
            }
        }
        // dV += P^T dO and dK += dS^T Q: dO's and Q's (queries, d) tiles
        // MN-major
        uint32_t p_hi[16], p_lo[16], ds_hi[16], ds_lo[16];
        split(s, p_hi, p_lo);
        split(dp, ds_hi, ds_lo);
        hop::wg_fence();
        split_product<D>(dv, p_hi, p_lo, gs);
        split_product<D>(dk, ds_hi, ds_lo, qs);
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::fence_regs(dv);
        hop::fence_regs(dk);
        hop::fence_regs(p_hi);
        hop::fence_regs(p_lo);
        hop::fence_regs(ds_hi);
        hop::fence_regs(ds_lo);
        // every warp is done with the stage: thread 0 refills it
        __syncthreads();
        if (threadIdx.x == 0 && i_load + F::STAGES < n_loads)
            load(i_load + F::STAGES);
    }
    bf16* dkb = dK + base(st.t[TDK], b, h);
    bf16* dvb = dV + base(st.t[TDV], b, h);
    const long long ks_ = st.t[TDK].s, vs_ = st.t[TDV].s;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
        const int c = i * 8 + (lane & 3) * 2;
        if (key_lo < S) {
            *reinterpret_cast<__nv_bfloat162*>(dkb + key_lo * ks_ + c) =
                __floats2bfloat162_rn(dk[4 * i] * scale,
                                      dk[4 * i + 1] * scale);
            *reinterpret_cast<__nv_bfloat162*>(dvb + key_lo * vs_ + c) =
                __floats2bfloat162_rn(dv[4 * i], dv[4 * i + 1]);
        }
        if (key_hi < S) {
            *reinterpret_cast<__nv_bfloat162*>(dkb + key_hi * ks_ + c) =
                __floats2bfloat162_rn(dk[4 * i + 2] * scale,
                                      dk[4 * i + 3] * scale);
            *reinterpret_cast<__nv_bfloat162*>(dvb + key_hi * vs_ + c) =
                __floats2bfloat162_rn(dv[4 * i + 2], dv[4 * i + 3]);
        }
    }
}

// 4-D TMA descriptor of a (B, H, S, d) bf16 tensor with element strides
// v and a unit d stride: 16-column boxes of WT positions of one (batch,
// head), 32-byte swizzle (B11's descriptor)
bool tile_map(CUtensorMap* map, const void* base_ptr, int B, int H, int S,
              int d, const View& v) {
    const uint64_t dims[4] = {(uint64_t)d, (uint64_t)S, (uint64_t)H,
                              (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)v.s * 2, (uint64_t)v.h * 2,
                                 (uint64_t)v.b * 2};
    const uint32_t box[4] = {16, (uint32_t)WT, 1, 1};
    return hop::tensor_map<4>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base_ptr,
                              dims, strides, box, CU_TENSOR_MAP_SWIZZLE_32B);
}

template <int D>
cudaError_t run_wgmma(const void* q, const void* k, const void* v,
                      const void* o, const void* g, void* dq, void* dk,
                      void* dv, float* lse, float* delta, int B, int H, int S,
                      int causal, float scale, const Strides& st,
                      cudaStream_t s) {
    using F = BwCfg<D>;
    static std::once_flag once;
    static cudaError_t attr = cudaSuccess;
    std::call_once(once, [] {
        const void* fns[2] = {(const void*)bwd_q_wgmma<D>,
                              (const void*)bwd_kv_wgmma<D>};
        for (const void* fn : fns)
            if (attr == cudaSuccess)
                attr = cudaFuncSetAttribute(
                    fn, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
    });
    if (attr != cudaSuccess) return attr;
    CUtensorMap tq{}, tk{}, tv{}, tg{};
    if (!tile_map(&tq, q, B, H, S, D, st.t[TQ]) ||
        !tile_map(&tk, k, B, H, S, D, st.t[TK]) ||
        !tile_map(&tv, v, B, H, S, D, st.t[TV]) ||
        !tile_map(&tg, g, B, H, S, D, st.t[TG]))
        return cudaErrorInvalidValue;
    const dim3 grid(B * H, (S + WT - 1) / WT);
    bwd_q_wgmma<D><<<grid, F::THREADS, F::SMEM, s>>>(
        tq, tk, tv, tg, static_cast<const bf16*>(o),
        static_cast<const bf16*>(g), static_cast<bf16*>(dq), lse, delta, H,
        S, causal, scale, st);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_kv_wgmma<D><<<grid, F::THREADS, F::SMEM, s>>>(
        tq, tk, tv, tg, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), H, S, causal, scale, st);
    return cudaGetLastError();
}
}  // namespace

extern "C" {

int flash_attention_bwd_d_max() { return D_MAX; }

// q, k, v, o, dO (inputs) and dq, dk, dv (outputs): (B, H, S, d), each
// addressed by three element strides (batch, head, position) in that
// order in ``strides`` (24 values), the d axis contiguous.  lse, delta:
// fp32 scratch of B·H·S values each.  dtype: 0 fp32, 1 bf16 (every tensor
// of it).  use_wgmma: the wgmma route (bf16, d a multiple of 16 up to
// 128, every stride a multiple of 8 and every base 16-byte aligned, or
// the call is refused); else the CUDA-core route, any d <= 256.  Returns
// the first CUDA error.
int flash_attention_bwd(int dtype, int use_wgmma, const void* q,
                        const void* k, const void* v, const void* o,
                        const void* g, void* dq, void* dk, void* dv,
                        float* lse, float* delta, int B, int H,
                        int S, int d, int causal, float scale,
                        const long long* strides, void* stream) {
    if (B < 1 || H < 1 || S < 1 || d < 1 || d > D_MAX ||
        (long long)B * H > 2147483647LL || (S + TILE - 1) / TILE > 65535 ||
        (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    Strides st;
    for (int i = 0; i < NT; ++i)
        st.t[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (use_wgmma) {
        bool ok = dtype == 1 && d % 16 == 0 && d <= WG_D_MAX;
        for (int i = 0; i < 3 * NT; ++i) ok = ok && strides[i] % 8 == 0;
        const void* ptrs[NT] = {q, k, v, o, g, dq, dk, dv};
        for (const void* p : ptrs)
            ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
        if (!ok) return (int)cudaErrorInvalidValue;
        switch (d) {
#define BWD_WG_CASE(DD)                                                     \
    case DD:                                                                \
        return (int)run_wgmma<DD>(q, k, v, o, g, dq, dk, dv, lse, delta, B, \
                                  H, S, causal, scale, st, s);
            BWD_WG_CASE(16) BWD_WG_CASE(32) BWD_WG_CASE(48) BWD_WG_CASE(64)
            BWD_WG_CASE(80) BWD_WG_CASE(96) BWD_WG_CASE(112) BWD_WG_CASE(128)
#undef BWD_WG_CASE
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (dtype == 1)
        return (int)run_d<bf16>(q, k, v, o, g, dq, dk, dv, lse, delta, B, H,
                                S, d, causal, scale, st, s);
    return (int)run_d<float>(q, k, v, o, g, dq, dk, dv, lse, delta, B, H, S,
                             d, causal, scale, st, s);
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
