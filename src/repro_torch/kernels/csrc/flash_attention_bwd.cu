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
// come to 1.7 GFLOP, 1.7 us at the bf16 tensor-core peak.  So bytes bind.
// This first design sums on the CUDA cores in fp32 (67 TFLOP/s), where
// the same work takes about 25 us at best, so arithmetic binds it; a
// wgmma design is later work.
//
// What the design does about it (the FlashAttention-2 split, with no
// atomics, so every run gives the same bits):
//  * ``bwd_rows``, over query tiles of 32 rows: recomputes each row's max
//    and log-sum-exp L over its keys (an online softmax, as B11 does, so
//    B11's source is not touched) and D = rowsum(dO * o), into two fp32
//    (B, H, S) scratch vectors;
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

}  // namespace

extern "C" {

int flash_attention_bwd_d_max() { return D_MAX; }

// q, k, v, o, dO (inputs) and dq, dk, dv (outputs): (B, H, S, d), each
// addressed by three element strides (batch, head, position) in that
// order in ``strides`` (24 values), the d axis contiguous.  lse, delta:
// fp32 scratch of B·H·S values each.  dtype: 0 fp32, 1 bf16 (every tensor
// of it).  d <= 256.  Returns the first CUDA error.
int flash_attention_bwd(int dtype, const void* q, const void* k,
                        const void* v, const void* o, const void* g, void* dq,
                        void* dk, void* dv, float* lse, float* delta, int B,
                        int H, int S, int d, int causal, float scale,
                        const long long* strides, void* stream) {
    if (B < 1 || H < 1 || S < 1 || d < 1 || d > D_MAX ||
        (long long)B * H > 2147483647LL || (S + TILE - 1) / TILE > 65535 ||
        (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    Strides st;
    for (int i = 0; i < NT; ++i)
        st.t[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
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
