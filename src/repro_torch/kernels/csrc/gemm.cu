// GEMM, C = A·B, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel B10 of the JAX package:
//   kernels/gemm.py::_matmul_kernel (matmul): A (M, K) @ B (K, N) -> C
//   (M, N) in A's dtype, an f32 accumulator carried across the K grid
//   axis and rounded once at the end.
// In the port it computes every dense projection of the LM stack (wq, wk,
// wv, wo, w_in, w_gate, w_out) and the unembedding, with the weights in
// the reference's (in, out) layout: B is the row-major (K, N) weight.
//
// What bounds it on an H100.  Prefill (M = batch x prompt = 2048, bf16):
// operations, 2MNK = 10.4 TFLOP for the whole of stablelm-3b, 10.5 ms at
// the 989 TFLOP/s bf16 tensor-core peak.  Decode (M = batch = 4): bytes,
// every weight read once, 5.33 GB a step, 1.59 ms at 3.35 TB/s.  The two
// regimes get two launch configurations:
//
//  * M > 16, bf16: a 128 x 128 output tile per block of 8 warps, the K
//    axis walked in 32-wide steps.  A and B tiles are staged in shared
//    memory by cp.async in two stages (the copy of step k+1 overlaps the
//    products of step k), read into registers by ldmatrix (B transposed
//    on the way), and multiplied by mma.sync m16n8k16 bf16 -> fp32: each
//    warp owns a 64 x 32 piece of the tile in 64 fp32 registers.  Rows
//    are padded by 8 elements so that ldmatrix reads are free of bank
//    conflicts.  wgmma and TMA, the only way to the full tensor-core
//    rate, are left to a later change.
//  * M > 16, fp32: 64 x 64 tiles of fp32 fused multiply-adds on the CUDA
//    cores, 4 x 4 outputs a thread.  Not on the served path (the model
//    is bf16); there so that fp32 callers get the true fp32 product
//    (TF32 would keep three digits).
//  * M <= 16 (decode, and prefill's unembedding of the last position):
//    a matrix-vector shape, bound by reading B.  A block takes a strip of
//    256 bf16 (or 128 fp32) columns and 4 rows of A; each lane reads 16
//    bytes of a B row, so a warp reads 512 contiguous bytes, and each
//    warp walks its own rows of the block's K range with four loads in
//    flight.  The K axis is split across blocks (split-K) so that about
//    two waves of blocks cover the card even at N = 2560.  Each block's
//    warps are summed in shared memory in a fixed order; with more than
//    one split the blocks write fp32 partials, and the last block of a
//    column strip to finish (an atomic counter, reset by that block)
//    sums the partials in split order and rounds once.  So the result is
//    deterministic and a call is one launch.
//
// Every path masks ragged M, N and K in the kernel (out-of-range elements
// load as zeros and are never stored); operands whose rows are not 16-byte
// aligned take element loads instead of vector loads.  Products are
// summed in fp32 and rounded once to the output dtype (round to nearest
// even), as the reference does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
    return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- M > 16, bf16

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int A_PITCH = BK + 8;    // 80 bytes: ldmatrix rows hit 8 bank groups
constexpr int B_PITCH = BN + 8;    // 272 bytes
constexpr int MMA_THREADS = 256;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
    const int n = valid ? 16 : 0;  // 0 source bytes: the 16 are zero-filled
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
    asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

// d += a·b for one 16 x 8 x 16 step: a row-major (16 x 16), b column-major
// (16 x 8), fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage the (BM x BK) tile of A and the (BK x BN) tile of B at k0.  ALIGNED:
// K and N are multiples of 8 and both bases 16-byte aligned, so every
// 8-element chunk is in range or out of it as a whole and goes by cp.async.
template <bool ALIGNED>
__device__ __forceinline__ void load_tiles(bf16 (*As)[A_PITCH],
                                           bf16 (*Bs)[B_PITCH],
                                           const bf16* A, const bf16* B,
                                           int M, int N, int K, int m0,
                                           int n0, int k0, int tid) {
    const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
    for (int i = 0; i < 2; ++i) {      // A: 512 chunks of 8
        const int c = tid + i * MMA_THREADS;
        const int r = c >> 2, col = (c & 3) * 8;
        const int gm = m0 + r, gk = k0 + col;
        if (ALIGNED) {
            const bool ok = gm < M && gk < K;
            cp_async16(smem_u32(&As[r][col]),
                       ok ? A + (size_t)gm * K + gk : A, ok);
        } else {
#pragma unroll
            for (int j = 0; j < 8; ++j)
                As[r][col + j] = (gm < M && gk + j < K)
                    ? A[(size_t)gm * K + gk + j] : zero;
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {      // B: 512 chunks of 8
        const int c = tid + i * MMA_THREADS;
        const int r = c >> 4, col = (c & 15) * 8;
        const int gk = k0 + r, gn = n0 + col;
        if (ALIGNED) {
            const bool ok = gk < K && gn < N;
            cp_async16(smem_u32(&Bs[r][col]),
                       ok ? B + (size_t)gk * N + gn : B, ok);
        } else {
#pragma unroll
            for (int j = 0; j < 8; ++j)
                Bs[r][col + j] = (gk < K && gn + j < N)
                    ? B[(size_t)gk * N + gn + j] : zero;
        }
    }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(MMA_THREADS)
gemm_bf16_mma(const bf16* __restrict__ A, const bf16* __restrict__ B,
              bf16* __restrict__ C, int M, int N, int K) {
    __shared__ __align__(16) bf16 As[2][BM][A_PITCH];
    __shared__ __align__(16) bf16 Bs[2][BK][B_PITCH];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp >> 2, wn = warp & 3;        // 2 x 4 warps
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int nk = (K + BK - 1) / BK;

    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    load_tiles<ALIGNED>(As[0], Bs[0], A, B, M, N, K, m0, n0, 0, tid);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
        if (kt + 1 < nk)
            load_tiles<ALIGNED>(As[(kt + 1) & 1], Bs[(kt + 1) & 1], A, B, M,
                                N, K, m0, n0, (kt + 1) * BK, tid);
        cp_async_commit();   // an empty group at the last step
        cp_async_wait1();    // every group but the newest has landed
        __syncthreads();
        bf16 (*as)[A_PITCH] = As[kt & 1];
        bf16 (*bs)[B_PITCH] = Bs[kt & 1];
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t af[4][4];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
                ldmatrix_x4(af[mi], smem_u32(&as[wm * 64 + mi * 16 +
                                                 (lane & 15)]
                                                [kk + (lane >> 4) * 8]));
            uint32_t bfr[4][2];
#pragma unroll
            for (int nj = 0; nj < 2; ++nj) {
                uint32_t r[4];
                ldmatrix_x4_trans(r, smem_u32(&bs[kk + (lane & 15)]
                                                 [wn * 32 + nj * 16 +
                                                  (lane >> 4) * 8]));
                bfr[2 * nj][0] = r[0];
                bfr[2 * nj][1] = r[1];
                bfr[2 * nj + 1][0] = r[2];
                bfr[2 * nj + 1][1] = r[3];
            }
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni)
                    mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
        }
        __syncthreads();     // this stage is free for the load two steps on
    }

#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
        const int r = m0 + wm * 64 + mi * 16 + (lane >> 2);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int c = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int rr = r + (e >> 1) * 8, cc = c + (e & 1);
                if (rr < M && cc < N)
                    C[(size_t)rr * N + cc] = __float2bfloat16(acc[mi][ni][e]);
            }
        }
    }
}

// ---------------------------------------------------------------- M > 16, fp32

constexpr int FT = 64, FK = 16;

__global__ void __launch_bounds__(256)
gemm_f32_fma(const float* __restrict__ A, const float* __restrict__ B,
             float* __restrict__ C, int M, int N, int K) {
    __shared__ __align__(16) float As[FK][FT + 4];   // transposed: [k][m]
    __shared__ float Bs[FK][FT];
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int m0 = blockIdx.y * FT, n0 = blockIdx.x * FT;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += FK) {
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int e = tid + i * 256;
            const int r = e / FK, kk = e % FK;
            As[kk][r] = (m0 + r < M && k0 + kk < K)
                ? A[(size_t)(m0 + r) * K + k0 + kk] : 0.f;
            const int kb = e / FT, c = e % FT;
            Bs[kb][c] = (k0 + kb < K && n0 + c < N)
                ? B[(size_t)(k0 + kb) * N + n0 + c] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < FK; ++kk) {
            const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
            const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float bv = Bs[kk][tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    acc[i][j] = fmaf(a4[i], bv, acc[i][j]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = m0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = n0 + tx + 16 * j;
            if (r < M && c < N) C[(size_t)r * N + c] = acc[i][j];
        }
    }
}

// ---------------------------------------------------------------- M <= 16

constexpr int SM_ROWS = 4;       // rows of A per block
constexpr int SM_WARPS = 8;
constexpr int SM_THREADS = SM_WARPS * 32;
constexpr int SM_KCHUNK = 256;   // A values staged per pass
constexpr int SM_UNROLL = 4;     // B rows in flight per warp

// V consecutive elements of row ``row`` from column n, as floats (zeros past
// N).  VEC: N is a multiple of V and the base 16-byte aligned, so the V
// elements are one 16-byte load.
template <typename T, bool VEC>
__device__ __forceinline__ void load_strip(const T* row, int n, int N,
                                           float (&b)[16 / sizeof(T)]) {
    constexpr int V = 16 / sizeof(T);
    if (VEC) {
        if (n < N) {
            const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + n));
            if constexpr (sizeof(T) == 2) {
                const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float2 f = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
                    b[2 * i] = f.x;
                    b[2 * i + 1] = f.y;
                }
            } else {
                b[0] = __uint_as_float(raw.x);
                b[1] = __uint_as_float(raw.y);
                b[2] = __uint_as_float(raw.z);
                b[3] = __uint_as_float(raw.w);
            }
        } else {
#pragma unroll
            for (int j = 0; j < V; ++j) b[j] = 0.f;
        }
    } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
            b[j] = (n + j < N) ? to_f(row[n + j]) : 0.f;
    }
}

// grid (column strips, splits, row groups of 4).  Split s covers
// K rows [s * k_per_split, min(K, (s + 1) * k_per_split)).
template <typename T, bool VEC>
__global__ void __launch_bounds__(SM_THREADS)
gemm_small_m(const T* __restrict__ A, const T* __restrict__ B,
             T* __restrict__ C, float* __restrict__ partial,
             unsigned* __restrict__ counters, int M, int N, int K,
             int k_per_split) {
    constexpr int V = 16 / sizeof(T);
    constexpr int TILE_N = 32 * V;
    __shared__ float a_s[SM_ROWS][SM_KCHUNK];
    __shared__ float red[SM_WARPS][SM_ROWS][TILE_N];
    __shared__ unsigned last_block;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int split = blockIdx.y, splits = gridDim.y;
    const int m0 = blockIdx.z * SM_ROWS;
    const int rows = min(SM_ROWS, M - m0);
    const int n = blockIdx.x * TILE_N + lane * V;
    const int k_begin = split * k_per_split;
    const int k_end = min(K, k_begin + k_per_split);

    float acc[SM_ROWS][V];
#pragma unroll
    for (int r = 0; r < SM_ROWS; ++r)
#pragma unroll
        for (int j = 0; j < V; ++j) acc[r][j] = 0.f;

    for (int c0 = k_begin; c0 < k_end; c0 += SM_KCHUNK) {
        const int cn = min(SM_KCHUNK, k_end - c0);
        __syncthreads();
        for (int e = tid; e < SM_ROWS * SM_KCHUNK; e += SM_THREADS) {
            const int r = e / SM_KCHUNK, kk = e % SM_KCHUNK;
            a_s[r][kk] = (r < rows && kk < cn)
                ? to_f(A[(size_t)(m0 + r) * K + c0 + kk]) : 0.f;
        }
        __syncthreads();
        for (int kk = warp; kk < cn; kk += SM_WARPS * SM_UNROLL) {
            float b[SM_UNROLL][V];
#pragma unroll
            for (int u = 0; u < SM_UNROLL; ++u) {
                const int k = kk + u * SM_WARPS;
                if (k < cn) {
                    load_strip<T, VEC>(B + (size_t)(c0 + k) * N, n, N, b[u]);
                } else {
#pragma unroll
                    for (int j = 0; j < V; ++j) b[u][j] = 0.f;
                }
            }
#pragma unroll
            for (int u = 0; u < SM_UNROLL; ++u) {
                const int k = min(kk + u * SM_WARPS, SM_KCHUNK - 1);
#pragma unroll
                for (int r = 0; r < SM_ROWS; ++r) {
                    const float a = a_s[r][k];
#pragma unroll
                    for (int j = 0; j < V; ++j)
                        acc[r][j] = fmaf(a, b[u][j], acc[r][j]);
                }
            }
        }
    }

    // the block's warps, summed in warp order
#pragma unroll
    for (int r = 0; r < SM_ROWS; ++r)
#pragma unroll
        for (int j = 0; j < V; ++j) red[warp][r][lane * V + j] = acc[r][j];
    __syncthreads();
    for (int o = tid; o < SM_ROWS * TILE_N; o += SM_THREADS) {
        const int r = o / TILE_N, col = o % TILE_N;
        const int nn = blockIdx.x * TILE_N + col;
        if (r >= rows || nn >= N) continue;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < SM_WARPS; ++w) s += red[w][r][col];
        if (splits == 1)
            C[(size_t)(m0 + r) * N + nn] = from_f<T>(s);
        else
            partial[((size_t)split * M + m0 + r) * N + nn] = s;
    }
    if (splits == 1) return;

    // split-K: the last block of this strip to finish sums the partials
    __threadfence();
    __syncthreads();
    if (tid == 0) {
        const unsigned idx = blockIdx.z * gridDim.x + blockIdx.x;
        const unsigned prev = atomicAdd(&counters[idx], 1u);
        last_block = (prev == (unsigned)splits - 1u);
        if (last_block) counters[idx] = 0u;   // ready for the next launch
    }
    __syncthreads();
    if (!last_block) return;
    __threadfence();
    for (int o = tid; o < SM_ROWS * TILE_N; o += SM_THREADS) {
        const int r = o / TILE_N, col = o % TILE_N;
        const int nn = blockIdx.x * TILE_N + col;
        if (r >= rows || nn >= N) continue;
        float s = 0.f;
        for (int sp = 0; sp < splits; ++sp)
            s += __ldcg(&partial[((size_t)sp * M + m0 + r) * N + nn]);
        C[(size_t)(m0 + r) * N + nn] = from_f<T>(s);
    }
}

template <typename T>
cudaError_t launch_small(const void* A, const void* B, void* C,
                         float* partial, unsigned* counters, int M, int N,
                         int K, int splits, int k_per_split,
                         cudaStream_t s) {
    constexpr int V = 16 / sizeof(T);
    constexpr int TILE_N = 32 * V;
    const dim3 grid((N + TILE_N - 1) / TILE_N, splits,
                    (M + SM_ROWS - 1) / SM_ROWS);
    const T* a = static_cast<const T*>(A);
    const T* b = static_cast<const T*>(B);
    T* c = static_cast<T*>(C);
    const bool vec = N % V == 0 &&
                     reinterpret_cast<uintptr_t>(B) % 16 == 0;
    if (vec)
        gemm_small_m<T, true><<<grid, SM_THREADS, 0, s>>>(
            a, b, c, partial, counters, M, N, K, k_per_split);
    else
        gemm_small_m<T, false><<<grid, SM_THREADS, 0, s>>>(
            a, b, c, partial, counters, M, N, K, k_per_split);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// M <= 16 rows.  dtype: 0 fp32, 1 bf16 (A, B and C all of it).  With
// splits > 1, ``partial`` holds (splits, M, N) fp32 and ``counters`` at
// least ceil(N / strip) * ceil(M / 4) zeros (left zero after the launch).
// Returns the first CUDA error.
int gemm_small(int dtype, const void* A, const void* B, void* C,
               void* partial, void* counters, int M, int N, int K,
               int splits, int k_per_split, void* stream) {
    if (M < 1 || N < 1 || K < 1 || M > 16 || splits < 1 ||
        splits > 65535 || k_per_split < 1 ||
        (long long)splits * k_per_split < K ||
        (long long)(splits - 1) * k_per_split >= K ||
        (splits > 1 && (partial == nullptr || counters == nullptr)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* p = static_cast<float*>(partial);
    unsigned* cnt = static_cast<unsigned*>(counters);
    if (dtype == 1)
        return (int)launch_small<bf16>(A, B, C, p, cnt, M, N, K, splits,
                                       k_per_split, s);
    if (dtype == 0)
        return (int)launch_small<float>(A, B, C, p, cnt, M, N, K, splits,
                                        k_per_split, s);
    return (int)cudaErrorInvalidValue;
}

// Any M, N, K >= 1 (meant for M > 16): bf16 on the tensor cores, fp32 on
// the CUDA cores.  Returns the first CUDA error.
int gemm_tiled(int dtype, const void* A, const void* B, void* C, int M,
               int N, int K, void* stream) {
    if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1) {
        if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
        const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
        const bf16* a = static_cast<const bf16*>(A);
        const bf16* b = static_cast<const bf16*>(B);
        bf16* c = static_cast<bf16*>(C);
        const bool aligned = K % 8 == 0 && N % 8 == 0 &&
            (reinterpret_cast<uintptr_t>(A) |
             reinterpret_cast<uintptr_t>(B)) % 16 == 0;
        if (aligned)
            gemm_bf16_mma<true><<<grid, MMA_THREADS, 0, s>>>(a, b, c, M, N,
                                                             K);
        else
            gemm_bf16_mma<false><<<grid, MMA_THREADS, 0, s>>>(a, b, c, M, N,
                                                              K);
        return (int)cudaGetLastError();
    }
    if (dtype == 0) {
        if ((M + FT - 1) / FT > 65535) return (int)cudaErrorInvalidValue;
        const dim3 grid((N + FT - 1) / FT, (M + FT - 1) / FT);
        gemm_f32_fma<<<grid, 256, 0, s>>>(static_cast<const float*>(A),
                                          static_cast<const float*>(B),
                                          static_cast<float*>(C), M, N, K);
        return (int)cudaGetLastError();
    }
    return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
