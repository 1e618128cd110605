// Attention with an online softmax, causal or full, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel B11 of the JAX package:
//   kernels/flash_attention.py::_flash_kernel (flash_attention): per
//   (batch, head), out = softmax(q k^T / sqrt(d)) v, with running fp32
//   (max m, denominator l, accumulator) per query row, causal KV blocks
//   past the diagonal skipped, p cast to v's dtype before P·V, and
//   out = acc / max(l, 1e-30).
// In the port it is the causal self-attention of the LM prefill.  What it
// computes is the Pallas kernel's function; the block structure is its own.
//
// What bounds it on an H100.  At the prefill shape of stablelm-3b (batch
// 4, 32 heads, S = 512, d = 80, bf16) one layer does 4·B·H·d·S(S+1)/2 =
// 5.4 GFLOP (5.4 us at the 989 TFLOP/s bf16 peak) and must move q, k, v
// and o once: 42 MB, 12.5 us at 3.35 TB/s.  So bytes bind, and at this S
// a launch of 1,024 blocks lasting tens of microseconds is close to
// launch-bound.
//
// What the design does about it:
//  * bf16 with d a multiple of 16 (d = 80 included: it is not a power of
//    two, so the tiles are sized by d at compile time, d in {16, 32, ...,
//    128}): a block of 4 warps takes 64 query rows of one (batch, head),
//    16 rows a warp, and walks the key tiles of 64 up to the diagonal.
//    q stays in registers as mma.sync A fragments for the whole walk; each
//    key tile of k and v is staged in shared memory once for the 4 warps
//    (rows padded by 8 elements, so ldmatrix is free of bank conflicts).
//    S = q k^T and P·V run on the tensor cores (mma.sync m16n8k16, bf16
//    in, fp32 accumulate); the score fragment becomes P·V's A fragment in
//    registers, cast to bf16, so the (64 x 64) score tile never leaves
//    them.  Row max and denominator are fp32, kept per thread and combined
//    across the 4 threads of a row with shuffles.
//  * fp32, or d not a multiple of 16 (any d <= 128): the same walk on the
//    CUDA cores in fp32 (TF32 would keep three digits): 16 query rows a
//    block, key tiles of 32 in shared memory, each lane one key's score,
//    shuffles for the row max and sum, each lane d/32 output columns.
//  * q, k, v and o are addressed through (batch, head, position) strides
//    with the head dimension contiguous, so the models' (B, S, H, d)
//    layout goes in as a permuted view, without a copy.
//  * Any S >= 1: keys past S are masked and rows past S never stored.  A
//    masked score takes probability 0 outright, so a key tile that holds
//    no valid key for a row changes nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

struct Strides {
    long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

constexpr float NEG_INF = -INFINITY;

// ------------------------------------------------------- bf16, tensor cores

constexpr int QT = 64;          // query rows per block, 16 per warp
constexpr int KT = 64;          // keys per tile
constexpr int MMA_THREADS = 128;

// rows r, r + 8 of q as an A fragment's pair of bf16 at columns c, c + 1
__device__ __forceinline__ uint32_t q_pair(const bf16* q, long long qs,
                                           int row, int S, int c) {
    if (row >= S) return 0u;
    return *reinterpret_cast<const uint32_t*>(q + row * qs + c);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_mma(const bf16* __restrict__ Q, const bf16* __restrict__ Kp,
          const bf16* __restrict__ Vp, bf16* __restrict__ O, int H, int S,
          int causal, float scale, Strides st) {
    constexpr int PITCH = D + 8;
    constexpr int DK = D / 16;           // k16 steps of q k^T
    constexpr int DN = D / 8;            // n8 tiles of P·V
    __shared__ __align__(16) bf16 Ks[KT][PITCH];
    __shared__ __align__(16) bf16 Vs[KT][PITCH];

    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int q0 = blockIdx.y * QT;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const bf16* q = Q + b * st.qb + h * st.qh;
    const bf16* kbase = Kp + b * st.kb + h * st.kh;
    const bf16* vbase = Vp + b * st.vb + h * st.vh;
    bf16* o = O + b * st.ob + h * st.oh;

    const int r_lo = q0 + warp * 16 + (lane >> 2), r_hi = r_lo + 8;
    uint32_t qf[DK][4];
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
        const int c = kk * 16 + (lane & 3) * 2;
        qf[kk][0] = q_pair(q, st.qs, r_lo, S, c);
        qf[kk][1] = q_pair(q, st.qs, r_hi, S, c);
        qf[kk][2] = q_pair(q, st.qs, r_lo, S, c + 8);
        qf[kk][3] = q_pair(q, st.qs, r_hi, S, c + 8);
    }

    float acc[DN][4];
#pragma unroll
    for (int i = 0; i < DN; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;

    int n_tiles = (S + KT - 1) / KT;
    if (causal) n_tiles = min(n_tiles, (q0 + QT - 1) / KT + 1);
    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * KT;
        __syncthreads();                 // the last tile is consumed
        for (int c = tid; c < KT * (D / 8); c += MMA_THREADS) {
            const int r = c / (D / 8), col = (c % (D / 8)) * 8;
            uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
            if (k0 + r < S) {
                kv = *reinterpret_cast<const uint4*>(
                    kbase + (k0 + r) * st.ks + col);
                vv = *reinterpret_cast<const uint4*>(
                    vbase + (k0 + r) * st.vs + col);
            }
            *reinterpret_cast<uint4*>(&Ks[r][col]) = kv;
            *reinterpret_cast<uint4*>(&Vs[r][col]) = vv;
        }
        __syncthreads();

        // scores: this warp's 16 rows x 64 keys, 8 n8 tiles
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                uint32_t r[4];
                ldmatrix_x4(r, smem_u32(&Ks[np * 16 + (lane >> 4) * 8 +
                                            (lane & 7)]
                                           [kk * 16 + ((lane >> 3) & 1) * 8]));
                mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
                mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
            }
        }

        // scale and mask; the running max of rows r_lo and r_hi
        float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
                const int row = (e < 2) ? r_lo : r_hi;
                const bool ok = key < S && (!causal || key <= row);
                s[n][e] = ok ? s[n][e] * scale : NEG_INF;
            }
            mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
            mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
            mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
            mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
        }
        const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
        // nothing is accumulated while the max is still -inf
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
                s[n][e] = (s[n][e] == NEG_INF) ? 0.f : expf(s[n][e] - m);
            }
            sum_lo += s[n][0] + s[n][1];
            sum_hi += s[n][2] + s[n][3];
        }
        l_lo = l_lo * corr_lo + sum_lo;   // this thread's columns only
        l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
        for (int i = 0; i < DN; ++i) {
            acc[i][0] *= corr_lo;
            acc[i][1] *= corr_lo;
            acc[i][2] *= corr_hi;
            acc[i][3] *= corr_hi;
        }

        // P·V: p (cast to bf16) as A fragments, v from shared memory
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
            const uint32_t pa[4] = {
                pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
            for (int dp = 0; dp < D / 16; ++dp) {
                uint32_t r[4];
                ldmatrix_x4_trans(r, smem_u32(&Vs[kk * 16 + (lane & 15)]
                                                 [dp * 16 + (lane >> 4) * 8]));
                mma_bf16(acc[2 * dp], pa, r[0], r[1]);
                mma_bf16(acc[2 * dp + 1], pa, r[2], r[3]);
            }
        }
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
    for (int i = 0; i < DN; ++i) {
        const int c = i * 8 + (lane & 3) * 2;
        if (r_lo < S)
            *reinterpret_cast<__nv_bfloat162*>(o + r_lo * st.os + c) =
                __floats2bfloat162_rn(acc[i][0] / den_lo, acc[i][1] / den_lo);
        if (r_hi < S)
            *reinterpret_cast<__nv_bfloat162*>(o + r_hi * st.os + c) =
                __floats2bfloat162_rn(acc[i][2] / den_hi, acc[i][3] / den_hi);
    }
}

// ------------------------------------------------------------ CUDA cores

constexpr int SQ = 16;          // query rows per block, 2 per warp
constexpr int SK = 32;          // keys per tile, one per lane
constexpr int DMAX = 128;
constexpr int SC_THREADS = 256;

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

template <typename T>
__global__ void __launch_bounds__(SC_THREADS)
flash_scalar(const T* __restrict__ Q, const T* __restrict__ Kp,
             const T* __restrict__ Vp, T* __restrict__ O, int H, int S,
             int d, int causal, float scale, Strides st) {
    __shared__ float qs[SQ][DMAX];
    __shared__ float ks[SK][DMAX + 1];   // +1: lanes read distinct banks
    __shared__ float vs[SK][DMAX];

    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int q0 = blockIdx.y * SQ;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const T* q = Q + b * st.qb + h * st.qh;
    const T* kbase = Kp + b * st.kb + h * st.kh;
    const T* vbase = Vp + b * st.vb + h * st.vh;
    T* o = O + b * st.ob + h * st.oh;

    for (int e = tid; e < SQ * d; e += SC_THREADS) {
        const int r = e / d, c = e % d;
        qs[r][c] = (q0 + r < S) ? to_f(q[(q0 + r) * st.qs + c]) : 0.f;
    }
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float acc[2][DMAX / 32];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < DMAX / 32; ++c) acc[i][c] = 0.f;

    int n_tiles = (S + SK - 1) / SK;
    if (causal) n_tiles = min(n_tiles, (q0 + SQ - 1) / SK + 1);
    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * SK;
        __syncthreads();
        for (int e = tid; e < SK * d; e += SC_THREADS) {
            const int r = e / d, c = e % d;
            const bool ok = k0 + r < S;
            ks[r][c] = ok ? to_f(kbase[(k0 + r) * st.ks + c]) : 0.f;
            vs[r][c] = ok ? to_f(vbase[(k0 + r) * st.vs + c]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int row = warp * 2 + i, qrow = q0 + row;
            const int key = k0 + lane;
            float sc = 0.f;
            for (int c = 0; c < d; ++c) sc = fmaf(qs[row][c], ks[lane][c], sc);
            const bool ok = key < S && (!causal || key <= qrow);
            sc = ok ? sc * scale : NEG_INF;
            const float mn = fmaxf(m[i], warp_max(sc));
            const float p = ok ? expf(sc - mn) : 0.f;
            const float corr = (m[i] == NEG_INF) ? 0.f : expf(m[i] - mn);
            m[i] = mn;
            l[i] = l[i] * corr + warp_sum(p);
            const float pv = to_f(from_f<T>(p));   // p in v's dtype
#pragma unroll
            for (int c = 0; c < DMAX / 32; ++c) acc[i][c] *= corr;
            for (int j = 0; j < SK; ++j) {
                const float pj = __shfl_sync(0xffffffffu, pv, j);
#pragma unroll
                for (int c = 0; c < DMAX / 32; ++c) {
                    const int col = lane + 32 * c;
                    if (col < d) acc[i][c] = fmaf(pj, vs[j][col], acc[i][c]);
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int qrow = q0 + warp * 2 + i;
        if (qrow >= S) continue;
        const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int c = 0; c < DMAX / 32; ++c) {
            const int col = lane + 32 * c;
            if (col < d) o[qrow * st.os + col] = from_f<T>(acc[i][c] / den);
        }
    }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int BH, int H, int S, int causal, float scale,
                       const Strides& st, cudaStream_t s) {
    const dim3 grid(BH, (S + QT - 1) / QT);
    flash_mma<D><<<grid, MMA_THREADS, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), H, S, causal,
        scale, st);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scalar(const void* q, const void* k, const void* v,
                          void* o, int BH, int H, int S, int d, int causal,
                          float scale, const Strides& st, cudaStream_t s) {
    const dim3 grid(BH, (S + SQ - 1) / SQ);
    flash_scalar<T><<<grid, SC_THREADS, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), H, S, d, causal, scale,
        st);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: (B, H, S, d) addressed by ``strides`` (12 element strides:
// batch, head, position of q, k, v, o in turn; the d axis contiguous).
// dtype: 0 fp32, 1 bf16.  use_mma: the tensor-core kernel (bf16, d a
// multiple of 16, every stride a multiple of 8 and every base 16-byte
// aligned); else the CUDA-core kernel.  Returns the first CUDA error.
int flash_attention_fwd(int dtype, int use_mma, const void* q, const void* k,
                        const void* v, void* o, int B, int H, int S, int d,
                        int causal, float scale, const long long* strides,
                        void* stream) {
    if (B < 1 || H < 1 || S < 1 || d < 1 || d > DMAX ||
        (long long)B * H > 2147483647LL || (S + SQ - 1) / SQ > 65535 ||
        (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
               strides[5], strides[6], strides[7], strides[8], strides[9],
               strides[10], strides[11]};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int BH = B * H;
    if (use_mma) {
        bool ok = dtype == 1 && d % 16 == 0;
        for (int i = 0; i < 12; ++i) ok = ok && strides[i] % 8 == 0;
        ok = ok && ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) |
                     reinterpret_cast<uintptr_t>(o)) % 16 == 0);
        if (!ok) return (int)cudaErrorInvalidValue;
        switch (d) {
            case 16: return (int)launch_mma<16>(q, k, v, o, BH, H, S, causal, scale, st, s);
            case 32: return (int)launch_mma<32>(q, k, v, o, BH, H, S, causal, scale, st, s);
            case 48: return (int)launch_mma<48>(q, k, v, o, BH, H, S, causal, scale, st, s);
            case 64: return (int)launch_mma<64>(q, k, v, o, BH, H, S, causal, scale, st, s);
            case 80: return (int)launch_mma<80>(q, k, v, o, BH, H, S, causal, scale, st, s);
            case 96: return (int)launch_mma<96>(q, k, v, o, BH, H, S, causal, scale, st, s);
            case 112: return (int)launch_mma<112>(q, k, v, o, BH, H, S, causal, scale, st, s);
            case 128: return (int)launch_mma<128>(q, k, v, o, BH, H, S, causal, scale, st, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (dtype == 1)
        return (int)launch_scalar<bf16>(q, k, v, o, BH, H, S, d, causal,
                                        scale, st, s);
    return (int)launch_scalar<float>(q, k, v, o, BH, H, S, d, causal, scale,
                                     st, s);
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
