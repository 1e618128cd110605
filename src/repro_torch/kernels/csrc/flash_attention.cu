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
// and o once: 42 MB, 12.5 us at 3.35 TB/s.  So bytes bind, and a launch
// lasting tens of microseconds is close to launch-bound: what matters is
// that every block's loads overlap its products and that the SMs finish
// together.
//
// What the design does about it:
//  * bf16 with d a multiple of 16, d <= 256 (the wgmma route): a block of
//    one consumer warpgroup and one producer warp takes 64 query rows of
//    one (batch, head); for d > 128 two consumer warpgroups share the 64
//    rows and split the output columns (a 64 x 256 fp32 accumulator
//    would take 128 registers a thread).  Two warpgroups of 64 rows each
//    in one block share each k/v tile, but at d = 80 they take about 140
//    registers a thread, so one block fits an SM; one warpgroup a block
//    lets three blocks share an SM, gives the causal walk twice the
//    blocks to balance, and was the faster of the two on an H100 at the
//    LM path's shape.  The producer warp
//    stages q once, by TMA, then streams key tiles of 64 keys through a
//    ring of 3 (d <= 128) or 2 stages of k and v, each completed on an
//    mbarrier and released by the consumers through another.  d = 80
//    rows are 160 bytes, past the 128-byte swizzle's box, so q, k and v
//    are loaded as 16-column boxes (32 bytes) with the 32-byte swizzle,
//    which fits every d that is a multiple of 16.  The tensors are
//    addressed by 4-D TMA descriptors over their (batch, head, position)
//    strides, so the models' (B, S, H, d) layout goes in without a copy,
//    and positions past S load as zeros.  S = q k^T is wgmma m64n64k16
//    with both operands in shared memory (k's tile is K-major: d
//    contiguous).  The scores stay in registers: masked, exponentiated
//    against the running max, cast to bf16 and fed to P·V as wgmma's A
//    operand from registers; v's (keys, d) tile is MN-major for P·V and
//    goes in through the descriptor's transpose bit.  Row max and
//    denominator are fp32, combined across the 4 threads of a row with
//    shuffles.  Causal query tiles are scheduled heaviest first: block y
//    takes query tile n - 1 - y, and the grid's x axis runs over (batch,
//    head), so the first wave holds the tiles that walk the most keys.
//  * fp32, or d not a multiple of 16 (any d <= 256): the same walk on the
//    CUDA cores in fp32 (TF32 would keep three digits): 16 query rows a
//    block, key tiles of 32 in shared memory, each lane one key's score,
//    shuffles for the row max and sum, each lane d/32 output columns.
//  * Any S >= 1: keys past S are masked and rows past S never stored.  A
//    masked score takes probability 0 outright, so a key tile that holds
//    no valid key for a row changes nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <mutex>

#include "hopper.cuh"
#include "wgmma.cuh"

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

constexpr float NEG_INF = -INFINITY;

// ------------------------------------------------------- bf16, wgmma

constexpr int FA_KT = 64;            // keys per tile
constexpr int FA_WGS = 1;            // consumer warpgroups a block, d <= 128
constexpr int D_MAX = 256;

template <int D>
struct FaCfg {
    static constexpr int WGS = D > 128 ? 2 : FA_WGS;  // consumer warpgroups
    static constexpr int THREADS = WGS * 128 + 32;   // and one producer warp
    static constexpr int DSPLIT = D > 128 ? 2 : 1;   // warpgroups per row
    static constexpr int QROWS = 64 * WGS / DSPLIT;  // query rows a block
    static constexpr int DC = D / 16;                // 16-column chunks
    // output columns of warpgroup 0 and 1 when they split d
    static constexpr int NV0 = DSPLIT == 1 ? D : (DC + 1) / 2 * 16;
    static constexpr int NV1 = D - NV0;
    static constexpr int STAGES = D <= 128 ? 3 : 2;
    static constexpr int Q_CHUNK = QROWS * 32;       // bytes of a q chunk
    static constexpr int KV_CHUNK = FA_KT * 32;      // bytes of a k/v chunk
    static constexpr int Q_BYTES = DC * Q_CHUNK;
    static constexpr int KV_BYTES = DC * KV_CHUNK;   // k (or v) of a tile
    static constexpr int STAGE = 2 * KV_BYTES;
    static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE;
    static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
};

// One consumer warpgroup: 64 query rows from ``row0`` (of the block's
// tile at q0), output columns [16 * DOFF, 16 * DOFF + NV).
template <int D, int NV, int DOFF>
__device__ __forceinline__ void fa_consume(
        const uint8_t* smem, uint64_t* full, uint64_t* empty, uint64_t* qbar,
        bf16* o, long long os, int q0, int row0, int S, int n_tiles,
        int causal, float scale) {
    using F = FaCfg<D>;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int r_lo = q0 + row0 + warp * 16 + lane / 4, r_hi = r_lo + 8;
    const int my_tiles = causal
        ? min(n_tiles, (q0 + row0 + 63) / FA_KT + 1) : n_tiles;
    const uint8_t* qs = smem + row0 * 32;     // this warpgroup's rows
    float acc[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) acc[i] = 0.f;
    float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;

    hop::mbar_wait(qbar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < n_tiles; ++t) {
        hop::mbar_wait(&full[stage], phase);
        if (t < my_tiles) {
            const uint8_t* ks = smem + F::Q_BYTES + stage * F::STAGE;
            const uint8_t* vs = ks + F::KV_BYTES;
            // scores: 64 rows x 64 keys, K-major q and k, one k16 step
            // per 16-column chunk (32-byte rows, 8-row atoms 256 B apart)
            float s[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) s[i] = 0.f;
            hop::wg_fence();
#pragma unroll
            for (int kk = 0; kk < F::DC; ++kk)
                WgmmaSS<64>::template run<0, 0>(
                    s,
                    hop::make_desc(qs + kk * F::Q_CHUNK, 16, 256,
                                   hop::SWIZZLE_32B),
                    hop::make_desc(ks + kk * F::KV_CHUNK, 16, 256,
                                   hop::SWIZZLE_32B),
                    1);
            hop::wg_commit();
            hop::wg_wait<0>();
            hop::fence_regs(s);

            // scale and mask; the running max of rows r_lo and r_hi.  s[4n
            // + e]: key 8n + 2(lane % 4) + (e & 1), row r_lo (e < 2) or r_hi
            const int k0 = t * FA_KT;
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
                    s[4 * n + e] = (s[4 * n + e] == NEG_INF)
                        ? 0.f : expf(s[4 * n + e] - m);
                }
                sum_lo += s[4 * n] + s[4 * n + 1];
                sum_hi += s[4 * n + 2] + s[4 * n + 3];
            }
            l_lo = l_lo * corr_lo + sum_lo;   // this thread's columns only
            l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
            for (int i = 0; i < NV / 8; ++i) {
                acc[4 * i] *= corr_lo;
                acc[4 * i + 1] *= corr_lo;
                acc[4 * i + 2] *= corr_hi;
                acc[4 * i + 3] *= corr_hi;
            }
            // p cast to bf16, as wgmma A fragments: keys 16j .. 16j + 15
            uint32_t pa[4][4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                pa[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
                pa[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
                pa[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
                pa[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
            }
            // P·V: v MN-major (d contiguous), 16 keys a step (512 B),
            // 16-column chunks KV_CHUNK apart
            hop::wg_fence();
#pragma unroll
            for (int j = 0; j < 4; ++j)
                WgmmaRS<NV>::template run<1>(
                    acc, pa[j][0], pa[j][1], pa[j][2], pa[j][3],
                    hop::make_desc(vs + DOFF * F::KV_CHUNK + j * 16 * 32,
                                   F::KV_CHUNK, 256, hop::SWIZZLE_32B),
                    1);
            hop::wg_commit();
            hop::wg_wait<0>();
            hop::fence_regs(acc);
#pragma unroll
            for (int j = 0; j < 4; ++j) hop::fence_regs(pa[j]);
        }
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(&empty[stage]);
        if (++stage == F::STAGES) {
            stage = 0;
            phase ^= 1u;
        }
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
    for (int i = 0; i < NV / 8; ++i) {
        const int c = DOFF * 16 + i * 8 + (lane & 3) * 2;
        if (r_lo < S)
            *reinterpret_cast<__nv_bfloat162*>(o + r_lo * os + c) =
                __floats2bfloat162_rn(acc[4 * i] / den_lo,
                                      acc[4 * i + 1] / den_lo);
        if (r_hi < S)
            *reinterpret_cast<__nv_bfloat162*>(o + r_hi * os + c) =
                __floats2bfloat162_rn(acc[4 * i + 2] / den_hi,
                                      acc[4 * i + 3] / den_hi);
    }
}

// grid (B·H, query tiles): block (x, y) takes (batch, head) x and, when
// causal, query tile n - 1 - y.
template <int D>
__global__ void __launch_bounds__(FaCfg<D>::THREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ O,
            int H, int S, int causal, float scale, long long ob,
            long long oh, long long os) {
    using F = FaCfg<D>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
        ~static_cast<uintptr_t>(1023));
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + F::BAR_OFF);
    uint64_t* empty = full + F::STAGES;
    uint64_t* qbar = empty + F::STAGES;
    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int qt = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                          : (int)blockIdx.y;
    const int q0 = qt * F::QROWS;
    int n_tiles = (S + FA_KT - 1) / FA_KT;
    if (causal) n_tiles = min(n_tiles, (q0 + F::QROWS - 1) / FA_KT + 1);

    if (threadIdx.x == 0) {
        for (int s = 0; s < F::STAGES; ++s) {
            hop::mbar_init(&full[s], 1);
            // one arrival per consumer warp
            hop::mbar_init(&empty[s], 4 * F::WGS);
        }
        hop::mbar_init(qbar, 1);
        hop::fence_barrier_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == F::WGS) {
        if (threadIdx.x == F::WGS * 128) {
            hop::mbar_expect_tx(qbar, F::Q_BYTES);
#pragma unroll
            for (int c = 0; c < F::DC; ++c)
                hop::tma_load_4d(smem + c * F::Q_CHUNK, &tm_q, qbar, c * 16,
                                 q0, h, b);
            int stage = 0;
            uint32_t phase = 0;
            for (int t = 0; t < n_tiles; ++t) {
                hop::mbar_wait(&empty[stage], phase ^ 1u);
                uint8_t* ks = smem + F::Q_BYTES + stage * F::STAGE;
                uint8_t* vs = ks + F::KV_BYTES;
                hop::mbar_expect_tx(&full[stage], F::STAGE);
#pragma unroll
                for (int c = 0; c < F::DC; ++c) {
                    hop::tma_load_4d(ks + c * F::KV_CHUNK, &tm_k, &full[stage],
                                     c * 16, t * FA_KT, h, b);
                    hop::tma_load_4d(vs + c * F::KV_CHUNK, &tm_v, &full[stage],
                                     c * 16, t * FA_KT, h, b);
                }
                if (++stage == F::STAGES) {
                    stage = 0;
                    phase ^= 1u;
                }
            }
        }
    } else {
        bf16* o = O + b * ob + h * oh;
        if constexpr (F::DSPLIT == 1) {
            fa_consume<D, D, 0>(smem, full, empty, qbar, o, os, q0, wg * 64,
                                S, n_tiles, causal, scale);
        } else {
            if (wg == 0)
                fa_consume<D, F::NV0, 0>(smem, full, empty, qbar, o, os, q0,
                                         0, S, n_tiles, causal, scale);
            else
                fa_consume<D, F::NV1, F::NV0 / 16>(smem, full, empty, qbar, o,
                                                   os, q0, 0, S, n_tiles,
                                                   causal, scale);
        }
    }
}

// ------------------------------------------------------------ CUDA cores

constexpr int SQ = 16;          // query rows per block, 2 per warp
constexpr int SK = 32;          // keys per tile, one per lane
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

// shared floats of the CUDA-core kernel at head dim d: q (SQ x d), k
// (SK x (d + 1): lanes read distinct banks), v (SK x d)
__host__ __device__ constexpr int scalar_smem_floats(int d) {
    return SQ * d + SK * (d + 1) + SK * d;
}

template <typename T>
__global__ void __launch_bounds__(SC_THREADS)
flash_scalar(const T* __restrict__ Q, const T* __restrict__ Kp,
             const T* __restrict__ Vp, T* __restrict__ O, int H, int S,
             int d, int causal, float scale, Strides st) {
    extern __shared__ float sc_smem[];
    float* qs = sc_smem;                  // [SQ][d]
    float* ks = qs + SQ * d;              // [SK][d + 1]
    float* vs = ks + SK * (d + 1);        // [SK][d]

    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int q0 = blockIdx.y * SQ;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const T* q = Q + b * st.qb + h * st.qh;
    const T* kbase = Kp + b * st.kb + h * st.kh;
    const T* vbase = Vp + b * st.vb + h * st.vh;
    T* o = O + b * st.ob + h * st.oh;

    for (int e = tid; e < SQ * d; e += SC_THREADS) {
        const int r = e / d, c = e % d;
        qs[e] = (q0 + r < S) ? to_f(q[(q0 + r) * st.qs + c]) : 0.f;
    }
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float acc[2][D_MAX / 32];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < D_MAX / 32; ++c) acc[i][c] = 0.f;

    int n_tiles = (S + SK - 1) / SK;
    if (causal) n_tiles = min(n_tiles, (q0 + SQ - 1) / SK + 1);
    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * SK;
        __syncthreads();
        for (int e = tid; e < SK * d; e += SC_THREADS) {
            const int r = e / d, c = e % d;
            const bool ok = k0 + r < S;
            ks[r * (d + 1) + c] = ok ? to_f(kbase[(k0 + r) * st.ks + c]) : 0.f;
            vs[r * d + c] = ok ? to_f(vbase[(k0 + r) * st.vs + c]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int row = warp * 2 + i, qrow = q0 + row;
            const int key = k0 + lane;
            float sc = 0.f;
            for (int c = 0; c < d; ++c)
                sc = fmaf(qs[row * d + c], ks[lane * (d + 1) + c], sc);
            const bool ok = key < S && (!causal || key <= qrow);
            sc = ok ? sc * scale : NEG_INF;
            const float mn = fmaxf(m[i], warp_max(sc));
            const float p = ok ? expf(sc - mn) : 0.f;
            const float corr = (m[i] == NEG_INF) ? 0.f : expf(m[i] - mn);
            m[i] = mn;
            l[i] = l[i] * corr + warp_sum(p);
            const float pv = to_f(from_f<T>(p));   // p in v's dtype
#pragma unroll
            for (int c = 0; c < D_MAX / 32; ++c) acc[i][c] *= corr;
            for (int j = 0; j < SK; ++j) {
                const float pj = __shfl_sync(0xffffffffu, pv, j);
#pragma unroll
                for (int c = 0; c < D_MAX / 32; ++c) {
                    const int col = lane + 32 * c;
                    if (col < d) acc[i][c] = fmaf(pj, vs[j * d + col], acc[i][c]);
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
        for (int c = 0; c < D_MAX / 32; ++c) {
            const int col = lane + 32 * c;
            if (col < d) o[qrow * st.os + col] = from_f<T>(acc[i][c] / den);
        }
    }
}

// 4-D TMA descriptor of a (B, H, S, d) bf16 tensor with element strides
// (sb, sh, ss) and a unit d stride: 16-column boxes of ``rows`` positions
// of one (batch, head), 32-byte swizzle.
bool attn_map(CUtensorMap* map, const void* base, int B, int H, int S, int d,
              long long sb, long long sh, long long ss, int rows) {
    const uint64_t dims[4] = {(uint64_t)d, (uint64_t)S, (uint64_t)H,
                              (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)ss * 2, (uint64_t)sh * 2,
                                 (uint64_t)sb * 2};
    const uint32_t box[4] = {16, (uint32_t)rows, 1, 1};
    return hop::tensor_map<4>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims,
                              strides, box, CU_TENSOR_MAP_SWIZZLE_32B);
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int S, int causal, float scale,
                         const Strides& st, cudaStream_t s) {
    using F = FaCfg<D>;
    static std::once_flag once;
    static cudaError_t attr = cudaSuccess;
    std::call_once(once, [] {
        attr = cudaFuncSetAttribute(
            flash_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            F::SMEM);
    });
    if (attr != cudaSuccess) return attr;
    CUtensorMap tq{}, tk{}, tv{};
    if (!attn_map(&tq, q, B, H, S, D, st.qb, st.qh, st.qs, F::QROWS) ||
        !attn_map(&tk, k, B, H, S, D, st.kb, st.kh, st.ks, FA_KT) ||
        !attn_map(&tv, v, B, H, S, D, st.vb, st.vh, st.vs, FA_KT))
        return cudaErrorInvalidValue;
    const dim3 grid(B * H, (S + F::QROWS - 1) / F::QROWS);
    flash_wgmma<D><<<grid, F::THREADS, F::SMEM, s>>>(
        tq, tk, tv, static_cast<bf16*>(o), H, S, causal, scale, st.ob, st.oh,
        st.os);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scalar(const void* q, const void* k, const void* v,
                          void* o, int BH, int H, int S, int d, int causal,
                          float scale, const Strides& st, cudaStream_t s) {
    static std::once_flag once;
    static cudaError_t attr = cudaSuccess;
    std::call_once(once, [] {
        attr = cudaFuncSetAttribute(
            flash_scalar<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            scalar_smem_floats(D_MAX) * (int)sizeof(float));
    });
    if (attr != cudaSuccess) return attr;
    const dim3 grid(BH, (S + SQ - 1) / SQ);
    flash_scalar<T><<<grid, SC_THREADS,
                      scalar_smem_floats(d) * sizeof(float), s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), H, S, d, causal, scale,
        st);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_attention_d_max() { return D_MAX; }

// q, k, v, o: (B, H, S, d) addressed by ``strides`` (12 element strides:
// batch, head, position of q, k, v, o in turn; the d axis contiguous).
// dtype: 0 fp32, 1 bf16.  use_wgmma: the wgmma kernel (bf16, d a
// multiple of 16, every stride a multiple of 8 and every base 16-byte
// aligned); else the CUDA-core kernel.  d <= 256.  Returns the first
// CUDA error.
int flash_attention_fwd(int dtype, int use_wgmma, const void* q,
                        const void* k, const void* v, void* o, int B, int H,
                        int S, int d, int causal, float scale,
                        const long long* strides, void* stream) {
    if (B < 1 || H < 1 || S < 1 || d < 1 || d > D_MAX ||
        (long long)B * H > 2147483647LL || (S + SQ - 1) / SQ > 65535 ||
        (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
               strides[5], strides[6], strides[7], strides[8], strides[9],
               strides[10], strides[11]};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (use_wgmma) {
        bool ok = dtype == 1 && d % 16 == 0;
        for (int i = 0; i < 12; ++i) ok = ok && strides[i] % 8 == 0;
        ok = ok && ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) |
                     reinterpret_cast<uintptr_t>(o)) % 16 == 0);
        if (!ok) return (int)cudaErrorInvalidValue;
#define FA_CASE(DD)                                                         \
    case DD:                                                                \
        return (int)launch_wgmma<DD>(q, k, v, o, B, H, S, causal, scale, st, \
                                     s);
        switch (d) {
            FA_CASE(16) FA_CASE(32) FA_CASE(48) FA_CASE(64) FA_CASE(80)
            FA_CASE(96) FA_CASE(112) FA_CASE(128) FA_CASE(144) FA_CASE(160)
            FA_CASE(176) FA_CASE(192) FA_CASE(208) FA_CASE(224) FA_CASE(240)
            FA_CASE(256)
            default: return (int)cudaErrorInvalidValue;
        }
#undef FA_CASE
    }
    const int BH = B * H;
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
