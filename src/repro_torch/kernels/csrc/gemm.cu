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
// every weight read once, 5.33 GB a step, 1.59 ms at 3.35 TB/s.  Four
// routes, chosen on the host by a stated shape rule (kernels/gemm.py):
//
//  * wgmma (M > 16, bf16, K and N multiples of 8, 16-byte-aligned bases):
//    a persistent grid, one block of three warpgroups per SM walking
//    128 x 192 output tiles (tile t: row tile t mod m_tiles, column tile
//    t / m_tiles, so the tiles in flight share B's column strips).  One
//    thread of the producer warpgroup keeps TMA loads of A (128 x 64, K
//    contiguous) and B (64 x 192, as three 64-column boxes, N contiguous)
//    in flight through a ring of 5 shared-memory stages with 128-byte
//    swizzle, each stage completed on an mbarrier.  Two consumer
//    warpgroups, 64 rows each, run wgmma.mma_async m64n192k16 bf16 ->
//    fp32 on the stages as they land, one group in flight, and release
//    each stage to the producer through a second mbarrier.  B is
//    MN-major for wgmma; the descriptor's transpose bit takes it as it
//    is, so no transposed copy of a weight is ever made.  The producer
//    gives its registers to the consumers (setmaxnreg 40 / 232), which
//    hold a 64 x 192 fp32 tile (96 registers a thread).  The epilogue
//    rounds once to bf16 (nearest even) and masks ragged M and N; it
//    overlaps the producer's loads for the block's next tile.
//    The tile width BN.  Counted in waves over 132 SMs at M = 2048, 160
//    looks best at N = 2560 (256 tiles, 1.94 waves, against 2.42 for 128
//    and 1.21 for 256) and 128 at N = 6912 (6.55 waves against 3.27 for
//    256).  But a tile's time is not its share of the FLOPs: every
//    tile reads its A rows and B columns from L2, and the time of a wave
//    follows the bytes a stage moves (A's 16 KB plus 8 KB per 64-column
//    box of B: 4, 5 and 6 units at BN = 128, 192 and 256) more than its
//    products, so wider tiles, which move fewer bytes per product, win
//    back part of what their partial last wave loses, and BN = 160 moves
//    as many bytes as 192 (three boxes) for fewer products.  Timed on an
//    H100 at the three prefill shapes, BN = 192 (three whole boxes, 5
//    stages) was the fastest of 128, 160, 192 and 256 at each, so it is
//    the width: N = 2560 makes 224 tiles (1.70 waves), N = 6912 576
//    (4.36 waves).
//  * mma.sync (M > 16, bf16 shapes the wgmma route cannot take: K or N
//    not a multiple of 8, since TMA needs 16-byte global strides): a
//    128 x 128 output tile per block of 8 warps, the K axis walked in
//    32-wide steps.  A and B tiles are staged element by element in two
//    shared-memory stages (rows that are not 16-byte aligned rule out
//    vector copies), read into registers by ldmatrix (B transposed on
//    the way), and multiplied by mma.sync m16n8k16 bf16 -> fp32.  Rows are padded by 8 elements so that ldmatrix reads are
//    free of bank conflicts.
//  * fp32 (M > 16): 64 x 64 tiles of fp32 fused multiply-adds on the CUDA
//    cores, 4 x 4 outputs a thread.  Not on the served path (the model
//    is bf16); there so that fp32 callers get the true fp32 product
//    (TF32 would keep three digits).
//  * small-M (M <= 16: decode, and prefill's unembedding of the last
//    position), fp32 or bf16: a matrix-vector shape, bound by reading B
//    once.  A block owns a strip of B's columns 256 bytes wide and one
//    slice of K; the K slices of a strip are the blocks of one thread
//    block cluster (up to 8), so a strip's K is split over up to 8 SMs
//    and the grid makes up to two blocks per SM (all resident at once:
//    a third would wait for a second round) even at N = 2560.  A
//    producer warp streams the slice's B rows through a ring of six
//    16 KB stages (a TMA box of 64 rows when B's rows are 16-byte
//    aligned, else plain loads), so 96 KB a block are in flight.  A is
//    staged once per 512 columns of K with 16-byte loads.  Four consumer
//    warps take one 4-byte word of each row (two bf16 columns) and
//    alternate halves of the stage's rows, all rows of A at once.  The
//    split-K sum stays on chip: each block leaves its partial in shared
//    memory, and after a cluster barrier each block sums its share of
//    the strip's columns over the cluster's blocks through distributed
//    shared memory, in rank order, and rounds once.  So the result is
//    deterministic and a call is one launch, with no partials in device
//    memory, no fence and no atomic.
//
// Every route masks ragged M, N and K (out-of-range elements load as
// zeros and are never stored).  Products are summed in fp32 and rounded
// once to the output dtype (round to nearest even), as the reference
// does.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

namespace cg = cooperative_groups;
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

template <int ALIGN>
__device__ __forceinline__ uint8_t* align_up(uint8_t* p) {
    return reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(p) + ALIGN - 1) &
        ~static_cast<uintptr_t>(ALIGN - 1));
}

// ---------------------------------------------------------------- M > 16, bf16

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int A_PITCH = BK + 8;    // 80 bytes: ldmatrix rows hit 8 bank groups
constexpr int B_PITCH = BN + 8;    // 272 bytes
constexpr int MMA_THREADS = 256;

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

// Stage the (BM x BK) tile of A and the (BK x BN) tile of B at k0, zeros
// past M, N and K.
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
#pragma unroll
        for (int j = 0; j < 8; ++j)
            As[r][col + j] = (gm < M && gk + j < K)
                ? A[(size_t)gm * K + gk + j] : zero;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {      // B: 512 chunks of 8
        const int c = tid + i * MMA_THREADS;
        const int r = c >> 4, col = (c & 15) * 8;
        const int gk = k0 + r, gn = n0 + col;
#pragma unroll
        for (int j = 0; j < 8; ++j)
            Bs[r][col + j] = (gk < K && gn + j < N)
                ? B[(size_t)gk * N + gn + j] : zero;
    }
}

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

    load_tiles(As[0], Bs[0], A, B, M, N, K, m0, n0, 0, tid);
    for (int kt = 0; kt < nk; ++kt) {
        if (kt + 1 < nk)
            load_tiles(As[(kt + 1) & 1], Bs[(kt + 1) & 1], A, B, M, N, K, m0,
                       n0, (kt + 1) * BK, tid);
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

// ---------------------------------------------------------- M > 16, wgmma

constexpr int WG_BM = 128, WG_BN = 192, WG_BK = 64;
constexpr int WG_THREADS = 384;    // consumer warpgroups 0, 1; producer 2

struct WgTile {
    static constexpr int CHUNKS = WG_BN / 64;          // 64-column B boxes
    static constexpr int A_BYTES = WG_BM * WG_BK * 2;  // 128 rows x 128 B
    static constexpr int B_BYTES = CHUNKS * WG_BK * 128;
    static constexpr int STAGE = A_BYTES + B_BYTES;    // 40 KB
    static constexpr int STAGES = 5;
    static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

__global__ void __launch_bounds__(WG_THREADS, 1)
gemm_wgmma(const __grid_constant__ CUtensorMap tm_a,
           const __grid_constant__ CUtensorMap tm_b, bf16* __restrict__ C,
           int M, int N, int K) {
    using T = WgTile;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = align_up<1024>(smem_raw);   // 128-byte swizzle atoms
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::STAGES * T::STAGE);
    uint64_t* empty = full + T::STAGES;
    const int m_tiles = (M + WG_BM - 1) / WG_BM;
    const int tiles = m_tiles * ((N + WG_BN - 1) / WG_BN);
    const int k_steps = (K + WG_BK - 1) / WG_BK;
    const int wg = threadIdx.x / 128;

    if (threadIdx.x == 0) {
        for (int s = 0; s < T::STAGES; ++s) {
            hop::mbar_init(&full[s], 1);      // the producer's expect_tx
            hop::mbar_init(&empty[s], 8);     // one arrival per consumer warp
        }
        hop::fence_barrier_init();
    }
    __syncthreads();

    if (wg == 2) {
        hop::setmaxnreg_dec40();
        if (threadIdx.x == 2 * 128) {
            int stage = 0;
            uint32_t phase = 0;
            for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
                const int m0 = (tile % m_tiles) * WG_BM;
                const int n0 = (tile / m_tiles) * WG_BN;
                for (int ks = 0; ks < k_steps; ++ks) {
                    hop::mbar_wait(&empty[stage], phase ^ 1u);
                    uint8_t* a_s = smem + stage * T::STAGE;
                    uint8_t* b_s = a_s + T::A_BYTES;
                    hop::mbar_expect_tx(&full[stage], T::STAGE);
                    hop::tma_load_2d(a_s, &tm_a, &full[stage], ks * WG_BK, m0);
#pragma unroll
                    for (int c = 0; c < T::CHUNKS; ++c)
                        hop::tma_load_2d(b_s + c * WG_BK * 128, &tm_b,
                                         &full[stage], n0 + c * 64,
                                         ks * WG_BK);
                    if (++stage == T::STAGES) {
                        stage = 0;
                        phase ^= 1u;
                    }
                }
            }
        }
    } else {
        hop::setmaxnreg_inc232();
        const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
        float acc[WG_BN / 2];
        int stage = 0;
        uint32_t phase = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            const int m0 = (tile % m_tiles) * WG_BM;
            const int n0 = (tile / m_tiles) * WG_BN;
#pragma unroll
            for (int i = 0; i < WG_BN / 2; ++i) acc[i] = 0.f;
            int held = -1;                    // the stage the last group reads
            for (int ks = 0; ks < k_steps; ++ks) {
                hop::mbar_wait(&full[stage], phase);
                const uint8_t* a_s = smem + stage * T::STAGE + wg * 64 * 128;
                const uint8_t* b_s = smem + stage * T::STAGE + T::A_BYTES;
                hop::wg_fence();
#pragma unroll
                for (int kk = 0; kk < WG_BK / 16; ++kk) {
                    // A: K-major, 128-byte rows, 8-row groups 1024 B apart;
                    // a k16 step is 32 bytes along the swizzled row.
                    // B: MN-major, 16 K rows a step (2048 B), 64-column
                    // boxes WG_BK x 128 B apart.
                    const uint64_t da = hop::make_desc(
                        a_s + kk * 32, 16, 1024, hop::SWIZZLE_128B);
                    const uint64_t db = hop::make_desc(
                        b_s + kk * 16 * 128, WG_BK * 128, 1024,
                        hop::SWIZZLE_128B);
                    WgmmaSS<WG_BN>::template run<0, 1>(acc, da, db, 1);
                }
                hop::wg_commit();
                hop::wg_wait<1>();            // the previous step's group is done
                if (held >= 0) {
                    __syncwarp();
                    if (lane == 0) hop::mbar_arrive(&empty[held]);
                }
                held = stage;
                if (++stage == T::STAGES) {
                    stage = 0;
                    phase ^= 1u;
                }
            }
            hop::wg_wait<0>();
            hop::fence_regs(acc);
            if (held >= 0) {
                __syncwarp();
                if (lane == 0) hop::mbar_arrive(&empty[held]);
            }
            // epilogue: the accumulator's rows r and r + 8, column pairs
            const int row = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
            for (int nb = 0; nb < WG_BN / 8; ++nb) {
                const int col = n0 + nb * 8 + (lane & 3) * 2;
                if (col >= N) continue;       // N % 8 == 0: col + 1 < N too
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = row + 8 * h;
                    if (r < M)
                        *reinterpret_cast<__nv_bfloat162*>(
                            C + (size_t)r * N + col) =
                            __floats2bfloat162_rn(acc[4 * nb + 2 * h],
                                                  acc[4 * nb + 2 * h + 1]);
                }
            }
        }
    }
}

cudaError_t launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tb,
                         bf16* c, int M, int N, int K, int sms,
                         cudaStream_t s) {
    using T = WgTile;
    static std::once_flag once;
    static cudaError_t attr = cudaSuccess;
    std::call_once(once, [] {
        attr = cudaFuncSetAttribute(
            gemm_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
            T::SMEM);
    });
    if (attr != cudaSuccess) return attr;
    const long long tiles = (long long)((M + WG_BM - 1) / WG_BM) *
                            ((N + WG_BN - 1) / WG_BN);
    const int grid = (int)(tiles < sms ? tiles : sms);
    gemm_wgmma<<<grid, WG_THREADS, T::SMEM, s>>>(ta, tb, c, M, N, K);
    return cudaGetLastError();
}

// ---------------------------------------------------------------- M <= 16

constexpr int SK_ROWS = 64;          // B rows a stage holds
constexpr int SK_ROW_BYTES = 256;    // bytes of one strip row
constexpr int SK_STAGES = 6;
constexpr int SK_CONSUMERS = 128;    // warps 0-3; warp 4 is the producer
constexpr int SK_THREADS = SK_CONSUMERS + 32;
constexpr int SK_ACHUNK = 512;       // K values of A staged at a time
constexpr int SK_MAX_CLUSTER = 8;

template <typename T, int MR>
struct SmallCfg {
    static constexpr int TN = SK_ROW_BYTES / sizeof(T);  // strip columns
    static constexpr int V = 4 / sizeof(T);              // columns a word
    static constexpr int STAGE = SK_ROWS * SK_ROW_BYTES; // 16 KB
    static constexpr int A_OFF = SK_STAGES * STAGE;
    static constexpr int RED_OFF = A_OFF + MR * SK_ACHUNK * 4;
    static constexpr int BAR_OFF = RED_OFF + 2 * MR * TN * 4;
    static constexpr int SMEM = BAR_OFF + 2 * SK_STAGES * 8 + 128;
};

// grid: (column strips x cluster size); cluster rank r owns K rows
// [r * per, min(K, (r + 1) * per)).  MR >= M rows of A are computed.
template <typename T, int MR>
__global__ void __launch_bounds__(SK_THREADS)
gemm_small_m(const __grid_constant__ CUtensorMap tm_b,
             const T* __restrict__ A, const T* __restrict__ B,
             T* __restrict__ C, int M, int N, int K, int per, int use_tma,
             int a_vec) {
    using F = SmallCfg<T, MR>;
    constexpr int TN = F::TN, V = F::V, WORDS = SK_ROW_BYTES / 4;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = align_up<128>(smem_raw);
    float* a_s = reinterpret_cast<float*>(smem + F::A_OFF);   // [MR][ACHUNK]
    float* red = reinterpret_cast<float*>(smem + F::RED_OFF); // [2][MR][TN]
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + F::BAR_OFF);
    uint64_t* empty = full + SK_STAGES;

    cg::cluster_group cluster = cg::this_cluster();
    const int cs = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int n0 = (blockIdx.x / cs) * TN;
    const int k_begin = rank * per;
    const int k_end = min(K, k_begin + per);
    const int n_st = k_end > k_begin ? (k_end - k_begin + SK_ROWS - 1) / SK_ROWS
                                     : 0;
    const int tid = threadIdx.x;

    if (tid == 0) {
        for (int s = 0; s < SK_STAGES; ++s) {
            hop::mbar_init(&full[s], use_tma ? 1 : 32);
            hop::mbar_init(&empty[s], SK_CONSUMERS);
        }
        hop::fence_barrier_init();
    }
    __syncthreads();

    if (tid >= SK_CONSUMERS) {
        // producer warp: TMA boxes of 64 rows x 256 B, or plain loads
        const int lane = tid - SK_CONSUMERS;
        if (!use_tma || lane == 0) {
            int stage = 0;
            uint32_t phase = 0;
            for (int s = 0; s < n_st; ++s) {
                const int k0 = k_begin + s * SK_ROWS;
                hop::mbar_wait(&empty[stage], phase ^ 1u);
                uint8_t* dst = smem + stage * F::STAGE;
                if (use_tma) {
                    hop::mbar_expect_tx(&full[stage], F::STAGE);
                    hop::tma_load_2d(dst, &tm_b, &full[stage], n0, k0);
                } else {
                    T* d = reinterpret_cast<T*>(dst);
                    for (int e = lane; e < SK_ROWS * TN; e += 32) {
                        const int k = k0 + e / TN, n = n0 + e % TN;
                        d[e] = (k < k_end && n < N) ? B[(size_t)k * N + n]
                                                    : from_f<T>(0.f);
                    }
                    hop::mbar_arrive(&full[stage]);
                }
                if (++stage == SK_STAGES) {
                    stage = 0;
                    phase ^= 1u;
                }
            }
        }
    } else {
        const int w = tid % WORDS, half = tid / WORDS;
        float acc[MR][V];
#pragma unroll
        for (int m = 0; m < MR; ++m)
#pragma unroll
            for (int j = 0; j < V; ++j) acc[m][j] = 0.f;
        int stage = 0;
        uint32_t phase = 0;
        for (int s = 0; s < n_st; ++s) {
            const int k0 = k_begin + s * SK_ROWS;
            const int ka = (s * SK_ROWS) % SK_ACHUNK;
            if (ka == 0) {
                // stage A[:, k0, k0 + ACHUNK) as floats, once per chunk
                hop::named_sync(1, SK_CONSUMERS);
                if (a_vec) {
                    constexpr int V16 = 16 / sizeof(T);
                    constexpr int PER_ROW = SK_ACHUNK / V16;
                    for (int e = tid; e < MR * PER_ROW; e += SK_CONSUMERS) {
                        const int m = e / PER_ROW, kk = (e % PER_ROW) * V16;
                        const int k = k0 + kk;
                        float* dst = a_s + m * SK_ACHUNK + kk;
                        if (m < M && k < k_end) {
                            const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
                                A + (size_t)m * K + k));
                            if constexpr (sizeof(T) == 2) {
                                const uint32_t wd[4] = {raw.x, raw.y, raw.z,
                                                        raw.w};
#pragma unroll
                                for (int i = 0; i < 4; ++i) {
                                    const float2 f = __bfloat1622float2(
                                        *reinterpret_cast<const __nv_bfloat162*>(
                                            &wd[i]));
                                    dst[2 * i] = f.x;
                                    dst[2 * i + 1] = f.y;
                                }
                            } else {
                                dst[0] = __uint_as_float(raw.x);
                                dst[1] = __uint_as_float(raw.y);
                                dst[2] = __uint_as_float(raw.z);
                                dst[3] = __uint_as_float(raw.w);
                            }
                        } else {
#pragma unroll
                            for (int i = 0; i < V16; ++i) dst[i] = 0.f;
                        }
                    }
                } else {
                    for (int e = tid; e < MR * SK_ACHUNK; e += SK_CONSUMERS) {
                        const int m = e / SK_ACHUNK, k = k0 + e % SK_ACHUNK;
                        a_s[e] = (m < M && k < k_end)
                            ? to_f(A[(size_t)m * K + k]) : 0.f;
                    }
                }
                hop::named_sync(1, SK_CONSUMERS);
            }
            hop::mbar_wait(&full[stage], phase);
            const uint32_t* rows =
                reinterpret_cast<const uint32_t*>(smem + stage * F::STAGE);
            const int r_end = min(SK_ROWS, k_end - k0);
            const int r_lo = half * (SK_ROWS / 2);
            const int r_hi = min(r_end, r_lo + SK_ROWS / 2);
#pragma unroll 4
            for (int r = r_lo; r < r_hi; ++r) {
                const uint32_t word = rows[r * WORDS + w];
                float b[V];
                if constexpr (sizeof(T) == 2) {
                    const float2 f = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(&word));
                    b[0] = f.x;
                    b[V - 1] = f.y;
                } else {
                    b[0] = __uint_as_float(word);
                }
                const float* ar = a_s + ka + r;
#pragma unroll
                for (int m = 0; m < MR; ++m) {
                    const float a = ar[m * SK_ACHUNK];
#pragma unroll
                    for (int j = 0; j < V; ++j)
                        acc[m][j] = fmaf(a, b[j], acc[m][j]);
                }
            }
            hop::mbar_arrive(&empty[stage]);
            if (++stage == SK_STAGES) {
                stage = 0;
                phase ^= 1u;
            }
        }
        // this block's partial: the two row halves, added in order
#pragma unroll
        for (int m = 0; m < MR; ++m)
#pragma unroll
            for (int j = 0; j < V; ++j)
                red[(half * MR + m) * TN + w * V + j] = acc[m][j];
        hop::named_sync(1, SK_CONSUMERS);
        for (int o = tid; o < MR * TN; o += SK_CONSUMERS)
            red[o] += red[MR * TN + o];
    }
    cluster.sync();   // every block's partial is in its shared memory
    // rank r sums its share of the strip's columns over the cluster's
    // blocks, in rank order (deterministic), and rounds once
    const int cols = (TN + cs - 1) / cs, c_lo = rank * cols;
    for (int o = tid; o < MR * cols; o += SK_THREADS) {
        const int m = o / cols, col = c_lo + o % cols, n = n0 + col;
        if (m >= M || col >= TN || n >= N) continue;
        float sum = 0.f;
        for (int q = 0; q < cs; ++q)
            sum += cluster.map_shared_rank(red, q)[m * TN + col];
        C[(size_t)m * N + n] = from_f<T>(sum);
    }
    cluster.sync();   // no block leaves while its partial may be read
}

template <typename T, int MR>
cudaError_t launch_small(const void* A, const void* B, void* C, int M, int N,
                         int K, int cluster, int per, cudaStream_t s) {
    using F = SmallCfg<T, MR>;
    static std::once_flag once;
    static cudaError_t attr = cudaSuccess;
    std::call_once(once, [] {
        attr = cudaFuncSetAttribute(
            gemm_small_m<T, MR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            F::SMEM);
    });
    if (attr != cudaSuccess) return attr;
    CUtensorMap map{};
    const uint64_t dims[2] = {(uint64_t)N, (uint64_t)K};
    const uint64_t strides[1] = {(uint64_t)N * sizeof(T)};
    const uint32_t box[2] = {(uint32_t)F::TN, (uint32_t)SK_ROWS};
    const bool tma =
        (N * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
        hop::tensor_map<2>(&map, sizeof(T) == 2
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                           B, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    const int a_vec = K % (16 / (int)sizeof(T)) == 0 &&
                      reinterpret_cast<uintptr_t>(A) % 16 == 0;
    const int strips = (N + F::TN - 1) / F::TN;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(strips * cluster, 1, 1);
    cfg.blockDim = dim3(SK_THREADS, 1, 1);
    cfg.dynamicSmemBytes = F::SMEM;
    cfg.stream = s;
    cudaLaunchAttribute attrs[1];
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = cluster;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    cfg.attrs = attrs;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, gemm_small_m<T, MR>, map, static_cast<const T*>(A),
        static_cast<const T*>(B), static_cast<T*>(C), M, N, K, per,
        (int)tma, a_vec);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_small_rows(const void* A, const void* B, void* C, int M,
                              int N, int K, int cluster, int per,
                              cudaStream_t s) {
    if (M <= 4) return launch_small<T, 4>(A, B, C, M, N, K, cluster, per, s);
    if (M <= 8) return launch_small<T, 8>(A, B, C, M, N, K, cluster, per, s);
    return launch_small<T, 16>(A, B, C, M, N, K, cluster, per, s);
}

}  // namespace

extern "C" {

// M <= 16 rows.  dtype: 0 fp32, 1 bf16 (A, B and C all of it).  cluster
// in [1, 8] blocks split K into slices of ``per`` rows (a multiple of 64),
// none empty.  Returns the first CUDA error.
int gemm_small(int dtype, const void* A, const void* B, void* C, int M,
               int N, int K, int cluster, int per, void* stream) {
    if (M < 1 || N < 1 || K < 1 || M > 16 || cluster < 1 ||
        cluster > SK_MAX_CLUSTER || per < 1 || per % SK_ROWS != 0 ||
        (long long)cluster * per < K || (long long)(cluster - 1) * per >= K)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1)
        return (int)launch_small_rows<bf16>(A, B, C, M, N, K, cluster, per, s);
    if (dtype == 0)
        return (int)launch_small_rows<float>(A, B, C, M, N, K, cluster, per,
                                             s);
    return (int)cudaErrorInvalidValue;
}

// M > 16, bf16, K and N multiples of 8, A and B 16-byte aligned: the
// wgmma route on a persistent grid of at most ``sms`` blocks.  Returns
// the first CUDA error (cudaErrorInvalidValue if the shape does not fit
// the route or the driver refuses a TMA descriptor).
int gemm_wgmma(const void* A, const void* B, void* C, int M, int N, int K,
               int sms, void* stream) {
    if (M <= 16 || N < 8 || K < 8 || N % 8 || K % 8 || sms < 1 ||
        (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B)) % 16)
        return (int)cudaErrorInvalidValue;
    CUtensorMap ta{}, tb{};
    const uint64_t a_dims[2] = {(uint64_t)K, (uint64_t)M};
    const uint64_t a_strides[1] = {(uint64_t)K * 2};
    const uint32_t a_box[2] = {WG_BK, WG_BM};
    const uint64_t b_dims[2] = {(uint64_t)N, (uint64_t)K};
    const uint64_t b_strides[1] = {(uint64_t)N * 2};
    const uint32_t b_box[2] = {64, WG_BK};
    if (!hop::tensor_map<2>(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, A, a_dims,
                            a_strides, a_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !hop::tensor_map<2>(&tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, B, b_dims,
                            b_strides, b_box, CU_TENSOR_MAP_SWIZZLE_128B))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    bf16* c = static_cast<bf16*>(C);
    return (int)launch_wgmma(ta, tb, c, M, N, K, sms, s);
}

// Any M, N, K >= 1 (meant for M > 16 shapes the wgmma route does not
// take): bf16 on mma.sync, fp32 on the CUDA cores.  Returns the first
// CUDA error.
int gemm_tiled(int dtype, const void* A, const void* B, void* C, int M,
               int N, int K, void* stream) {
    if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1) {
        if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
        const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
        gemm_bf16_mma<<<grid, MMA_THREADS, 0, s>>>(
            static_cast<const bf16*>(A), static_cast<const bf16*>(B),
            static_cast<bf16*>(C), M, N, K);
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
