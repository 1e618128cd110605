// IVF-PQ asymmetric distances (ADC), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel B8 of the JAX package:
//   kernels/ann.py::_adc_topk_kernel (adc_topk): per query an int32 LUT
//   (m * n_codes entries), per candidate m int8 codes stored as code - 128
//   and an id; a candidate's distance is the sum of its m LUT entries, and
//   a candidate whose id is negative (ragged-cell padding) takes the
//   sentinel adc_dmax(m) = 255 m + 1 in value space.  The k smallest come
//   back ascending, ties to the smallest candidate position.
//
// This file computes the distances: it writes each query's row of L int32
// ADC distances, and B5's int32 key mode (csrc/topk_select.cu) selects
// its k smallest on the (distance, position) key, which is the
// reference's order and tie rule for every 1 <= k <= L.  The path needs
// k = 128 (ANN keeps max(k, refine) survivors), past what per-thread
// lists hold; the (Q, L) matrix is 134 MB at the ANN serving bucket
// (Q = 1024, L = 32,768), the same order as the codes the path gathers.
//
// What bounds it on an H100: the bytes it must move, read once: the ids
// of every candidate (4 bytes), the codes of the valid ones only (m
// bytes; an invalid candidate's distance is the sentinel, known from its
// id), the LUTs and the output.  About half of the ANN bucket's slots are
// cell padding, which sits as one contiguous run at the tail of each
// cell's list.  The LUT lookups hit shared memory.
//
// What the design does about it: a block takes one query's LUT (21.5 KB
// at m = 21, n_codes = 256), staged in shared memory once, and a span of
// its candidates, so a bucket launches several waves of blocks.  Each
// warp works alone on 32 candidates at a time, with no barrier across
// the block: one coalesced read of their ids; where none is valid (a
// padding run) the warp writes the sentinel and reads no code; else it
// copies their 32 m contiguous code bytes to its own shared-memory
// buffer with 4-byte loads where aligned, and each lane sums the m
// entries of its candidate.  Where the LUT does not fit in shared memory,
// the same kernel reads it from device memory (through L1) instead.  A
// code past n_codes - 1 is held to n_codes - 1, as in the plain version
// (valid fits never produce one).
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int ADC_THREADS = 256;
constexpr int ADC_WARPS = ADC_THREADS / 32;
constexpr int WARP_BYTES = 1024;       // codes a warp stages at once
constexpr int M_MAX = 4096;            // the widest code a launch takes
constexpr int SPAN_MIN = 8192;         // candidates a block takes at least
constexpr int SMEM_MAX = 232448;       // dynamic shared memory a block may use
constexpr unsigned FULL = 0xffffffffu;

template <bool LUT_IN_SMEM>
__global__ void __launch_bounds__(ADC_THREADS)
adc_dist_kernel(const int* __restrict__ lut, const int8_t* __restrict__ codes,
                const int* __restrict__ ids, int* __restrict__ out, int L,
                int m, int n_codes, int dmax, int splits, int span) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int q = blockIdx.x / splits;
    const int c_lo = (blockIdx.x % splits) * span;
    const int c_hi = min(L, c_lo + span);
    const int lut_len = m * n_codes;
    const int* lut_q = lut + (size_t)q * lut_len;
    int* lut_s = reinterpret_cast<int*>(smem);
    int8_t* buf = reinterpret_cast<int8_t*>(
        smem + (LUT_IN_SMEM ? (size_t)lut_len * 4 : 0)) + warp * WARP_BYTES;
    const int* table = lut_q;
    if (LUT_IN_SMEM) {
        for (int i = threadIdx.x; i < lut_len; i += ADC_THREADS)
            lut_s[i] = lut_q[i];
        table = lut_s;
        __syncthreads();
    }
    const int8_t* codes_q = codes + (size_t)q * L * m;
    const int* ids_q = ids + (size_t)q * L;
    int* out_q = out + (size_t)q * L;

    // span is a multiple of 32, so each warp's 32 candidates start at a
    // multiple of 32 and their codes at a multiple of 4 bytes of the row
    for (int t0 = c_lo + warp * 32; t0 < c_hi; t0 += ADC_THREADS) {
        const int t = t0 + lane;
        const bool live = t < c_hi;
        const bool valid = live && ids_q[t] >= 0;
        if (!__any_sync(FULL, valid)) {   // padding: no code is read
            if (live) out_q[t] = dmax;
            continue;
        }
        const int nbytes = min(32, c_hi - t0) * m;
        const int8_t* src = codes_q + (size_t)t0 * m;
        const bool aligned = (reinterpret_cast<uintptr_t>(src) & 3) == 0;
        const int lo = lane * m;          // this lane's bytes: [lo, lo + m)
        int s = 0;
        for (int b0 = 0; b0 < nbytes; b0 += WARP_BYTES) {
            const int nb = min(WARP_BYTES, nbytes - b0);
            __syncwarp();                 // the last chunk is consumed
            int done = 0;
            if (aligned) {
                const int nw = nb / 4;
                const int* src4 = reinterpret_cast<const int*>(src + b0);
                int* buf4 = reinterpret_cast<int*>(buf);
                for (int i = lane; i < nw; i += 32) buf4[i] = src4[i];
                done = 4 * nw;
            }
            for (int i = done + lane; i < nb; i += 32) buf[i] = src[b0 + i];
            __syncwarp();
            if (valid) {
                const int j1 = min(lo + m, b0 + nb);
                for (int j = max(lo, b0); j < j1; ++j) {
                    // codes hold code - 128; a code past n_codes would
                    // read another subspace's entries, so it is held
                    const int code = min((int)buf[j - b0] + 128, n_codes - 1);
                    s += table[(j - lo) * n_codes + code];
                }
            }
        }
        if (live) out_q[t] = valid ? s : dmax;
    }
}

size_t smem_bytes(int m, int n_codes, bool lut_in_smem) {
    return (size_t)ADC_WARPS * WARP_BYTES +
           (lut_in_smem ? (size_t)m * n_codes * 4 : 0);
}

}  // namespace

extern "C" {

// 1 when the LUT of m * n_codes entries is staged in shared memory, 0 when
// the kernel reads it from device memory.
int adc_lut_in_smem(int m, int n_codes) {
    return smem_bytes(m, n_codes, true) <= (size_t)SMEM_MAX;
}

// lut (Q, m * n_codes) int32, codes (Q, L, m) int8 (code - 128), ids (Q, L)
// int32 -> out (Q, L) int32 ADC distances, adc_dmax(m) where ids < 0.
int adc_dist_i32(const int* lut, const int8_t* codes, const int* ids,
                 int* out, int Q, int L, int m, int n_codes, void* stream) {
    if (Q < 1 || L < 1 || m < 1 || n_codes < 1 || m > M_MAX ||
        (long long)m * n_codes > INT_MAX / 4)
        return (int)cudaErrorInvalidValue;
    // each query's candidates in spans of at least SPAN_MIN, a multiple
    // of 32: the LUT is staged once a span, and the blocks make waves
    const int splits = max(1, L / SPAN_MIN);
    const int span = ((L + splits - 1) / splits + 31) / 32 * 32;
    if ((long long)Q * splits > INT_MAX) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int dmax = 255 * m + 1;
    const bool staged = adc_lut_in_smem(m, n_codes);
    const size_t bytes = smem_bytes(m, n_codes, staged);
    auto kernel = staged ? adc_dist_kernel<true> : adc_dist_kernel<false>;
    if (bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<Q * splits, ADC_THREADS, bytes, s>>>(
        lut, codes, ids, out, L, m, n_codes, dmax, splits, span);
    return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
