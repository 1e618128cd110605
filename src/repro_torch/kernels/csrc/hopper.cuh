// Hopper building blocks shared by B10 (gemm.cu) and B11
// (flash_attention.cu): mbarriers, TMA tile loads, wgmma matrix
// descriptors and fences, and the host-side TMA descriptor cache.
//
// TMA descriptors (CUtensorMap) are encoded on the host by the driver's
// cuTensorMapEncodeTiled.  The libraries are not linked against libcuda,
// so the function is fetched once through the runtime's
// cudaGetDriverEntryPoint.  A descriptor holds only the base address,
// shape, strides, box and swizzle, so descriptors are cached by exactly
// those: a weight's descriptor is encoded once, and an activation buffer
// that the caching allocator hands out again finds its own.  Descriptors
// reach the kernels as __grid_constant__ parameters.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <array>
#include <cstdint>
#include <map>
#include <mutex>

namespace hop {

// ------------------------------------------------------------------ device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// make the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// block until the phase of ``bar`` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// wgmma shared-memory matrix descriptor.  layout: 1 = 128-byte swizzle,
// 3 = 32-byte swizzle.  lbo/sbo in bytes (multiples of 16); the tile's
// swizzle atom (8 rows) starts aligned, so the base offset is 0.
constexpr uint32_t SWIZZLE_128B = 1, SWIZZLE_32B = 3;

__device__ __forceinline__ uint64_t make_desc(const void* smem, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
    uint64_t d = (smem_u32(smem) & 0x3FFFFu) >> 4;
    d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16;
    d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
    d |= static_cast<uint64_t>(layout) << 62;
    return d;
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Tie each accumulator register to this point of the program, so that the
// compiler moves no read or write of it across a wgmma fence or wait (the
// wgmma writes its registers asynchronously, after its asm statement).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

__device__ __forceinline__ void setmaxnreg_dec40() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
}

__device__ __forceinline__ void setmaxnreg_inc232() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    static std::once_flag once;
    std::call_once(once, [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    });
    return fn;
}

// A tiled TMA descriptor of a rank-R tensor: dims innermost first, strides
// of dims 1..R-1 in bytes.  Cached by every field it encodes.  Returns
// false (and leaves *out alone) if the driver refuses the layout.
template <int R>
bool tensor_map(CUtensorMap* out, CUtensorMapDataType dtype, const void* base,
                const uint64_t (&dims)[R], const uint64_t (&strides)[R - 1],
                const uint32_t (&box)[R], CUtensorMapSwizzle swizzle) {
    using Key = std::array<uint64_t, 4 + 3 * R>;
    static std::mutex mu;
    static std::map<Key, CUtensorMap> cache;
    Key key{};
    key[0] = reinterpret_cast<uint64_t>(base);
    key[1] = static_cast<uint64_t>(dtype);
    key[2] = static_cast<uint64_t>(swizzle);
    key[3] = R;
    for (int i = 0; i < R; ++i) {
        key[4 + i] = dims[i];
        key[4 + R + i] = box[i];
        if (i < R - 1) key[4 + 2 * R + i] = strides[i];
    }
    std::lock_guard<std::mutex> lock(mu);
    auto it = cache.find(key);
    if (it != cache.end()) {
        *out = it->second;
        return true;
    }
    EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    cuuint64_t gdim[R], gstride[R > 1 ? R - 1 : 1];
    cuuint32_t gbox[R], estride[R];
    for (int i = 0; i < R; ++i) {
        gdim[i] = dims[i];
        gbox[i] = box[i];
        estride[i] = 1;
        if (i < R - 1) gstride[i] = strides[i];
    }
    CUtensorMap map;
    const CUresult r = fn(&map, dtype, R, const_cast<void*>(base), gdim,
                          gstride, gbox, estride,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return false;
    if (cache.size() >= 4096) cache.clear();   // bounded: a cache, not a log
    cache.emplace(key, map);
    *out = map;
    return true;
}

}  // namespace hop
