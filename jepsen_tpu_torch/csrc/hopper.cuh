// hopper: the Hopper (sm_90a) building blocks the port's tensor-core
// kernels share: mbarriers, TMA tile loads, wgmma shared-memory
// descriptors and group control, and cuTensorMapEncodeTiled reached
// through the CUDA runtime (so no library links -lcuda).
//
// Included by csrc/elle_closure.cu and csrc/elle_bitmm.cuh, each into
// one translation unit; everything here has internal linkage.

#pragma once

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums only: no driver call is linked
#include <cuda_runtime.h>

namespace {

constexpr long long kSpinLimit = 20000000000LL;  // cycles (~10 s)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the phase of `parity` to complete; trap if it never does
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kSpinLimit) __trap();
}

// one box of a 2-D tensor map at (x, y) into shared memory at dst,
// completing on mbarrier bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// the same for a 3-D tensor map at (x, y, z); the parts of the box
// outside the tensor arrive as zeros and count toward the transaction
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int x,
                                            int y, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

// a wgmma shared-memory descriptor with 128-byte swizzle; the start
// address and both byte offsets in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// -- host: the tensor-map encoder ----------------------------------------------

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// entry-point codes beyond the runtime's cudaError_t range
constexpr int kEncodeError = 100000;  // + the CUresult of a failed encode
constexpr int kEntryError = 200000;   // + the driver entry point query result

EncodeTiled g_encode = nullptr;

// cuTensorMapEncodeTiled, looked up once; call with the library's lock
int encoder(EncodeTiled* fn) {
  if (!g_encode) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return static_cast<int>(e);
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return kEntryError + static_cast<int>(found);
    g_encode = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = g_encode;
  return 0;
}

// the text of an entry point's return code
const char* error_text(int code) {
  if (code >= kEntryError)
    return "cuTensorMapEncodeTiled not found by cudaGetDriverEntryPoint";
  if (code >= kEncodeError)
    return "cuTensorMapEncodeTiled failed (its CUresult is the code less "
           "100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace
