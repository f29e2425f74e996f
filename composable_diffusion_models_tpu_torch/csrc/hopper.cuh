// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels
// (fused_dit_block.cu, matmul.cu, flash_attention.cu): shared-memory
// addresses, mbarriers, 16-byte cp.async with zero fill, 2-D TMA copies,
// the proxy fence, the 128-byte-swizzle shared-memory matrix descriptor and
// the warpgroup matrix multiply (wgmma) of bf16 operands into fp32
// accumulators.
//
// Shared-memory operand layouts (all 128-byte swizzled; a buffer of them
// starts on a 1024-byte boundary, because the swizzle is a function of the
// address):
//   K-major (the reduction index contiguous): rows of 64 bf16 (128 bytes),
//     16-byte chunk c of row r stored at chunk c ^ (r % 8); eight rows make
//     a 1024-byte group. The descriptor of a k16 step starts 32 bytes
//     further along the row.
//   MN-major (the row or column index contiguous): panels of 64 columns,
//     each row of a panel one k index (128 bytes), chunk c of k-row r at
//     c ^ (r % 8); the leading byte offset is the stride from one panel to
//     the next, and a k16 step starts 16 rows (2048 bytes) further on.
// The transpose bits of wgmma say which of the two an operand is: 0 for
// K-major, 1 for MN-major.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing is linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace cdm {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the barrier's phase of the given parity has completed. A wait
// of more than two seconds is a protocol fault: the block traps, and the
// launch ends in an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  unsigned long long start = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023u) == 1023u) {
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (start == 0) start = now;
      if (now - start > 2000000000ull) __trap();
    }
  }
}

// 16 bytes global -> shared; of them src_bytes (0 .. 16) are read and the
// rest are written as zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One arrival on the mbarrier when this thread's cp.async copies so far
// have landed; the thread does not wait (the barrier's count includes it)
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// One arrival on the mbarrier that also tells it `bytes` more are to land
// before its phase completes (the tensor copies below count them down)
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// TMA: the box of a 2-D tensor map (its generic address; a __grid_constant__
// kernel parameter) at inner coordinate x and outer y, to shared memory at
// dst, its bytes counted down on the mbarrier at bar. Elements past the
// tensor's edges land as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, uint64_t map, int x,
                                            int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(map), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// The same for a 4-D tensor map, coordinates inner first
__device__ __forceinline__ void tma_load_4d(uint32_t dst, uint64_t map, int x,
                                            int y, int z, int w,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(map), "r"(x), "r"(y), "r"(z), "r"(w), "r"(bar)
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The tensor map of a bf16 tensor of `rank` dimensions, inner first: dims
// elements, strides in elements of every dimension but the inner one
// (multiples of 8: 16 bytes), read in boxes of box elements, 128-byte
// swizzled (box[0] = 64: one 128-byte row) unless told another swizzle
// (64-byte: box[0] = 32), zeros past the edges. The driver's encoder is
// found through the runtime, so the library links nothing but the CUDA
// runtime. Returns false where it cannot be had or refuses the arguments.
static bool encode_bf16_map(
    CUtensorMap* map, const void* base, int rank, const long long* dims,
    const long long* strides, const int* box,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  if (!fn || rank > 5) return false;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], one[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    b[i] = (cuuint32_t)box[i];
    one[i] = 1;
    if (i > 0) s[i - 1] = (cuuint64_t)strides[i - 1] * 2;
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), d, s, b, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Makes this thread's earlier shared-memory writes visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1): start
// address; stride byte offset 1024, from one group of 8 rows of 128 bytes to
// the next; leading byte offset lbo, for an MN-major operand wider than 64
// the stride from one 64-column panel to the next (not read for a K-major
// operand).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Byte offset of the 16-byte chunk c (0 .. 7) of row r in 128-byte-swizzled
// rows: the layout of both operand forms above
__device__ __forceinline__ uint32_t sw128_chunk(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// wgmma m64nNk16, bf16 x bf16 -> fp32: acc (64 x N) = A (64 x 16) @ B
// (16 x N) + (scale_d ? acc : 0). ss: A and B from shared memory through
// descriptors; rs: A from registers, a0..a3 this thread's fragment (rows
// lane / 4 and + 8 of its warp's 16, columns 2 * (lane % 4) + {0, 1} and
// + 8, two bf16 a register, the lower column in the low half). TA and TB are
// the transpose bits (0 K-major, 1 MN-major). The accumulator fragment of a
// thread: acc[4 j .. 4 j + 1] are row lane / 4 of its warp's 16, columns
// 8 j + 2 * (lane % 4) + {0, 1}; acc[4 j + 2 .. 4 j + 3] the same columns of
// row lane / 4 + 8.
template <int N> struct Wgmma;

#define CDM_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define CDM_F8(d, i) CDM_F4(d, i), CDM_F4(d, i + 4)
#define CDM_F32(d, i) CDM_F8(d, i), CDM_F8(d, i + 8), CDM_F8(d, i + 16), \
                      CDM_F8(d, i + 24)
#define CDM_ACC8(d) CDM_F8(d, 0)
#define CDM_ACC16(d) CDM_F8(d, 0), CDM_F8(d, 8)
#define CDM_ACC32(d) CDM_F32(d, 0)
#define CDM_ACC64(d) CDM_F32(d, 0), CDM_F32(d, 32)
#define CDM_ACC128(d) CDM_F32(d, 0), CDM_F32(d, 32), CDM_F32(d, 64), \
                      CDM_F32(d, 96)

// m64n16k16
template <> struct Wgmma<16> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : CDM_ACC8(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[8], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db,
                                            int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : CDM_ACC8(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d),
        "n"(TB));
  }
};

// m64n32k16
template <> struct Wgmma<32> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      " %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : CDM_ACC16(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[16], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db,
                                            int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      " %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : CDM_ACC16(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d),
        "n"(TB));
  }
};

// m64n64k16
template <> struct Wgmma<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      " %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : CDM_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db,
                                            int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      " %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : CDM_ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d),
        "n"(TB));
  }
};

// m64n128k16
template <> struct Wgmma<128> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      " %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      " %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : CDM_ACC64(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[64], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db,
                                            int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      " %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      " %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : CDM_ACC64(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d),
        "n"(TB));
  }
};

// m64n256k16
template <> struct Wgmma<256> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[128], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      " %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      " %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      " %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      " %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      " %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, "
      " %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      " %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : CDM_ACC128(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[128], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db,
                                            int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      " %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      " %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      " %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      " %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      " %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, "
      " %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      " %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : CDM_ACC128(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d),
        "n"(TB));
  }
};

#undef CDM_F4
#undef CDM_F8
#undef CDM_F32
#undef CDM_ACC8
#undef CDM_ACC16
#undef CDM_ACC32
#undef CDM_ACC64
#undef CDM_ACC128

}  // namespace cdm
