// Hopper building blocks shared by the port's TMA / wgmma kernels (sm_90a):
// tensor maps (encoded through the driver entry point, cached on the host),
// TMA tile loads onto mbarriers and tile stores in bulk groups, mbarrier
// waits, wgmma descriptors for the two shared-memory layouts below, and the
// wgmma instructions the kernels use.
//
// Two shared-memory layouts of a tile of R rows x C bf16 columns, both
// written by TMA and read by wgmma through a matrix descriptor:
//   * 128-byte swizzle (SW128): a box of 64 columns x R rows, each row's
//     128 bytes with its 16-byte chunks permuted by (row % 8), as TMA's
//     CU_TENSOR_MAP_SWIZZLE_128B writes it at a 1024-byte aligned address.
//     K-major operand (rows = M or N, columns = K): stride byte offset
//     1024 (next 8 rows); the k-th 16-column step starts 32 * k bytes in.
//     MN-major operand (rows = K, columns = N): stride byte offset 1024
//     (next 8 rows of K); the 16-row k step starts 2048 * k bytes in.
//   * 64-byte swizzle (SW64), MN-major: a box of 32 columns x R rows, 64
//     bytes a row, as CU_TENSOR_MAP_SWIZZLE_64B writes it at a 1024-byte
//     aligned address; stride byte offset 512 (next 8 rows of K), the
//     16-row k step 1024 bytes in. For 32-wide N (the SSD's x at P = 32).
//   * 32-byte swizzle (SW32), K-major only: a box of 16 columns (one
//     16-deep k step) x R rows, 32 bytes a row, as TMA's
//     CU_TENSOR_MAP_SWIZZLE_32B writes it at a 256-byte aligned address;
//     stride byte offset 256 (next 8 rows). For K = 16 or 48, whose rows
//     are too narrow for a 64-column box: one box a k step, in 32-byte
//     rows, where 8-column boxes would fetch 16 bytes a row.
//   * no swizzle ("interleave"), for column counts that are not whole
//     64s: C / 8 column chunks, chunk j holding its R rows of 8 values (16
//     bytes) back to back, [C / 8][R][8], as a TMA box of (8 columns, R
//     rows) writes it. Every 8 x 8 core matrix is 128 contiguous bytes.
//     K-major operand: leading byte offset (next core matrix along K)
//     R * 16, stride byte offset (next 8 rows) 128. MN-major operand:
//     leading byte offset (next 8 rows of K) 128, stride byte offset (next
//     8 columns of N) R * 16.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace hopper {

// ---------------------------------------------------------------------------
// Host: tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links against the runtime only.
inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) !=
            cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A bf16 or float32 tensor map, zero fill out of bounds, with the given
// swizzle. dims innermost first; strides[i] is the byte stride of
// dims[i + 1]. Encoded maps are cached by (address, type, dims, strides,
// box, swizzle): a call that sees the same tensor again (the usual case
// under PyTorch's caching allocator) pays a table lookup instead of an
// encode.
struct MapKey {
  uint64_t addr;
  int rank, swizzle, dtype;
  uint64_t dims[5], strides[4];
  uint32_t box[5];
  bool operator==(const MapKey& o) const {
    if (addr != o.addr || rank != o.rank || swizzle != o.swizzle || dtype != o.dtype)
      return false;
    for (int i = 0; i < rank; ++i)
      if (dims[i] != o.dims[i] || box[i] != o.box[i] || (i + 1 < rank && strides[i] != o.strides[i]))
        return false;
    return true;
  }
};

inline cudaError_t typed_map(CUtensorMap* out, CUtensorMapDataType dtype, const void* addr,
                             int rank, const uint64_t* dims, const uint64_t* strides,
                             const uint32_t* box, CUtensorMapSwizzle swizzle) {
  constexpr int SLOTS = 256;
  static MapKey keys[SLOTS];
  static CUtensorMap maps[SLOTS];
  static bool used[SLOTS];
  static std::mutex mu;
  MapKey key{};
  key.addr = reinterpret_cast<uint64_t>(addr);
  key.rank = rank;
  key.swizzle = (int)swizzle;
  key.dtype = (int)dtype;
  uint64_t h = (key.addr + (uint64_t)swizzle + 8 * (uint64_t)dtype) * 0x9E3779B97F4A7C15ull;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i + 1 < rank) key.strides[i] = strides[i];
    h = (h ^ (dims[i] * 31 + box[i])) * 0x100000001B3ull;
  }
  const int slot = (int)(h >> 56) % SLOTS;
  std::lock_guard<std::mutex> lock(mu);
  if (used[slot] && keys[slot] == key) {
    *out = maps[slot];
    return cudaSuccess;
  }
  EncodeTiledFn fn = encode_fn();
  if (!fn) return cudaErrorNotSupported;
  cuuint32_t estride[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(out, dtype, (cuuint32_t)rank,
                        const_cast<void*>(addr), reinterpret_cast<const cuuint64_t*>(dims),
                        reinterpret_cast<const cuuint64_t*>(strides),
                        reinterpret_cast<const cuuint32_t*>(box), estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  keys[slot] = key;
  maps[slot] = *out;
  used[slot] = true;
  return cudaSuccess;
}

inline cudaError_t bf16_map_swizzled(CUtensorMap* out, const void* addr, int rank,
                                     const uint64_t* dims, const uint64_t* strides,
                                     const uint32_t* box, CUtensorMapSwizzle swizzle) {
  return typed_map(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, addr, rank, dims, strides, box,
                   swizzle);
}
inline cudaError_t f32_map_swizzled(CUtensorMap* out, const void* addr, int rank,
                                    const uint64_t* dims, const uint64_t* strides,
                                    const uint32_t* box, CUtensorMapSwizzle swizzle) {
  return typed_map(out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, addr, rank, dims, strides, box,
                   swizzle);
}

// With no swizzle or the 128-byte swizzle.
inline cudaError_t bf16_map(CUtensorMap* out, const void* addr, int rank, const uint64_t* dims,
                            const uint64_t* strides, const uint32_t* box, bool swizzle128) {
  return bf16_map_swizzled(out, addr, rank, dims, strides, box,
                           swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
}

// ---------------------------------------------------------------------------
// Device: mbarriers and TMA

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait until the phase of parity `parity` has completed. A wait that
// outlasts 2 s of the card's global timer (a copy that never lands) traps,
// so the launch fails with an error instead of holding the card.
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = global_ns();
    } else if (global_ns() - t0 > 2000000000ull) {
      __trap();
    }
  }
}

// One TMA box from global (tensor map coordinates, innermost first) into
// shared memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
// A 1-D bulk copy of `bytes` (a multiple of 16, from a 16-byte aligned
// address) from global into shared memory; completion counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One TMA box from shared memory to global (tensor map coordinates,
// innermost first), in the thread's current bulk group; TMA clips what
// lies past the tensor's edge. Rules: every thread that wrote the box
// runs `fence_async_shared()` and the block syncs before one thread
// issues the store; that thread then calls `bulk_commit()`, and
// `bulk_wait_read<n>()` before the box's memory is written again (at most
// n groups still reading), and `bulk_wait<0>()` before the block exits.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
// Make this thread's generic-proxy shared-memory writes visible to the
// async proxy (TMA stores, wgmma operands).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---------------------------------------------------------------------------
// Device: wgmma

// Descriptor of a shared-memory operand in the no-swizzle (interleave)
// layout; offsets in bytes.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
// Descriptor of an operand in the 128-byte swizzle layout (8-row groups
// 1024 bytes apart; the leading byte offset is unused for the one 64-column
// group an instruction reads).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return desc(p, 16, 1024) | (1ull << 62);
}
// Descriptor of an MN-major operand in the 64-byte swizzle layout (8-row
// groups of K 512 bytes apart; one 32-column group an instruction).
__device__ __forceinline__ uint64_t desc_sw64(const void* p) {
  return desc(p, 16, 512) | (2ull << 62);
}
// Descriptor of a K-major operand in the 32-byte swizzle layout (8-row
// groups 256 bytes apart).
__device__ __forceinline__ uint64_t desc_sw32(const void* p) {
  return desc(p, 16, 256) | (3ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the accumulator registers ordered around the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// m64nNk16, f32 += bf16 * bf16. ss: A and B from shared memory (A
// K-major); rs: A from registers (the m16n8k16 A fragment of each warp's
// 16 rows). TB = 1: B is MN-major in shared memory.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  template <int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, %7;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Wgmma<32> {
  template <int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  template <int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  }
};

}  // namespace hopper
