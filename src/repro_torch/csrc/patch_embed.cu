// Flexible patch embedding and de-embedding for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_embed_kernel` (wrapper
// `patch_embed_pallas`) and `_deembed_kernel` (wrapper
// `patch_deembed_pallas`) of src/repro/kernels/patch_embed/patch_embed.py.
// Both compute out[N, M] = X[N, K] . W[K, M] + b[M] with float32
// accumulation, the bias added in float32 before the one rounding to the
// input's dtype:
//   embed:    patches [N, K = prod(p) c] . W [K, d]        (K small, M = d wide)
//   de-embed: tokens  [N, d] . W [d, K_out = c_out prod(p)] (K = d wide, M small)
//
// What bounds them on the H100. At DiT-XL/2 (B = 8, d = 1152, bf16) every
// shape is memory-bound: embed moves 4.8 MB (mode 0) / 1.4 MB (mode 1),
// de-embed 4.9 MB / 1.6 MB, 0.4-1.5 us at 3.35 TB/s, against <= 0.16 us of
// bf16 tensor-core work. So the design reads each input once, keeps the
// products on the tensor cores (the de-embed contracts over 1152, which on
// CUDA cores would cost more than its byte bound), and gives the card
// enough blocks.
//
// Kernels, chosen by the caller (kernels/patch_embed/patch_embed.py):
//   * the bf16 de-embed with K and M multiples of 8 at 16-byte aligned
//     bases (the main path): `dk::deembed_cluster_kernel`, a split-K
//     thread-block cluster on TMA and wgmma that sums its partials through
//     distributed shared memory (design at its definition), with the tile
//     plan of `deembed_plan`;
//   * the embed, and de-embed shapes a tensor map cannot describe:
//     `gemm_bias_mma_kernel` (bf16, mma.sync) and `gemm_bias_f32_kernel`.
//
// Design of the mma.sync and float32 kernels:
//   * One block of 4 warps per (row tile, 64-column tile). The TPU's
//     exact-tiling assert (N % bn, d % bd) is gone: ragged N, K and M are
//     masked here, and K is zero-padded to the 16-deep MMA step in shared
//     memory (the JAX cases include K = 48; the path has K = 16 and 64).
//   * bf16: X and W tiles (64-deep k chunks) are copied to shared memory
//     with cp.async (16-byte, zero-fill past the tails) when rows are whole
//     16-byte chunks, else by scalar copies, into a ring of chunks so that
//     the next chunks' copies fly while one is computed (2 stages for the
//     embed, whose K is one or two chunks; 4 for the de-embed's 18). A fragments come from
//     ldmatrix, B fragments from ldmatrix.trans of the row-major [k][m]
//     tile; mma.sync m16n8k16 with float32 accumulators. The embed
//     instantiation puts the 4 warps on 4 row groups of 16 (tile 64 x 64);
//     the de-embed one puts them on 4 slices of each k chunk (tile 16 x 64)
//     and sums the slices in shared memory. Steps past K and column tiles
//     past M are skipped, uniformly over the block.
//   * float32: the same tiles on the CUDA cores in float32 (so f32 inputs
//     keep f32 accuracy); each thread owns one column and a strided set of
//     rows.
//   * Epilogue through shared memory: partial sums (and, for the de-embed,
//     the k slices) are added in a fixed order, the bias in float32, and
//     each output is rounded once and stored row-contiguous.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpatch_embed.so patch_embed.cu
// (hopper.cuh beside it).
// Plain C interface, bound with ctypes by kernels/patch_embed/patch_embed.py.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NTHREADS = 128;
constexpr int BC = 64;        // output columns per block
constexpr int KC = 64;        // contraction depth per shared-memory chunk (bf16)
constexpr int LDS = KC + 8;   // pitch (halves) of the X tile: ldmatrix on distinct banks
constexpr int LDW = BC + 8;   // pitch (halves) of the W tile
constexpr int LDO = BC + 4;   // pitch (floats) of the epilogue tile

struct Args {
  const void* x;   // [N, K]
  const void* w;   // [K, M]
  const void* b;   // [M]
  void* o;         // [N, M]
  int N, K, M;
  int vec;         // K and M multiples of 8, 16-byte aligned bases
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills (reads nothing) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy a rows x cols tile (cols a multiple of 8) of a row-major source
// with row pitch src_ld, starting at src, into shared memory at pitch ld;
// zero past rows_valid rows and cols_valid columns. vec: 16-byte copies
// (cols_valid and src_ld multiples of 8, 16-byte aligned src).
__device__ __forceinline__ void stage_bf16(bf16* dst, int ld, const bf16* src, size_t src_ld,
                                           int rows, int cols, int rows_valid, int cols_valid,
                                           bool vec) {
  if (vec) {
    const int cpr = cols / 8;
    for (int e = threadIdx.x; e < rows * cpr; e += NTHREADS) {
      const int r = e / cpr, c = (e % cpr) * 8;
      const bool valid = r < rows_valid && c < cols_valid;
      cp_async16(dst + r * ld + c, valid ? src + r * src_ld + c : src, valid);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += NTHREADS) {
      const int r = e / cols, c = e % cols;
      dst[r * ld + c] =
          (r < rows_valid && c < cols_valid) ? src[r * src_ld + c] : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// c (16x8, f32) += a (16x16, bf16, row-major) * b (16x8, bf16, col-major)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Add the WK partial tiles, the bias in float32, round once, store.
template <typename T, int RB, int WK>
__device__ __forceinline__ void epilogue(const Args& a, const float* sOut, int n0, int m0) {
  const T* b = static_cast<const T*>(a.b);
  T* o = static_cast<T*>(a.o);
  for (int e = threadIdx.x; e < RB * BC; e += NTHREADS) {
    const int r = e / BC, c = e % BC;
    if (n0 + r >= a.N || m0 + c >= a.M) continue;
    float v = 0.f;
#pragma unroll
    for (int s = 0; s < WK; ++s) v += sOut[(s * RB + r) * LDO + c];
    if constexpr (sizeof(T) == 2) {
      v += __bfloat162float(b[m0 + c]);
      o[(size_t)(n0 + r) * a.M + m0 + c] = __float2bfloat16(v);
    } else {
      v += b[m0 + c];
      o[(size_t)(n0 + r) * a.M + m0 + c] = v;
    }
  }
}

// bf16 on the tensor cores. WR warps on row groups of 16, WK warps on the
// 16-deep steps of each k chunk (WR * WK == 4). STAGES chunks of X and W
// in flight (cp.async ring); the epilogue tile reuses the ring's memory.
template <int WR, int WK, int STAGES>
__global__ void __launch_bounds__(NTHREADS) gemm_bias_mma_kernel(Args a) {
  static_assert(WR * WK == NTHREADS / 32, "four warps");
  constexpr int RB = 16 * WR;
  constexpr int XS = RB * LDS, WS = KC * LDW;   // halves per stage
  constexpr int RING = STAGES * (XS + WS) * 2, OUT = WK * RB * LDO * 4;
  __shared__ __align__(16) unsigned char smem[RING > OUT ? RING : OUT];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* sOut = reinterpret_cast<float*>(smem);

  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* w = static_cast<const bf16*>(a.w);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wr = warp % WR, wk = warp / WR;
  const int n0 = blockIdx.x * RB, m0 = blockIdx.y * BC;
  const int nk = (a.K + KC - 1) / KC;
  auto issue = [&](int kc) {
    const int k0 = kc * KC;
    bf16* sX = ring + (kc % STAGES) * (XS + WS);
    stage_bf16(sX, LDS, x + (size_t)n0 * a.K + k0, a.K, RB, KC, a.N - n0, a.K - k0, a.vec);
    stage_bf16(sX + XS, LDW, w + (size_t)k0 * a.M + m0, a.M, KC, BC, a.K - k0, a.M - m0,
               a.vec);
  };

  float acc[BC / 8][4];
#pragma unroll
  for (int n = 0; n < BC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

#pragma unroll
  for (int kc = 0; kc < STAGES - 1; ++kc) {
    if (kc < nk) issue(kc);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    // refill the stage computed last iteration (freed by its trailing barrier)
    if (kc + STAGES - 1 < nk) issue(kc + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();   // chunk kc has landed
    __syncthreads();
    const int k0 = kc * KC;
    const bf16* sX = ring + (kc % STAGES) * (XS + WS);
    const bf16* sW = sX + XS;
#pragma unroll
    for (int s = wk; s < KC / 16; s += WK) {
      if (k0 + s * 16 >= a.K) break;   // uniform: the rest of the chunk is padding
      uint32_t af[4];
      ldmatrix_x4(af, sX + (wr * 16 + (lane & 15)) * LDS + s * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < BC / 8; n += 2) {
        if (m0 + n * 8 >= a.M) break;
        // matrices: k rows s*16.. / +8 x cols n*8.., then cols (n+1)*8..
        uint32_t bw[4];
        ldmatrix_x4_trans(bw, sW + (s * 16 + (lane & 15)) * LDW + (n + (lane >> 4)) * 8);
        mma16816(acc[n], af, bw[0], bw[1]);
        mma16816(acc[n + 1], af, bw[2], bw[3]);
      }
    }
    __syncthreads();   // done with this stage before it is refilled
  }
  cp_async_wait<0>();   // (only empty groups can be left)
  __syncthreads();      // the ring becomes the epilogue tile

  const int g = lane >> 2, tg = lane & 3;
  float* out = sOut + (wk * RB + wr * 16) * LDO;
#pragma unroll
  for (int n = 0; n < BC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[(g + 8 * (e >> 1)) * LDO + n * 8 + tg * 2 + (e & 1)] = acc[n][e];
  __syncthreads();
  epilogue<bf16, RB, WK>(a, sOut, n0, m0);
}

// float32 on the CUDA cores: each thread owns one of the 64 columns and
// rows rg, rg + 2, ... of the RB-row tile.
template <int RB>
__global__ void __launch_bounds__(NTHREADS) gemm_bias_f32_kernel(Args a) {
  constexpr int KF = 32;                 // contraction depth per chunk
  constexpr int RPT = RB / 2;            // rows per thread
  __shared__ float sX[RB * (KF + 1)];
  __shared__ float sW[KF * BC];
  __shared__ __align__(16) float sOut[RB * LDO];

  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);
  const int c = threadIdx.x % BC, rg = threadIdx.x / BC;
  const int n0 = blockIdx.x * RB, m0 = blockIdx.y * BC;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < a.K; k0 += KF) {
    for (int e = threadIdx.x; e < RB * KF; e += NTHREADS) {
      const int r = e / KF, kk = e % KF;
      sX[r * (KF + 1) + kk] =
          (n0 + r < a.N && k0 + kk < a.K) ? x[(size_t)(n0 + r) * a.K + k0 + kk] : 0.f;
    }
    for (int e = threadIdx.x; e < KF * BC; e += NTHREADS) {
      const int kk = e / BC, cc = e % BC;
      sW[kk * BC + cc] =
          (k0 + kk < a.K && m0 + cc < a.M) ? w[(size_t)(k0 + kk) * a.M + m0 + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KF; ++kk) {
      const float wv = sW[kk * BC + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(sX[(rg + 2 * i) * (KF + 1) + kk], wv, acc[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) sOut[(rg + 2 * i) * LDO + c] = acc[i];
  __syncthreads();
  epilogue<float, RB, 1>(a, sOut, n0, m0);
}

// Embed: few k, many columns: 64 x 64 tiles. De-embed: many k, few
// columns: 16 x 64 tiles, the contraction split over the warps.
cudaError_t launch(const Args& a, bool bf16_in, bool embed, cudaStream_t stream) {
  const int rb = embed ? 64 : 16;
  const dim3 grid((a.N + rb - 1) / rb, (a.M + BC - 1) / BC);
  if (bf16_in) {
    if (embed)
      gemm_bias_mma_kernel<4, 1, 2><<<grid, NTHREADS, 0, stream>>>(a);
    else
      gemm_bias_mma_kernel<1, 4, 4><<<grid, NTHREADS, 0, stream>>>(a);
  } else {
    if (embed)
      gemm_bias_f32_kernel<64><<<grid, NTHREADS, 0, stream>>>(a);
    else
      gemm_bias_f32_kernel<16><<<grid, NTHREADS, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

int run(const void* x, const void* w, const void* b, void* o, int dtype, int N, int K,
        int M, int vec, void* stream, bool embed) {
  if ((dtype != 0 && dtype != 1) || N <= 0 || K <= 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  if (vec && (K % 8 || M % 8)) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.w = w;
  a.b = b;
  a.o = o;
  a.N = N;
  a.K = K;
  a.M = M;
  a.vec = dtype == 1 && vec;
  return (int)launch(a, dtype == 1, embed, static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// bf16 de-embed as a split-K cluster kernel: the de-embed's main-path kernel.
//
// The contraction (K = d = 1152 on the path) is split across a thread
// block cluster of CL CTAs. Each CTA owns a 64-row tile, a BN-column tile
// and one K slice of `chunks` x 64: its one thread issues every X and W box
// of the slice at once with TMA onto one mbarrier, so the load latency is
// paid once, not once per chunk. X comes in 64 x 64 boxes in the 128-byte
// swizzle (hopper.cuh: layouts), W likewise at BN = 64 and as 8-column
// boxes with no swizzle at BN = 32. One warpgroup computes the slice with
// wgmma (m64 nBN k16, X K-major, W MN-major, both from shared memory) into
// float32 registers and parks the partial tile in shared memory. After a
// cluster barrier, CTA r sums rows [r * 64 / CL, ...) of every CTA's
// partial through distributed shared memory in the fixed rank order 0..CL-1
// (no atomics: the result is the same from run to run), adds the bias in
// float32, rounds once and stores. A second cluster barrier keeps each CTA
// alive until its peers have read its partial. So W leaves L2 once per 64
// rows (not once per 16), and X once per column tile.
namespace dk {

constexpr int BM = 64;   // rows per CTA (wgmma m64)
constexpr int KC = 64;   // rows of one W box (one chunk of the K slice)

template <int BN>
struct Cfg {
  static constexpr int LDP = BN + 4;   // pitch (floats) of the partial tile
  static __host__ __device__ constexpr int x_bytes(int ks) { return ks * BM * 2; }
  static __host__ __device__ constexpr int w_bytes(int ks) { return ks * BN * 2; }
  static __host__ __device__ constexpr int smem(int ks) {
    return x_bytes(ks) + w_bytes(ks) + BM * LDP * 4 + 8 + 1024;   // + alignment slack
  }
};

// BN = 64: W in the 128-byte swizzle; BN = 32: W as 8-column chunks.
template <int BN>
__global__ void __launch_bounds__(128)
    deembed_cluster_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tw, const Args a, int chunks) {
  namespace cgr = cooperative_groups;
  using C = Cfg<BN>;
  cgr::cluster_group cluster = cgr::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int CL = (int)cluster.num_blocks();
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows
  unsigned char* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const int KS = chunks * KC;
  unsigned char* sX = base;                       // [chunks][BM][128 swizzled]
  unsigned char* sW = sX + C::x_bytes(KS);        // BN 64: [KS][128 swizzled]; 32: [4][KS][16]
  float* sP = reinterpret_cast<float*>(sW + C::w_bytes(KS));   // [BM][LDP]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sP + BM * C::LDP);

  const int n0 = blockIdx.y * BM, m0 = blockIdx.z * BN;
  const int k0 = rank * KS;
  const int kvalid = min(KS, a.K - k0);            // > 0: the plan leaves no empty slice
  const int ksteps = (kvalid + 15) / 16;
  const int wchunks = (kvalid + KC - 1) / KC;      // boxes past K are not copied, nor read;
  // inside the last box TMA zero-fills X's columns and W's rows past K
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // W's columns past M (BN = 32) only reach outputs that are not stored
    const int wcols = BN == 64 ? 1 : min(BN, a.M - m0) / 8;
    const int wbox = BN == 64 ? KC * 128 : KC * 16;
    hopper::mbar_expect_tx(bar, wchunks * (BM * 128 + wcols * wbox));
    for (int s = 0; s < wchunks; ++s) {
      hopper::tma_load_2d(sX + s * BM * 128, &tx, bar, k0 + s * KC, n0);
      for (int cc = 0; cc < wcols; ++cc)
        hopper::tma_load_2d(sW + (BN == 64 ? s * wbox : cc * KS * 16 + s * wbox), &tw, bar,
                            m0 + 8 * cc, k0 + s * KC);
    }
  }
  hopper::mbar_wait(bar, 0);

  float acc[BN / 2];
  hopper::wgmma_fence();
  for (int t = 0; t < ksteps; ++t) {
    const uint64_t dx = hopper::desc_sw128(sX + (t / 4) * BM * 128 + (t % 4) * 32);
    const uint64_t dw = BN == 64 ? hopper::desc_sw128(sW + t * 16 * 128)
                                 : hopper::desc(sW + t * 16 * 16, 128, KS * 16);
    hopper::Wgmma<BN>::template ss<1>(acc, dx, dw, t > 0);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait0();
  hopper::fence_regs<BN / 2>(acc);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(&sP[(warp * 16 + g + 8 * hh) * C::LDP + j * 8 + tg * 2]) =
          make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  cluster.sync();   // every partial tile of the cluster is written

  const int rpr = (BM + CL - 1) / CL;
  const int r_lo = rank * rpr, r_hi = min(BM, r_lo + rpr);
  const bf16* bias = static_cast<const bf16*>(a.b);
  bf16* o = static_cast<bf16*>(a.o);
  for (int e = threadIdx.x; e < (r_hi - r_lo) * (BN / 2); e += 128) {
    const int r = r_lo + e / (BN / 2), c = 2 * (e % (BN / 2));
    if (n0 + r >= a.N || m0 + c >= a.M) continue;
    // every peer's partial in flight at once, then summed in rank order
    // (fixed: the result is the same from run to run)
    float2 p[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < CL)
        p[q] = *reinterpret_cast<const float2*>(cluster.map_shared_rank(sP, q) + r * C::LDP + c);
    float2 v = make_float2(0.f, 0.f);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < CL) {
        v.x += p[q].x;
        v.y += p[q].y;
      }
    v.x += __bfloat162float(bias[m0 + c]);
    v.y += __bfloat162float(bias[m0 + c + 1]);
    *reinterpret_cast<__nv_bfloat162*>(o + (size_t)(n0 + r) * a.M + m0 + c) =
        __floats2bfloat162_rn(v.x, v.y);
  }
  cluster.sync();   // peers have read this CTA's partial before it exits
}

// 2-D tensor map over a row-major [rows, cols] bf16 matrix, boxes of
// box_cols columns (64: in the 128-byte swizzle; 8: none) x box_rows rows.
cudaError_t matrix_map(CUtensorMap* m, const void* p, int rows, int cols, int box_cols,
                       int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {(uint32_t)box_cols, (uint32_t)box_rows};
  return hopper::bf16_map(m, p, 2, dims, strides, box, box_cols == 64);
}

template <int BN>
cudaError_t launch(const Args& a, int cl, int chunks, cudaStream_t stream) {
  using C = Cfg<BN>;
  auto kernel = deembed_cluster_kernel<BN>;
  static cudaError_t configured = cudaErrorNotReady;
  if (configured == cudaErrorNotReady)
    configured = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      232448);
  if (configured != cudaSuccess) return configured;
  const int smem = C::smem(chunks * KC);
  if (smem > 232448) return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  cudaError_t err = matrix_map(&tx, a.x, a.N, a.K, 64, BM);
  if (err == cudaSuccess) err = matrix_map(&tw, a.w, a.K, a.M, BN == 64 ? 64 : 8, KC);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, (a.N + BM - 1) / BM, (a.M + BN - 1) / BN);
  cfg.blockDim = dim3(128, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tx, tw, a, chunks);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace dk

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int patch_embed_fwd(const void* x, const void* w, const void* b, void* o,
                               int dtype, int N, int K, int M, int vec, void* stream) {
  return run(x, w, b, o, dtype, N, K, M, vec, stream, true);
}

extern "C" int patch_deembed_fwd(const void* x, const void* w, const void* b, void* o,
                                 int dtype, int N, int K, int M, int vec, void* stream) {
  return run(x, w, b, o, dtype, N, K, M, vec, stream, false);
}

// The bf16 de-embed on the split-K cluster kernel, with the caller's tile
// plan: col_tile 64 (M a multiple of 64) or 32 columns, a cluster of
// `cluster` CTAs (<= 8) along K, each taking k_slice (a multiple of 64) of
// the contraction; the slices must cover K with none empty. K >= 64 (the
// width of an X box), K and M multiples of 8, 16-byte aligned bases.
// Returns a cudaError_t (0 = launched).
extern "C" int patch_deembed_cluster_fwd(const void* x, const void* w, const void* b, void* o,
                                         int N, int K, int M, int col_tile, int cluster,
                                         int k_slice, void* stream) {
  if (N <= 0 || K < 64 || M <= 0 || K % 8 || M % 8 || cluster < 1 || cluster > 8 ||
      (col_tile == 64 && M % 64) ||
      k_slice <= 0 || k_slice % 64 || (long)(cluster - 1) * k_slice >= K ||
      (long)cluster * k_slice < K || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.w = w;
  a.b = b;
  a.o = o;
  a.N = N;
  a.K = K;
  a.M = M;
  a.vec = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (col_tile == 32) return (int)dk::launch<32>(a, cluster, k_slice / 64, st);
  if (col_tile == 64) return (int)dk::launch<64>(a, cluster, k_slice / 64, st);
  return (int)cudaErrorInvalidValue;
}
