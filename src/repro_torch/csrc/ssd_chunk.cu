// Mamba2 SSD intra-chunk kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernel `_ssd_kernel` (wrapper `ssd_chunk_pallas`)
// of src/repro/kernels/ssd/ssd_chunk.py. Per (batch, chunk of Q tokens) and
// head h, in float32 (x may be bf16):
//   L[q]      = sum_{k<=q} dt[k] A[h]                  (inclusive cumsum)
//   y[q, p]   = sum_{k<=q} (C_q . B_k) exp(L_q - L_k) dt_k x[k, p]
//   Sc[p, n]  = sum_k exp(L_tot - L_k) dt_k x[k, p] B[k, n]
//   Ltot      = L[Q - 1]
// y is written in x's dtype, Sc and Ltot in float32. The inter-chunk
// recurrence stays outside (kernels/ssd/ops.py), as in the JAX package.
// Two kernels: `ssd_chunk_kernel` ("simt", float32 on the CUDA cores, f32
// or bf16 x) and `wg::ssd_wgmma_kernel` ("wgmma", bf16 x, y and Sc on the
// tensor cores); the wrapper chooses by the inputs.
//
// What bounds it on the H100. At one mamba2-130m layer (B = 4, S = 2048,
// 24 heads x 64, N = 128, Q = 128) the call moves 109.8 MB with bf16 x
// (32.8 us at 3.35 TB/s; Sc alone is 50.3 MB) and 160.2 MB with f32 x
// (47.8 us), and does 4.98 GFLOP over k <= q (CB 0.14, y 1.62, Sc 3.22).
// On the CUDA cores in float32 that is 74 us at 67 TFLOP/s; on the
// tensor cores at float32-level accuracy it is 15 us (three bf16 passes at
// 989 TFLOP/s). So the least time the card needs is the bytes' 32.8 us:
// the function is bound by bytes, and the wgmma kernel exists to bring
// the operations under them.
//
// "wgmma" (bf16 x, P in {32, 64}, N in {64, 128}, Q in {64, 128}):
//   * Split-bf16 operands keep float32-level error. x is bf16 on the path,
//     so it is exact as a bf16 operand: it goes on the B side of both
//     products, from shared memory, and every float32 factor goes on the
//     A side, in registers, as bf16 pieces v = v1 + v2 (+ v3), v1 =
//     bf16(v), v2 = bf16(v - v1), v3 = bf16(v - v1 - v2) (the plain
//     version: kernels/ssd/ref.py `split_bf16`). Each piece times x is
//     exact in the float32 accumulator; two pieces carry 16 significant
//     bits, three carry 24 as float32 does. y = M x takes M in 2 pieces
//     (relative error ~2^-17 before y's own bf16 rounding, 2^-9); Sc^T =
//     (B^T w) x takes B^T w in 3 (Sc is float32 and is carried across
//     chunks). Both are wgmma m64nPk16 with A from registers and x
//     MN-major (no operand is transposed in memory).
//   * Trap, for a later TF32 product: TF32 wgmma takes no transpose flag,
//     so both its operands must be K-major in shared memory. That holds
//     for CB = C B^T only, which is why y and Sc use bf16 pieces.
//   * One CTA per (batch, chunk) and head group (grid as "simt"): one
//     producer warp and two consumer warpgroups. The producer issues each
//     head's x tile [Q][P] by TMA (x viewed as [B S, H P], a box of P
//     columns x Q rows at column h P, 128-byte swizzle at P = 64, 64-byte
//     at P = 32) into a ring of 3 stages on mbarriers, and computes the
//     head's cumsum L (4 steps a lane, then a shuffle scan: the "simt"
//     order, so both kernels see the same L), dt and w_k = exp(L_tot -
//     L_k) dt_k into small per-stage arrays on the same barrier.
//   * CB = C B^T once per CTA on the tensor cores in bf16 pieces, C1 B1 +
//     C1 B2 + C2 B1 (C's two pieces as A fragments in registers, B's two
//     written K-major into C's dead buffer): relative error ~2^-16, the
//     level of M's two pieces. It is kept in shared memory for every head.
//   * Per head, each consumer warpgroup takes one 64-row tile of y (q) and
//     one of Sc^T (n), with no block barrier. The y tiles alternate
//     between the warpgroups head by head: rows 64..127 need twice the
//     k16 steps of rows 0..63 (causal). M = CB exp(L_q - L_k) dt_k is
//     masked to k <= q BEFORE the exponential (for k > q, L_q - L_k > 0
//     and exp can overflow); the exponential is ex2.approx of L log2(e)
//     (relative error ~2e-5 at |L| ~ 150, the size by which the cumsum's
//     order already moves it; y is then rounded to bf16, 2^-9).
//   * Pieces are built for 4 k16 steps (`GROUP`), issued, and waited for
//     (1, 2 or 8 steps a wait are slower: tools/ssd_ablation.py). ptxas
//     gives a 288-thread CTA at most 168 registers a thread: past that it
//     serialises the wgmmas ("insufficient register resources") or
//     spills, so no group's pieces are built under another's products.
//   * y leaves registers as bf16 pairs right after its product. Sc^T (46 %
//     of the bytes) is staged as [P][64 n] float32 in 32-column boxes of
//     the 128-byte swizzle and stored by TMA; stores straight from the
//     accumulators are the other choice (`SC_TMA_STORE`).
//
// "simt" (the first port of the TPU kernel), float32 throughout (x widened
// on load):
//   * The TPU kernel keeps [Q, Q, H] decay and M tensors in VMEM (1.5 MB
//     each at Q = 128, H = 24), seven times a block's 227 KB. Here one
//     block of 8 warps takes one (batch, chunk) and a group of heads, and
//     walks the heads one at a time: CB = C B^T ([Q, Q], computed once per
//     block) stays in registers (an 8 x 8 tile per thread) and is shared
//     by the group's heads; each head's M^T = (CB * decay)^T ([Q, Q] f32,
//     66 KB) is rebuilt in shared memory from it.
//   * B * nc is only 64 at the path's shape against 132 SMs, so the grid
//     is (B * nc, head groups); the wrapper sizes the groups so the blocks
//     fill the SMs about once (2 groups of 12 heads: 128 blocks). The CB
//     recomputed per group costs 1/12 of a group's products.
//   * The causal mask selects k <= q BEFORE the exponential: for k > q,
//     L_q - L_k > 0 and exp can overflow (the TPU's where(causal, exp, 0)
//     only hides that). The y product stops at the warp's last row.
//   * dt_k is folded into x once per head (xd = dt x): y = M xd, and
//     Sc = (exp(L_tot - L) xd)^T B.
//   * The cumsum runs as a warp scan (each lane sums 4 steps, then 5
//     shuffle steps): another summation order than a sequential cumsum,
//     which moves L by a few ulps of |L| (relative ~1e-6 for the path's
//     |L| <= ~100); exp passes that on to y and Sc.
//   * Every global read is an asynchronous copy (cp.async) into shared
//     memory: B and C rows once per block, and each head's x rows and dt
//     while the previous head computes, so the 8 warps of the block (one
//     block per SM: ~205 KB of shared memory) do not wait on loads.
//   * CB is computed from row-major C and B tiles, 4 states per 16-byte
//     load; a thread's 8 query rows are 16 apart, so the C reads of a warp
//     fall on distinct banks.
//   * Sc leaves registers for device memory directly (16-byte stores).
//   * Chunks up to 128, heads up to 64 wide, states up to 128: the tiles are
//     sized for those caps and zero-padded below them. x rows must be whole
//     16-byte chunks (P a multiple of 8 in bf16, 4 in f32) and N a multiple
//     of 4, with 16-byte aligned bases.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libssd_chunk.so ssd_chunk.cu
// Plain C interface, bound with ctypes by kernels/ssd/ssd_chunk.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int QM = 128;        // largest chunk
constexpr int PM = 64;         // largest head dim
constexpr int NM = 128;        // largest state
constexpr int NTHREADS = 256;
constexpr int LDQ = QM + 4;    // pitch (floats) of C^T / M^T rows
constexpr int LDN = NM + 4;    // pitch of B rows
constexpr int LDP = PM + 4;    // pitch of dt*x rows
static_assert(NM <= QM, "C^T is staged in the M^T buffer");
static_assert(QM == 4 * 32, "the cumsum: one warp, 4 steps a lane");
static_assert(QM * QM == 64 * NTHREADS, "CB: an 8 x 8 tile per thread");
static_assert(QM * PM == 32 * NTHREADS && PM * NM == 32 * NTHREADS, "4 x 8 output tiles");

struct Args {
  const void* x;     // [B, S, H, P]
  const float* dt;   // [B, S, H]
  const float* A;    // [H]
  const float* Bm;   // [B, S, N]
  const float* Cm;   // [B, S, N]
  void* y;           // [B, S, H, P]
  float* sc;         // [B, nc, H, P, N]
  float* ltot;       // [B, nc, H]
  int B, S, H, P, N, Q, nc, hpb;
};

constexpr size_t SMEM_BYTES =
    sizeof(float) * (size_t)(QM * LDQ + QM * LDN + QM * LDP + QM * PM + 4 * QM);

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Asynchronous global -> shared copies (no registers; zero-fill when
// !valid, reading nothing).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1) ssd_chunk_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* sMt = smem;              // [QM][LDQ]: C rows (pitch LDN) while CB is built,
                                  // then M^T per head
  float* sB = sMt + QM * LDQ;     // [QM][LDN]: the chunk's B rows
  float* sXd = sB + QM * LDN;     // [QM][LDP]: dt_k x[k, :] of the current head
  float* sXraw = sXd + QM * LDP;  // [QM][P] of T: the next head's x rows, in flight
  float* sL = sXraw + QM * PM;    // [QM]: cumulative log decay of the head
  float* sDt = sL + QM;           // [QM]
  float* sE = sDt + QM;           // [QM]: exp(L_tot - L_k)
  float* sDtRaw = sE + QM;        // [QM]: the next head's dt, in flight
  float* sC = sMt;

  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bc = blockIdx.x;                       // b * nc + c
  const int b = bc / a.nc, c = bc % a.nc;
  const int h_lo = blockIdx.y * a.hpb;
  const int h_hi = min(a.H, h_lo + a.hpb);
  const size_t tok0 = (size_t)b * a.S + (size_t)c * a.Q;   // the chunk's first token

  // x rows (P values of T, whole 16-byte chunks) and dt of head h
  auto issue_head = [&](int h) {
    constexpr int EPC = 16 / sizeof(T);            // elements per 16-byte chunk
    const int cpr = a.P / EPC;
    T* dst = reinterpret_cast<T*>(sXraw);
    for (int e = tid; e < a.Q * cpr; e += NTHREADS) {
      const int k = e / cpr, ch = e % cpr;
      cp_async16(dst + k * a.P + ch * EPC, x + ((tok0 + k) * a.H + h) * a.P + ch * EPC, true);
    }
    if (tid < QM)
      cp_async4(sDtRaw + tid, a.dt + (tid < a.Q ? (tok0 + tid) * a.H + h : 0), tid < a.Q);
  };

  // B and C rows (N a multiple of 4), zero past Q tokens and N states
  for (int e = tid; e < QM * (NM / 4); e += NTHREADS) {
    const int k = e / (NM / 4), n = (e % (NM / 4)) * 4;
    const bool valid = k < a.Q && n < a.N;
    const size_t off = valid ? (tok0 + k) * a.N + n : 0;
    cp_async16(sB + k * LDN + n, a.Bm + off, valid);
    cp_async16(sC + k * LDN + n, a.Cm + off, valid);
  }
  if (h_lo < h_hi) issue_head(h_lo);
  cp_async_wait_all();
  __syncthreads();

  // CB[q][k] = C_q . B_k for q = tq + 16 i, k = tk*8 + j (registers, all
  // heads); consecutive threads read consecutive C rows: no bank conflicts
  const int tq = tid % 16, tk = tid / 16;
  float cb[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) cb[i][j] = 0.f;
  for (int n = 0; n < a.N; n += 4) {
    float4 cv[8], bv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) cv[i] = ld4(sC + (tq + 16 * i) * LDN + n);
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = ld4(sB + (tk * 8 + j) * LDN + n);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        cb[i][j] = fmaf(cv[i].w, bv[j].w,
                        fmaf(cv[i].z, bv[j].z,
                             fmaf(cv[i].y, bv[j].y, fmaf(cv[i].x, bv[j].x, cb[i][j]))));
  }
  __syncthreads();   // C is spent: the buffer becomes M^T

  for (int h = h_lo; h < h_hi; ++h) {
    // this head's x and dt are in shared memory. The inclusive cumsum L
    // of dt A (warp 0: 4 steps a lane, then a shuffle scan over the
    // lanes' totals)
    if (warp == 0) {
      const float Ah = a.A[h];
      float part[4], s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = lane * 4 + j;
        const float d = sDtRaw[k];
        sDt[k] = d;
        s += d * Ah;
        part[j] = s;
      }
      float incl = s;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);   // the lanes before
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sL[lane * 4 + j] = excl + part[j];
    }
    __syncthreads();
    const float Ltot = sL[a.Q - 1];
    if (tid == 0) a.ltot[(size_t)bc * a.H + h] = Ltot;
    for (int k = tid; k < QM; k += NTHREADS) sE[k] = k < a.Q ? expf(Ltot - sL[k]) : 0.f;
    {
      const T* raw = reinterpret_cast<const T*>(sXraw);
      for (int e = tid; e < QM * PM; e += NTHREADS) {
        const int k = e / PM, p = e % PM;
        sXd[k * LDP + p] = (k < a.Q && p < a.P) ? sDt[k] * widen(raw[k * a.P + p]) : 0.f;
      }
    }
    // M^T[k][q] = CB[q][k] exp(L_q - L_k) for k <= q, else 0 (masked
    // before the exponential)
    {
      float lq[8], lk[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        lq[i] = sL[tq + 16 * i];
        lk[i] = sL[tk * 8 + i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = tk * 8 + j;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int q = tq + 16 * i;
          sMt[k * LDQ + q] = cb[i][j] * expf(k <= q ? lq[i] - lk[j] : -INFINITY);
        }
      }
    }
    __syncthreads();   // x and dt staging are spent: the next head's copies fly
    if (h + 1 < h_hi) issue_head(h + 1);

    // y[q][p] = sum_k M^T[k][q] xd[k][p]: q = ty*4.., p = tx*8..; M^T is 0
    // past the warp's last row q = 16 warp + 15, so its k loop stops there
    {
      const int tx = tid % 8, ty = tid / 8;
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      const int k_end = min(a.Q, 16 * warp + 16);
      for (int k = 0; k < k_end; ++k) {
        const float4 m = ld4(sMt + k * LDQ + ty * 4);
        const float4 x0 = ld4(sXd + k * LDP + tx * 8), x1 = ld4(sXd + k * LDP + tx * 8 + 4);
        const float mv[4] = {m.x, m.y, m.z, m.w};
        const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(mv[i], xv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = ty * 4 + i;
        if (q >= a.Q) continue;
        T* dst = y + ((tok0 + q) * a.H + h) * a.P;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (tx * 8 + j < a.P) put(dst + tx * 8 + j, acc[i][j]);
      }
    }

    // Sc[p][n] = sum_k exp(L_tot - L_k) xd[k][p] B[k][n]: p = ty*4..,
    // n = tx*8..
    {
      const int tx = tid % 16, ty = tid / 16;
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int k = 0; k < a.Q; ++k) {
        const float e = sE[k];
        const float4 xk = ld4(sXd + k * LDP + ty * 4);
        const float4 b0 = ld4(sB + k * LDN + tx * 8), b1 = ld4(sB + k * LDN + tx * 8 + 4);
        const float xv[4] = {xk.x * e, xk.y * e, xk.z * e, xk.w * e};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = ty * 4 + i;
        if (p >= a.P) continue;
        float* dst = a.sc + (((size_t)bc * a.H + h) * a.P + p) * a.N;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = tx * 8 + 4 * half;
          if (n < a.N)   // N % 4 == 0: 16-byte aligned rows of Sc
            *reinterpret_cast<float4*>(dst + n) = make_float4(
                acc[i][4 * half], acc[i][4 * half + 1], acc[i][4 * half + 2], acc[i][4 * half + 3]);
        }
      }
    }
    cp_async_wait_all();   // the next head's x and dt have landed
    __syncthreads();       // M^T, xd, L of this head are spent
  }
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static bool configured = false;   // raise the shared-memory cap once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(a.B * a.nc, (a.H + a.hpb - 1) / a.hpb);
  ssd_chunk_kernel<T><<<grid, NTHREADS, SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "wgmma": bf16 x, y and Sc on the tensor cores in split-bf16 pieces (see
// the note at the top).
namespace wg {

constexpr int STAGES = 3;          // x tiles in flight
constexpr int CONSUMERS = 256;     // two warpgroups
constexpr int NT = CONSUMERS + 32; // then the producer warp
constexpr int LD = QM + 4;         // pitch (floats) of the B and C rows
constexpr int LDCB = QM + 8;       // of the CB rows: a half-warp's float2 reads hit distinct banks
constexpr float LOG2E = 1.4426950408889634f;
// Design choices that tools/ssd_ablation.py changes in its copies.
constexpr int Y_PIECES = 2;        // bf16 pieces of M in y = M x
constexpr int SC_PIECES = 3;       // bf16 pieces of B^T w in Sc^T = (B^T w) x
constexpr bool SC_TMA_STORE = true;
constexpr int GROUP = 4;           // k16 steps issued between two waits (Q / 16 is a multiple)
static_assert(NM == QM, "B and C rows share one pitch");

template <int P>
struct Cfg {
  static constexpr int X_BYTES = QM * P * 2;       // one x tile [Q][P] bf16
  static constexpr int CB_BYTES = QM * LDCB * 4;   // C rows (pitch LD), then CB (pitch LDCB)
  static constexpr int STG_BYTES = P * 64 * 4;     // one warpgroup's Sc^T tile [P][64] f32
  static constexpr int OFF_CB = STAGES * X_BYTES;
  static constexpr int OFF_STG = OFF_CB + CB_BYTES;
  static constexpr int OFF_B = OFF_STG + 2 * STG_BYTES;
  static constexpr int OFF_ARR = OFF_B + QM * LD * 4;   // L log2(e), dt, w: [STAGES][QM] each
  static constexpr int OFF_BAR = OFF_ARR + 3 * STAGES * QM * 4;
  static constexpr int SMEM = OFF_BAR + 2 * STAGES * 8 + 1024;   // + alignment slack
  static_assert(QM * LD <= QM * LDCB, "C's rows fit CB's buffer");
  static_assert(2 * QM * NM * 2 <= CB_BYTES, "B's two bf16 pieces fit CB's buffer");
  static_assert(X_BYTES % 1024 == 0 && OFF_CB % 1024 == 0 && OFF_STG % 1024 == 0 &&
                    STG_BYTES % 1024 == 0,
                "swizzled tiles start at 1024-byte boundaries");
  static_assert(SMEM <= 232448, "one CTA's shared memory");
};

struct Maps {
  CUtensorMap x;    // [B S, H P] bf16, box (P, Q)
  CUtensorMap sc;   // [B nc H P, N] f32, box (32, P), 128-byte swizzle
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void warpgroup_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + w) : "memory");
}

// v0, v1 (two neighbouring columns of an A fragment row) as NP bf16
// pieces: f[i][e] holds piece i of the pair, v = sum of the pieces.
template <int NP>
__device__ __forceinline__ void split(float v0, float v1, uint32_t (&f)[NP][4], int e) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
    f[i][e] = *reinterpret_cast<const uint32_t*>(&hv);
    if (i + 1 < NP) {
      const float2 back = __bfloat1622float2(hv);
      v0 -= back.x;   // exact: v0 and its bf16 rounding share the leading bits
      v1 -= back.y;
    }
  }
}

// The k16 step kk of the x tile as the MN-major B operand.
template <int P>
__device__ __forceinline__ uint64_t x_desc(const unsigned char* xs, int kk) {
  if constexpr (P == 64) return hopper::desc_sw128(xs + kk * 16 * 128);
  else return hopper::desc_sw64(xs + kk * 16 * 64);
}

template <int P>
__global__ void __launch_bounds__(NT, 1)
    ssd_wgmma_kernel(const __grid_constant__ Maps maps, const Args a) {
  using C = Cfg<P>;
  constexpr int NACC = P / 2;   // accumulator floats a thread: P / 8 n8 tiles x 4
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sX = base;                                      // [STAGES][Q][P] swizzled
  float* sC = reinterpret_cast<float*>(base + C::OFF_CB);        // [QM][LD], then CB [QM][LDCB]
  float* sCB = sC;
  float* sB = reinterpret_cast<float*>(base + C::OFF_B);         // [QM][LD]
  float* sL2 = reinterpret_cast<float*>(base + C::OFF_ARR);      // [STAGES][QM]: L log2(e)
  float* sDt = sL2 + STAGES * QM;
  float* sW = sDt + STAGES * QM;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::OFF_BAR);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int bc = blockIdx.x;                       // b * nc + c
  const int b = bc / a.nc, c = bc % a.nc;
  const int h_lo = blockIdx.y * a.hpb;
  const int h_hi = min(a.H, h_lo + a.hpb);
  const size_t tok0 = (size_t)b * a.S + (size_t)c * a.Q;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      hopper::mbar_init(&full[st], 33);   // the x copy's expect_tx + the producer's 32 lanes
      hopper::mbar_init(&empty[st], CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  if (tid < CONSUMERS) {
    // B and C rows (N a multiple of 4), zero past Q tokens and N states
    for (int e = tid; e < QM * (NM / 4); e += CONSUMERS) {
      const int k = e / (NM / 4), n = (e % (NM / 4)) * 4;
      const bool valid = k < a.Q && n < a.N;
      const size_t off = valid ? (tok0 + k) * a.N + n : 0;
      cp_async16(sB + k * LD + n, a.Bm + off, valid);
      cp_async16(sC + k * LD + n, a.Cm + off, valid);
    }
  }
  __syncthreads();   // the barriers are initialised

  if (tid >= CONSUMERS) {
    // ---- producer warp: each head's x tile by TMA, and its L, dt, w
    const int lane = tid % 32;
    if (lane == 0) hopper::prefetch_map(&maps.x);
    float dn[4];
    auto load_dt = [&](int h) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = lane * 4 + j;
        dn[j] = h < h_hi && k < a.Q ? __ldg(a.dt + (tok0 + k) * a.H + h) : 0.f;
      }
    };
    load_dt(h_lo);
    for (int i = 0, h = h_lo; h < h_hi; ++i, ++h) {
      const int st = i % STAGES;
      const float d[4] = {dn[0], dn[1], dn[2], dn[3]};
      load_dt(h + 1);   // the next head's dt is in flight while this one is scanned
      if (i >= STAGES) hopper::mbar_wait(&empty[st], ((i / STAGES) - 1) & 1);
      if (lane == 0) {
        hopper::mbar_expect_tx(&full[st], a.Q * P * 2);
        hopper::tma_load_2d(sX + st * C::X_BYTES, &maps.x, &full[st], h * P, (int)tok0);
      }
      // the inclusive cumsum of dt A: 4 steps a lane, then a shuffle scan
      // over the lanes' totals (the "simt" kernel's order)
      const float Ah = __ldg(a.A + h);
      float part[4], s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s += d[j] * Ah;
        part[j] = s;
      }
      float incl = s;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float Ltot = __shfl_sync(0xffffffffu, excl + part[3], 31);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = lane * 4 + j;
        const float L = excl + part[j];
        sL2[st * QM + k] = L * LOG2E;
        sDt[st * QM + k] = d[j];
        sW[st * QM + k] = k < a.Q ? expf(Ltot - L) * d[j] : 0.f;
      }
      if (lane == 31) a.ltot[(size_t)bc * a.H + h] = Ltot;
      hopper::mbar_arrive(&full[st]);
    }
    return;
  }

  // ---- consumer warpgroups
  const int w = tid / 128, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * ((tid % 128) / 32) + g;   // the warp's rows rw, rw + 8 of a 64-row tile
  const int rn = 64 * w + rw;                    // Sc^T rows (states n)
  const bool do_sc = 64 * w < a.N;
  cp_async_wait_all();
  consumer_sync();

  // CB[q][k] = C_q . B_k for every head of the CTA, into shared memory,
  // on the tensor cores in bf16 pieces: CB ~ C1 B1 + C1 B2 + C2 B1
  // (relative error ~2^-16, the level of M's two pieces). Warpgroup w
  // takes rows q in [64 w, 64 w + 64) and all 128 columns k. C's pieces
  // are A fragments in registers (K = the state n); B's pieces go K-major
  // into C's buffer once C is read: piece c, n-group ng at c * 32 KB + ng
  // * 16 KB, rows k of 128 bytes in the 128-byte swizzle
  {
    uint32_t cf[NM / 16][2][4];
#pragma unroll
    for (int s16 = 0; s16 < NM / 16; ++s16)
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const float2 v = *reinterpret_cast<const float2*>(
            sC + (rn + 8 * (e4 & 1)) * LD + 16 * s16 + 8 * (e4 >> 1) + 2 * t);
        split<2>(v.x, v.y, cf[s16], e4);
      }
    consumer_sync();   // C is spent: its buffer takes B's pieces
    unsigned char* sBp = reinterpret_cast<unsigned char*>(sC);
    for (int e = tid; e < QM * (NM / 8); e += CONSUMERS) {
      const int k = e / (NM / 8), j16 = e % (NM / 8), ng = j16 / 8, j = j16 % 8;
      const float4 lo = ld4(sB + k * LD + 8 * j16), hi = ld4(sB + k * LD + 8 * j16 + 4);
      uint32_t pc[2][4];
      split<2>(lo.x, lo.y, pc, 0);
      split<2>(lo.z, lo.w, pc, 1);
      split<2>(hi.x, hi.y, pc, 2);
      split<2>(hi.z, hi.w, pc, 3);
      const int off = ng * QM * 128 + k * 128 + ((j ^ (k & 7)) << 4);
#pragma unroll
      for (int c = 0; c < 2; ++c)
        *reinterpret_cast<uint4*>(sBp + c * QM * NM * 2 + off) =
            make_uint4(pc[c][0], pc[c][1], pc[c][2], pc[c][3]);
    }
    hopper::fence_async_shared();
    consumer_sync();
    float acc[2][32];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e / 32][e % 32] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int s16 = 0; s16 < NM / 16; ++s16) {
      if (16 * s16 >= a.N) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {   // (rows 0..63 need k < 64 only, but a
                                        // branch on w would serialise the wgmmas)
        const unsigned char* b0 = sBp + (s16 / 4) * QM * 128 + hf * 64 * 128 + (s16 % 4) * 32;
        hopper::Wgmma<64>::template rs<0>(acc[hf], cf[s16][0], hopper::desc_sw128(b0), 1);
        hopper::Wgmma<64>::template rs<0>(acc[hf], cf[s16][0],
                                          hopper::desc_sw128(b0 + QM * NM * 2), 1);
        hopper::Wgmma<64>::template rs<0>(acc[hf], cf[s16][1], hopper::desc_sw128(b0), 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
    hopper::fence_regs<32>(acc[0]);
    hopper::fence_regs<32>(acc[1]);
    consumer_sync();   // B's pieces are spent: the buffer takes CB
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(sCB + (rn + 8 * hh) * LDCB + 64 * hf + 8 * j + 2 * t) =
              make_float2(acc[hf][4 * j + 2 * hh], acc[hf][4 * j + 2 * hh + 1]);
    }
    consumer_sync();
  }

  bf16* y = static_cast<bf16*>(a.y);
  float yacc[NACC], sacc[NACC];
  uint32_t fy[GROUP][Y_PIECES][4], fs[GROUP][SC_PIECES][4];
  for (int i = 0, h = h_lo; h < h_hi; ++i, ++h) {
    const int st = i % STAGES;
    const float* L2 = sL2 + st * QM;
    const float* D = sDt + st * QM;
    const float* W = sW + st * QM;
    const unsigned char* xs = sX + st * C::X_BYTES;
    // y's rows alternate between the warpgroups head by head: the tile of
    // rows 64..127 takes twice the k16 steps of rows 0..63 (causal)
    const int yw = w ^ (i & 1);
    const int rq = 64 * yw + rw;                  // y rows (queries q)
    const bool do_y = 64 * yw < a.Q;
    const int ky = min(a.Q, 64 * yw + 64) / 16;   // y's k16 steps: up to the tile's last row
    hopper::mbar_wait(&full[st], (i / STAGES) & 1);

    // y = M x, GROUP k16 steps between waits: M[q][k] = CB exp(L_q - L_k)
    // dt_k, masked to k <= q before the exponential, in Y_PIECES pieces
    if (do_y) {
      const float lq[2] = {L2[rq], L2[rq + 8]};
#pragma unroll
      for (int e = 0; e < NACC; ++e) yacc[e] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < QM / 16; k0 += GROUP) {
        if (k0 >= ky) continue;
#pragma unroll
        for (int s = 0; s < GROUP; ++s)
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {   // fragment register: rows +8 (e4 & 1), columns +8 (e4 >> 1)
            const int hh = e4 & 1, k = 16 * (k0 + s) + 8 * (e4 >> 1) + 2 * t, q = rq + 8 * hh;
            const float2 cbv = *reinterpret_cast<const float2*>(sCB + q * LDCB + k);
            const float2 lk = *reinterpret_cast<const float2*>(L2 + k);
            const float2 dk = *reinterpret_cast<const float2*>(D + k);
            split<Y_PIECES>(cbv.x * ex2(k <= q ? lq[hh] - lk.x : -INFINITY) * dk.x,
                            cbv.y * ex2(k + 1 <= q ? lq[hh] - lk.y : -INFINITY) * dk.y,
                            fy[s], e4);
          }
        hopper::wgmma_fence();
#pragma unroll
        for (int s = 0; s < GROUP; ++s)
#pragma unroll
          for (int pc = 0; pc < Y_PIECES; ++pc)
            hopper::Wgmma<P>::template rs<1>(yacc, fy[s][pc], x_desc<P>(xs, k0 + s), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait0();   // the group's pieces' registers are free again
      }
      hopper::fence_regs<NACC>(yacc);
      // y: bf16 pairs straight from the accumulators
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = rq + 8 * hh;
        if (q >= a.Q) continue;
        bf16* row = y + ((tok0 + q) * a.H + h) * P;
#pragma unroll
        for (int j = 0; j < P / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * t) =
              __floats2bfloat162_rn(yacc[4 * j + 2 * hh], yacc[4 * j + 2 * hh + 1]);
      }
    }
    // Sc^T = (B^T w) x: A[n][k] = B[k][n] w_k, in SC_PIECES pieces
    if (do_sc) {
#pragma unroll
      for (int e = 0; e < NACC; ++e) sacc[e] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < QM / 16; k0 += GROUP) {
        if (k0 >= a.Q / 16) continue;
#pragma unroll
        for (int s = 0; s < GROUP; ++s)
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            const int k = 16 * (k0 + s) + 8 * (e4 >> 1) + 2 * t, n = rn + 8 * (e4 & 1);
            const float2 wk = *reinterpret_cast<const float2*>(W + k);
            split<SC_PIECES>(sB[k * LD + n] * wk.x, sB[(k + 1) * LD + n] * wk.y, fs[s], e4);
          }
        hopper::wgmma_fence();
#pragma unroll
        for (int s = 0; s < GROUP; ++s)
#pragma unroll
          for (int pc = 0; pc < SC_PIECES; ++pc)
            hopper::Wgmma<P>::template rs<1>(sacc, fs[s][pc], x_desc<P>(xs, k0 + s), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait0();
      }
      hopper::fence_regs<NACC>(sacc);
    }
    hopper::mbar_arrive(&empty[st]);   // x, L, dt, w of this stage are spent

    // Sc[p][n] = Sc^T[n][p]
    if (do_sc) {
      const size_t sc_row = ((size_t)bc * a.H + h) * P;   // Sc viewed as [B nc H P, N]
      if constexpr (SC_TMA_STORE) {
        // staged [P][64 n] in two 32-column boxes of the 128-byte swizzle
        // (16-byte chunk j of row p at j ^ (p % 8): no bank conflicts),
        // then one thread stores both boxes
        unsigned char* stg = base + C::OFF_STG + w * C::STG_BYTES;
        const bool lead = tid % 128 == 0;
        if (lead) hopper::bulk_wait_read<0>();   // the last head's store has read the tile
        warpgroup_sync(w);
#pragma unroll
        for (int j = 0; j < P / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int p = 8 * j + 2 * t + e, nl = rw + 8 * hh, cc = nl & 31;
              *reinterpret_cast<float*>(stg + (nl >> 5) * P * 128 + p * 128 +
                                        ((((cc >> 2) ^ (p & 7)) << 4) | ((cc & 3) << 2))) =
                  sacc[4 * j + 2 * hh + e];
            }
        hopper::fence_async_shared();
        warpgroup_sync(w);
        if (lead) {
          hopper::tma_store_2d(&maps.sc, stg, 64 * w, (int)sc_row);
          hopper::tma_store_2d(&maps.sc, stg + P * 128, 64 * w + 32, (int)sc_row);
          hopper::bulk_commit();
        }
      } else {
        float* dst = a.sc + sc_row * a.N;
#pragma unroll
        for (int j = 0; j < P / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              dst[(size_t)(8 * j + 2 * t + e) * a.N + rn + 8 * hh] = sacc[4 * j + 2 * hh + e];
      }
    }
    // end of head
  }
  if (SC_TMA_STORE && tid % 128 == 0) hopper::bulk_wait<0>();   // the stores land before exit
}

template <int P>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<P>;
  auto kernel = ssd_wgmma_kernel<P>;
  static cudaError_t configured = cudaErrorNotReady;
  if (configured == cudaErrorNotReady)
    configured = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (configured != cudaSuccess) return configured;
  Maps m = {};
  const uint64_t xdims[2] = {(uint64_t)a.H * P, (uint64_t)a.B * a.S};
  const uint64_t xstrides[1] = {(uint64_t)a.H * P * 2};
  const uint32_t xbox[2] = {(uint32_t)P, (uint32_t)a.Q};
  cudaError_t err = hopper::bf16_map_swizzled(
      &m.x, a.x, 2, xdims, xstrides, xbox,
      P == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  const uint64_t sdims[2] = {(uint64_t)a.N, (uint64_t)a.B * a.nc * a.H * P};
  const uint64_t sstrides[1] = {(uint64_t)a.N * 4};
  const uint32_t sbox[2] = {32, (uint32_t)P};
  if (err == cudaSuccess)
    err = hopper::f32_map_swizzled(&m.sc, a.sc, 2, sdims, sstrides, sbox,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.nc, (a.H + a.hpb - 1) / a.hpb);
  kernel<<<grid, NT, C::SMEM, stream>>>(m, a);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

extern "C" void ssd_chunk_limits(int* out) {
  out[0] = QM;
  out[1] = PM;
  out[2] = NM;
}

// dtype (of x and y): 0 = float32, 1 = bfloat16. Returns a cudaError_t
// (0 = launched).
extern "C" int ssd_chunk_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                             const void* Cm, void* y, void* sc, void* ltot, int dtype, int B,
                             int S, int H, int P, int N, int chunk, int heads_per_block,
                             void* stream) {
  if ((dtype != 0 && dtype != 1) || chunk <= 0 || chunk > QM || P <= 0 || P > PM || N <= 0 ||
      N > NM || S <= 0 || S % chunk || H <= 0 || heads_per_block <= 0 ||
      (P * (dtype == 1 ? 2 : 4)) % 16 || N % 4)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = static_cast<const float*>(Bm);
  a.Cm = static_cast<const float*>(Cm);
  a.y = y;
  a.sc = static_cast<float*>(sc);
  a.ltot = static_cast<float*>(ltot);
  a.B = B;
  a.S = S;
  a.H = H;
  a.P = P;
  a.N = N;
  a.Q = chunk;
  a.nc = S / chunk;
  a.hpb = heads_per_block;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? (int)launch<bf16>(a, st) : (int)launch<float>(a, st);
}

// The "wgmma" kernel: bf16 x and y, P in {32, 64}, N in {64, 128}, chunk
// in {64, 128}, 16-byte aligned x, Bm, Cm and sc. Returns a cudaError_t
// (0 = launched); what it does not take is cudaErrorInvalidValue, never
// handed to the other kernel.
extern "C" int ssd_chunk_wgmma_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                                   const void* Cm, void* y, void* sc, void* ltot, int B, int S,
                                   int H, int P, int N, int chunk, int heads_per_block,
                                   void* stream) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if ((P != 32 && P != 64) || (N != 64 && N != 128) || (chunk != 64 && chunk != 128) ||
      B <= 0 || S <= 0 || S % chunk || H <= 0 || heads_per_block <= 0 || !aligned(x) ||
      !aligned(Bm) || !aligned(Cm) || !aligned(sc))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = static_cast<const float*>(Bm);
  a.Cm = static_cast<const float*>(Cm);
  a.y = y;
  a.sc = static_cast<float*>(sc);
  a.ltot = static_cast<float*>(ltot);
  a.B = B;
  a.S = S;
  a.H = H;
  a.P = P;
  a.N = N;
  a.Q = chunk;
  a.nc = S / chunk;
  a.hpb = heads_per_block;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return P == 64 ? (int)wg::launch<64>(a, st) : (int)wg::launch<32>(a, st);
}
