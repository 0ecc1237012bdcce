// Mamba2 SSD intra-chunk kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_kernel` (wrapper `ssd_chunk_pallas`)
// of src/repro/kernels/ssd/ssd_chunk.py. Per (batch, chunk of Q tokens) and
// head h, in float32 throughout (x may be bf16; it is widened on load):
//   L[q]      = sum_{k<=q} dt[k] A[h]                  (inclusive cumsum)
//   y[q, p]   = sum_{k<=q} (C_q . B_k) exp(L_q - L_k) dt_k x[k, p]
//   Sc[p, n]  = sum_k exp(L_tot - L_k) dt_k x[k, p] B[k, n]
//   Ltot      = L[Q - 1]
// y is written in x's dtype, Sc and Ltot in float32. The inter-chunk
// recurrence stays outside (kernels/ssd/ops.py), as in the JAX package.
//
// What bounds it on the H100. At one mamba2-130m layer (B = 4, S = 2048,
// 24 heads x 64, N = 128, Q = 128) the call moves ~110 MB (33 us at
// 3.35 TB/s; Sc alone is 50 MB) and does ~6.7 GFLOP in float32 (CB 0.27,
// y 3.2, Sc 3.2): 100 us at the 67 TFLOP/s of the CUDA cores. So in
// float32 it is bound by operations; the design keeps every operand of the
// two products in shared memory and registers and reads each input once.
// (TF32 or bf16 tensor cores would change the function's precision.)
//
// Design, rethought for the card rather than carried over from the TPU:
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
