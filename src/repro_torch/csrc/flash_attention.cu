// Segment-aware block-sparse flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/attention/flash_attention.py (wrapper `flash_attention`).
// It computes the same function: softmax(q k^T / sqrt(hd)) v per head, with
// GQA (kv head = h / (H / K)), causal and static-window masks, tanh softcap,
// packing segment ids (-1 = padding, never attends nor is attended), the
// caller's [B, nq, nk] block map at the caller's block_q / block_k
// granularity, and rows with no visible key returning exactly 0.
//
// What bounds it on the H100. At the DiT-XL/2 shape (B=8, S=256, H=16,
// hd=72, bf16) the call moves ~18.9 MB (q, k, v read once, o written once):
// ~5.6 us at 3.35 TB/s, against ~2.4 us of bf16 tensor-core work, so the
// function is memory-bound, and a kernel that reads K and V once per query
// tile pays for them again from L2 each time.
//
// Three kernels of the same function, chosen by the caller
// (kernels/attention/flash_attention.py `select_variant`):
//   * bf16, rows of whole 16-byte chunks, hd <= 256 (the main path):
//     `wg::flash_fwd_wgmma_kernel`, built from TMA, mbarriers and wgmma
//     (design at its definition). 128-row CTAs, so each head's K/V leaves
//     L2 twice at S = 256 instead of four times, and a producer warpgroup
//     keeps all of a head's K/V tiles in flight while two consumer
//     warpgroups compute.
//   * bf16 shapes a tensor map cannot describe (hd % 8 != 0 or unaligned
//     bases): `flash_fwd_mma_kernel`, mma.sync with cp.async staging.
//   * float32: `flash_fwd_kernel` on the CUDA cores in float32, so float32
//     inputs keep float32 accuracy.
//
// Common to the three:
//   * One CTA per (b*h, query tile); the TPU's sequential kv grid axis
//     becomes a loop over 64-key tiles inside the CTA, with the running
//     max / normaliser / accumulator in registers (online softmax in
//     float32).
//   * q, k, v are read in their [B, S, H, hd] layout with their own strides,
//     so the wrapper makes no transposed or padded copy. Ragged tails (S, Sk
//     not multiples of the tile) are masked here.
//   * A kv tile is skipped before any load when the causal / window
//     envelope or the caller's block map rules it out (`next_tile`). When
//     the kernel's tile straddles map entries that disagree, the map is
//     applied per element, so any map granularity gives the reference's
//     answer.
//
// mma.sync path: tiles are copied to shared memory as bf16 with cp.async
// (no registers, zero-fill past the tails), hd zero-padded to a multiple of
// 16 (72 -> 80); K/V tiles are double-buffered so the next visited tile's
// copies fly while the current one is computed. A row pitch of hd16 + 8
// halves keeps every ldmatrix on distinct banks. Each warp owns 16 query
// rows: the Q fragments stay in registers for the whole kv loop, K and V
// fragments come from ldmatrix (V transposed on the fly), and the score
// accumulators are re-packed in registers as the A operand of P.V (P
// rounded to bf16, as the TPU kernel rounds it to v's dtype). Instantiated
// for hd <= 64, 80, 128, 256 (at 256 Q's fragments come from shared memory
// at every k-step: 64 registers of them beside 128 accumulators would
// spill).
//
// At the language models' hd 256 (gemma2-9b: B=2, S=8192, H=16 over K=8,
// causal, window 4096 on alternate layers, softcap 50) the call is bound
// by operations, not bytes: 0.83 (window 4096) to 1.1 (global) TFLOP of
// products against 0.4 GB of q, k, v and o, ~0.85-1.1 ms at the
// tensor cores' bf16 peak against 0.12 ms of bytes.
//
// float32 path: tiles staged as float32 at a pitch of round4(hd) + 4; each
// thread keeps an 8-row x 4-key score tile and an 8-row x 4-column-chunk
// output tile in registers and reads shared memory 16 bytes at a time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// (hopper.cuh beside it). Plain C interface, bound with ctypes by
// kernels/attention/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;            // query rows per CTA
constexpr int BK = 64;            // keys per kv tile
constexpr int NTHREADS = 128;
constexpr int CG = 16;            // threads sharing one row group
constexpr int ROWS = BQ / (NTHREADS / CG);   // 8 rows per thread
constexpr int KEYS = BK / CG;     // 4 keys per thread
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int32_t* seg;    // [B, S] or null (all tokens in segment 0)
  const int32_t* bmap;   // [B, map_nq, map_nk] or null (visit every tile)
  int B, S, Sk, H, K, hd;
  int causal;
  float softcap;
  int window;
  float sm_scale;
  int map_bq, map_bk, map_nq, map_nk;
  int vec;               // rows are 16-byte aligned: stage with 16-byte loads
};

// Shared-memory row pitch in floats: hd rounded up to 4 (zero-padded, so
// 16-byte shared loads never read past a row), plus 4, which keeps the
// 8 threads of each 16-byte load phase on distinct banks.
__host__ __device__ inline int pitch(int hd) { return ((hd + 3) / 4) * 4 + 4; }
constexpr int PP = BK + 4;        // pitch of the probability tile

size_t smem_bytes(int hd) {
  return sizeof(float) * (size_t)(BQ * pitch(hd) + 2 * BK * pitch(hd) + BQ * PP) +
         sizeof(int32_t) * BK;
}

// Copy `rows` rows of hd floats (row r at src + r * stride) into shared
// memory, zero past n_valid rows and in the pitch padding. The vector path
// (hd a multiple of 4, so no padding columns) keeps UNROLL 16-byte loads in
// flight per thread.
__device__ __forceinline__ void stage(float* dst, const float* src, size_t stride,
                                      int rows, int n_valid, int hd, bool vec) {
  const int ld = pitch(hd);
  if (vec) {
    constexpr int UNROLL = 4;
    const int cpr = hd / 4;
    const int total = rows * cpr;
    for (int e0 = 0; e0 < total; e0 += NTHREADS * UNROLL) {
      float4 buf[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = e0 + u * NTHREADS + threadIdx.x;
        const int r = e / cpr, c = e - (e / cpr) * cpr;
        buf[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < total && r < n_valid)
          buf[u] = *reinterpret_cast<const float4*>(src + r * stride + c * 4);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = e0 + u * NTHREADS + threadIdx.x;
        if (e < total) {
          const int r = e / cpr, c = e - (e / cpr) * cpr;
          *reinterpret_cast<float4*>(&dst[r * ld + c * 4]) = buf[u];
        }
      }
    }
  } else {
    const int w = ld - 4;
    for (int e = threadIdx.x; e < rows * w; e += NTHREADS) {
      const int r = e / w, d = e % w;
      dst[r * ld + d] = (r < n_valid && d < hd) ? src[r * stride + d] : 0.f;
    }
  }
}

template <int HD_MAX>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(Args a) {
  constexpr int NC = HD_MAX / (4 * CG);   // 4-column output chunks per thread
  extern __shared__ __align__(16) float smem[];
  const int ld = pitch(a.hd);
  float* sQ = smem;                          // [BQ][ld]
  float* sK = sQ + BQ * ld;                  // [BK][ld]
  float* sV = sK + BK * ld;                  // [BK][ld]
  float* sP = sV + BK * ld;                  // [BQ][PP]
  int32_t* sSeg = reinterpret_cast<int32_t*>(sP + BQ * PP);   // [BK]

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float* o = static_cast<float*>(a.o);

  const int tid = threadIdx.x;
  const int rg = tid / CG;
  const int cg = tid % CG;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int kh = h / (a.H / a.K);
  const int q0 = blockIdx.y * BQ;
  const int q_hi = min(q0 + BQ, a.S) - 1;
  const int n_chunks = (ld - 4) / 4;

  stage(sQ, q + ((size_t)(b * a.S + q0) * a.H + h) * a.hd, (size_t)a.H * a.hd,
        BQ, a.S - q0, a.hd, a.vec);

  int qseg[ROWS];
  float m_i[ROWS], l_i[ROWS];
  float4 acc[ROWS][NC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int s = q0 + rg * ROWS + i;
    qseg[i] = s < a.S ? (a.seg ? a.seg[(size_t)b * a.S + s] : 0) : -1;
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int nkt = (a.Sk + BK - 1) / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    const int k_hi = min(k0 + BK, a.Sk) - 1;
    // Tile-level skips: uniform over the CTA, decided before any load.
    if (a.causal && q_hi < k0) continue;
    if (a.window > 0 && (q0 - k_hi >= a.window || k0 - q_hi >= a.window)) continue;
    bool mixed = false;
    if (a.bmap) {
      int any = 0, all = 1;
      for (int mq = q0 / a.map_bq; mq <= q_hi / a.map_bq; ++mq)
        for (int mk = k0 / a.map_bk; mk <= k_hi / a.map_bk; ++mk) {
          const int on = a.bmap[((size_t)b * a.map_nq + mq) * a.map_nk + mk] != 0;
          any |= on;
          all &= on;
        }
      if (!any) continue;
      mixed = !all;
    }

    __syncthreads();   // the previous tile's shared reads are done
    const size_t kv_off = ((size_t)(b * a.Sk + k0) * a.K + kh) * a.hd;
    stage(sK, k + kv_off, (size_t)a.K * a.hd, BK, a.Sk - k0, a.hd, a.vec);
    stage(sV, v + kv_off, (size_t)a.K * a.hd, BK, a.Sk - k0, a.hd, a.vec);
    for (int r = tid; r < BK; r += NTHREADS) {
      const int s = k0 + r;
      sSeg[r] = s < a.Sk ? (a.seg ? a.seg[(size_t)b * a.Sk + s] : 0) : -1;
    }
    __syncthreads();

    float sc[ROWS][KEYS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KEYS; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < ld - 4; d += 4) {
      float4 kv[KEYS];
#pragma unroll
      for (int j = 0; j < KEYS; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&sK[(cg + CG * j) * ld + d]);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(&sQ[(rg * ROWS + i) * ld + d]);
#pragma unroll
        for (int j = 0; j < KEYS; ++j) {
          sc[i][j] = fmaf(qv.x, kv[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv.y, kv[j].y, sc[i][j]);
          sc[i][j] = fmaf(qv.z, kv[j].z, sc[i][j]);
          sc[i][j] = fmaf(qv.w, kv[j].w, sc[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qpos = q0 + rg * ROWS + i;
      unsigned ok = 0;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        const int kr = cg + CG * j;
        const int kpos = k0 + kr;
        float s = sc[i][j] * a.sm_scale;
        if (a.softcap > 0.f) s = tanhf(s / a.softcap) * a.softcap;
        bool allowed = qpos < a.S && kpos < a.Sk;
        if (a.causal) allowed = allowed && qpos >= kpos;
        if (a.window > 0)
          allowed = allowed && qpos - kpos < a.window && kpos - qpos < a.window;
        allowed = allowed && qseg[i] >= 0 && sSeg[kr] == qseg[i];
        if (mixed)
          allowed = allowed &&
                    a.bmap[((size_t)b * a.map_nq + qpos / a.map_bq) * a.map_nk +
                           kpos / a.map_bk] != 0;
        sc[i][j] = allowed ? s : NEG_INF;
        ok |= allowed ? (1u << j) : 0u;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = CG / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        const float p = (ok >> j) & 1u ? expf(sc[i][j] - m_new) : 0.f;
        sP[(rg * ROWS + i) * PP + cg + CG * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = CG / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[i][c].x *= alpha;
        acc[i][c].y *= alpha;
        acc[i][c].z *= alpha;
        acc[i][c].w *= alpha;
      }
    }
    __syncthreads();   // the P tile is complete

    // four keys a step: each row's four probabilities, then one V row at
    // a time (an accumulator element sums its keys in order either way;
    // one V row live keeps hd 256's 128 accumulators within registers)
    for (int j = 0; j < BK; j += 4) {
      float4 pr[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        pr[i] = *reinterpret_cast<const float4*>(&sP[(rg * ROWS + i) * PP + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float4 vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int ch = cg + CG * c;
          vv[c] = ch < n_chunks ? *reinterpret_cast<const float4*>(&sV[(j + jj) * ld + 4 * ch])
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float pj = jj == 0 ? pr[i].x : jj == 1 ? pr[i].y : jj == 2 ? pr[i].z : pr[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc[i][c].x = fmaf(pj, vv[c].x, acc[i][c].x);
            acc[i][c].y = fmaf(pj, vv[c].y, acc[i][c].y);
            acc[i][c].z = fmaf(pj, vv[c].z, acc[i][c].z);
            acc[i][c].w = fmaf(pj, vv[c].w, acc[i][c].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int s = q0 + rg * ROWS + i;
    if (s >= a.S) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
    const size_t base = ((size_t)(b * a.S + s) * a.H + h) * a.hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d0 = 4 * (cg + CG * c);
      const float vals[4] = {acc[i][c].x, acc[i][c].y, acc[i][c].z, acc[i][c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d0 + e < a.hd) o[base + d0 + e] = vals[e] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 path: tensor cores

using bf16 = __nv_bfloat16;

size_t mma_smem_bytes(int hd) {
  const int hd16 = (hd + 15) / 16 * 16;
  return sizeof(bf16) * (size_t)((BQ + 4 * BK) * (hd16 + 8)) + sizeof(int32_t) * 2 * BK;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses registers; zero-fills when
// !valid (no global bytes are read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage `rows` rows of hd bf16 values (row r at src + r * stride) into
// shared memory at pitch ld, zero in columns [hd, hd16) and past n_valid.
// vec (hd % 8 == 0, 16-byte aligned rows): asynchronous 16-byte copies,
// completed by the caller's cp_async_wait; else synchronous scalar copies.
__device__ __forceinline__ void stage_bf16(bf16* dst, int ld, const bf16* src,
                                           size_t stride, int rows, int n_valid,
                                           int hd, int hd16, bool vec) {
  if (vec) {
    const int cpr = hd16 / 8;
    for (int e = threadIdx.x; e < rows * cpr; e += NTHREADS) {
      const int r = e / cpr, c = e - (e / cpr) * cpr;
      const bool valid = r < n_valid && c * 8 < hd;
      cp_async16(dst + r * ld + c * 8, valid ? src + r * stride + c * 8 : src, valid);
    }
  } else {
    for (int e = threadIdx.x; e < rows * hd16; e += NTHREADS) {
      const int r = e / hd16, d = e % hd16;
      dst[r * ld + d] = (r < n_valid && d < hd) ? src[r * stride + d] : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i. trans: each thread gets a column pair instead of
// a row pair (the B operand layout from a row-major [k][n] tile).
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

// The first kv tile at or after kt that the CTA must visit (nkt: none),
// and whether the caller's map disagrees within it. Uniform over the CTA.
__device__ __forceinline__ int next_tile(const Args& a, int kt, int nkt, int b, int q0,
                                         int q_hi, bool* mixed) {
  for (; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    const int k_hi = min(k0 + BK, a.Sk) - 1;
    if (a.causal && q_hi < k0) continue;
    if (a.window > 0 && (q0 - k_hi >= a.window || k0 - q_hi >= a.window)) continue;
    *mixed = false;
    if (a.bmap) {
      int any = 0, all = 1;
      for (int mq = q0 / a.map_bq; mq <= q_hi / a.map_bq; ++mq)
        for (int mk = k0 / a.map_bk; mk <= k_hi / a.map_bk; ++mk) {
          const int on = a.bmap[((size_t)b * a.map_nq + mq) * a.map_nk + mk] != 0;
          any |= on;
          all &= on;
        }
      if (!any) continue;
      *mixed = !all;
    }
    return kt;
  }
  return nkt;
}

// Pipeline: the K/V tiles live in two shared buffers; the copies of the
// next visited tile are in flight while the current one is computed.
template <int HD_MAX>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_mma_kernel(Args a) {
  constexpr int NKS = HD_MAX / 16;   // k-steps of Q K^T
  constexpr int NO = HD_MAX / 8;     // 8-column tiles of the output
  constexpr int NS = BK / 8;         // 8-key tiles of the score tile
  // Q's A fragments stay in registers up to hd 128; at hd 256 they would
  // take 64 of them beside 128 accumulators, so they are read from sQ
  // (which stays put) at every k-step instead
  constexpr bool Q_IN_REGS = HD_MAX <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd16 = (a.hd + 15) / 16 * 16;
  const int ld = hd16 + 8;   // pitch (halves): fragment loads hit distinct banks
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [BQ][ld]
  bf16* sKV = sQ + BQ * ld;                       // [2 buffers][K, V][BK][ld]
  int32_t* sSeg = reinterpret_cast<int32_t*>(sKV + 4 * BK * ld);   // [2][BK]

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  bf16* o = static_cast<bf16*>(a.o);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int row0 = (tid / 32) * 16 + g;   // this thread's rows: row0, row0 + 8
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int kh = h / (a.H / a.K);
  const int q0 = blockIdx.y * BQ;
  const int q_hi = min(q0 + BQ, a.S) - 1;
  const int nkt = (a.Sk + BK - 1) / BK;
  const size_t kv_stride = (size_t)a.K * a.hd;

  auto issue = [&](int kt, int buf) {
    const int k0 = kt * BK;
    const size_t off = ((size_t)(b * a.Sk + k0) * a.K + kh) * a.hd;
    bf16* dk = sKV + (2 * buf) * BK * ld;
    stage_bf16(dk, ld, k + off, kv_stride, BK, a.Sk - k0, a.hd, hd16, a.vec);
    stage_bf16(dk + BK * ld, ld, v + off, kv_stride, BK, a.Sk - k0, a.hd, hd16, a.vec);
    for (int r = tid; r < BK; r += NTHREADS) {
      const int s = k0 + r;
      sSeg[buf * BK + r] = s < a.Sk ? (a.seg ? a.seg[(size_t)b * a.Sk + s] : 0) : -1;
    }
    cp_async_commit();
  };

  stage_bf16(sQ, ld, q + ((size_t)(b * a.S + q0) * a.H + h) * a.hd,
             (size_t)a.H * a.hd, BQ, a.S - q0, a.hd, hd16, a.vec);
  cp_async_commit();
  bool mixed = false, mixed_next = false;
  int kt = next_tile(a, 0, nkt, b, q0, q_hi, &mixed);
  if (kt < nkt) {
    issue(kt, 0);
    cp_async_wait<1>();   // Q has landed (the first K/V tile may still fly)
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  auto load_q = [&](uint32_t* f, int ks) {
    const bf16* p0 = sQ + row0 * ld + ks * 16 + tg * 2;
    f[0] = lds32(p0);
    f[1] = lds32(p0 + 8 * ld);
    f[2] = lds32(p0 + 8);
    f[3] = lds32(p0 + 8 * ld + 8);
  };
  uint32_t qf[Q_IN_REGS ? NKS : 1][4];
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
      if (ks * 16 < hd16) load_q(qf[ks], ks);
  }

  int qseg[2];
  float m_i[2], l_i[2], acc[NO][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int s = q0 + row0 + 8 * hh;
    qseg[hh] = s < a.S ? (a.seg ? a.seg[(size_t)b * a.S + s] : 0) : -1;
    m_i[hh] = NEG_INF;
    l_i[hh] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int buf = 0; kt < nkt; buf ^= 1) {
    const int kt_next = next_tile(a, kt + 1, nkt, b, q0, q_hi, &mixed_next);
    if (kt_next < nkt) {
      issue(kt_next, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // this tile's K/V (and segment ids) are in shared memory
    const int k0 = kt * BK;
    // Every (q, k) pair of the tile visible: no per-element masks (the
    // common case: no padding, segments, causal or window edge here).
    const bool full = !mixed && !a.seg && k0 + BK <= a.Sk && q0 + BQ <= a.S &&
                      (!a.causal || q0 >= k0 + BK - 1) &&
                      (a.window <= 0 ||
                       (q0 + BQ - 1 - k0 < a.window && k0 + BK - 1 - q0 < a.window));
    const bf16* sK = sKV + (2 * buf) * BK * ld;
    const bf16* sV = sK + BK * ld;
    const int32_t* seg_k = sSeg + buf * BK;

    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      if (ks * 16 < hd16) {
        uint32_t qs[4];
        if constexpr (!Q_IN_REGS) load_q(qs, ks);
        const uint32_t* qa = Q_IN_REGS ? qf[Q_IN_REGS ? ks : 0] : qs;
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          // matrices: keys n*8.. x cols ks*16.. / +8, keys (n+1)*8.. likewise
          uint32_t bk[4];
          ldmatrix_x4(bk, sK + ((n + (lane >> 4)) * 8 + (lane & 7)) * ld + ks * 16 +
                              ((lane >> 3) & 1) * 8);
          mma16816(sc[n], qa, bk[0], bk[1]);
          mma16816(sc[n + 1], qa, bk[2], bk[3]);
        }
      }
    }

    // softmax. Each step is its own loop under a CTA-uniform branch, so
    // the per-element work is a multiply, a max and an exp unless the
    // tile needs the softcap or masks.
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] *= a.sm_scale;
    if (a.softcap > 0.f) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = tanhf(sc[n][e] / a.softcap) * a.softcap;
    }
    if (!full) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = q0 + row0 + 8 * (e >> 1);
          const int kr = n * 8 + tg * 2 + (e & 1);
          const int kpos = k0 + kr;
          const int qs = qseg[e >> 1];
          bool allowed = (qpos < a.S) & (kpos < a.Sk) & (qs >= 0) & (seg_k[kr] == qs) &
                         (!a.causal | (qpos >= kpos)) &
                         ((a.window <= 0) |
                          ((qpos - kpos < a.window) & (kpos - qpos < a.window)));
          if (mixed)   // positions clamped: the read stays in bounds
            allowed &= a.bmap[((size_t)b * a.map_nq + min(qpos, a.S - 1) / a.map_bq) *
                                  a.map_nk +
                              min(kpos, a.Sk - 1) / a.map_bk] != 0;
          if (!allowed) sc[n][e] = NEG_INF;
        }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * hh], sc[n][2 * hh + 1]));
      // the 4 threads of a quad hold the rest of the row
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[hh], mx);
      // a row with no visible key yet keeps p = 0: exp(NEG_INF - 0) == 0
      const float m_use = m_new == NEG_INF ? 0.f : m_new;
      // __expf (ex2.approx): P is rounded to bf16 before P.V anyway
      const float alpha = __expf(m_i[hh] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = __expf(sc[n][2 * hh + e] - m_use);
          sc[n][2 * hh + e] = p;
          rs += p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_i[hh] = l_i[hh] * alpha + rs;
      m_i[hh] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * hh] *= alpha;
        acc[n][2 * hh + 1] *= alpha;
      }
    }

    // O += P V: the score accumulators of key tiles 2kk, 2kk+1 are the A
    // fragment of the kk-th 16-key step; V's B fragments come transposed
    // from its row-major tile
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        if (n * 8 < hd16) {
          // matrices: keys kk*16.. / +8 x cols n*8.., then cols (n+1)*8..
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, sV + (kk * 16 + (lane & 15)) * ld + (n + (lane >> 4)) * 8);
          mma16816(acc[n], pa, bv[0], bv[1]);
          mma16816(acc[n + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();   // done reading this buffer before it is refilled
    kt = kt_next;
    mixed = mixed_next;
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int s = q0 + row0 + 8 * hh;
    if (s >= a.S) continue;
    const float denom = fmaxf(l_i[hh], 1e-30f);
    const size_t base = ((size_t)(b * a.S + s) * a.H + h) * a.hd;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + tg * 2 + e;
        if (d < a.hd) o[base + d] = __float2bfloat16(acc[n][2 * hh + e] / denom);
      }
  }
}

// ---------------------------------------------------------------------------
// bf16 path on TMA + wgmma: the main path's kernel.
//
// One CTA per (b*h, BQ = 64 * NWG query rows): NWG consumer warpgroups of
// 64 rows each and one producer warpgroup, whose first thread issues every
// tile copy with TMA into a ring of STAGES K/V tiles guarded by mbarriers
// (full: bytes landed; empty: every consumer done). At S = 256 the ring
// holds the head's four 64-key tiles, so every load is in flight from the
// start. The tensor maps describe q, k, v in their own [B, S, heads, hd]
// layout as dims (hd, heads, S, B), so rows past S are zero-filled by the
// hardware and never read from the next batch.
//
// A head's columns are split into WIDE groups of 64, copied as 128-byte
// rows in TMA's 128-byte swizzle (few, long copies), and TAILN columns
// past them (72 = 64 + 8 on the main path) as 8-column boxes in the
// no-swizzle core-matrix layout, zero past hd (hopper.cuh: layouts). Both
// products run on wgmma with float32 accumulators: S = Q K^T (m64n64k16, A
// and B from shared memory, K-major) and O += P V (P from registers as
// bf16; V MN-major: m64n64k16 per 64-column group, m64nTAILNk16 for the
// tail). The accumulator layout per warp is the m16n8k16 C layout, so the
// per-element masks are those of the mma.sync kernel above. The softmax
// runs in base 2 with sm_scale * log2(e) folded into one multiply.
namespace wg {

constexpr int BKV = 64;        // keys per kv tile
// Registers per thread after setmaxnreg. setmaxnreg moves registers within
// the CTA's own allocation: the producer warpgroup gives back all but 24,
// and the consumer warpgroups share the rest (Cfg::CONSUMER_REGS).
constexpr int PRODUCER_REGS = 24;
constexpr float LOG2E = 1.4426950408889634f;

template <int WIDE, int TAILN, int NWG>
struct Cfg {
  static constexpr int BQ = 64 * NWG;
  // kv tiles in flight: four up to hd 128; two past it, where a 128-row Q
  // tile (64 KB at hd 256) and two K+V stages (64 KB each) fill ~192 KB
  // of the 227 KB a CTA may hold
  static constexpr int STAGES = WIDE * 64 + TAILN > 128 ? 2 : 4;
  static constexpr int TCH = (TAILN + 15) / 16 * 2;         // tail chunks staged (16-deep steps)
  static constexpr int ROW_BYTES = WIDE * 128 + TCH * 16;   // shared bytes per tile row
  static constexpr int NT = 128 * (NWG + 1);                // consumers, then the producer
  static constexpr int Q_BYTES = BQ * ROW_BYTES;
  static constexpr int KV_BYTES = BKV * ROW_BYTES;          // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;   // + alignment slack
  static_assert(SMEM <= 232448, "a CTA holds at most 227 KB of shared memory");
  static constexpr int NO = WIDE * 8 + TAILN / 8;           // n8 tiles of the output
  // CTAs per SM. Two 384-thread CTAs of a head width <= 72 fit an SM (2 x
  // 102 KB of shared memory), so S = 256 runs in one wave of 256 CTAs; the
  // wider heads' accumulators need the registers of one CTA per SM.
  static constexpr int MINB = NWG == 2 && WIDE * 64 + TAILN <= 72 ? 2 : 1;
  // ptxas starts every thread at the launch bound's share (at most 240):
  // 168 at one 384-thread CTA per SM, 80 at two. The consumers take what
  // the producer gives back: 240 (FlashAttention-3's split) or 104. At
  // hd 256 the O accumulator alone is 128 of a consumer's 240.
  static constexpr int ENTRY_REGS =
      (65536 / (MINB * NT)) / 8 * 8 > 240 ? 240 : (65536 / (MINB * NT)) / 8 * 8;
  static constexpr int CONSUMER_REGS_POOL =
      (ENTRY_REGS * NT - PRODUCER_REGS * 128) / (128 * NWG) / 8 * 8;
  static constexpr int CONSUMER_REGS = CONSUMER_REGS_POOL > 240 ? 240 : CONSUMER_REGS_POOL;
};

// Tensor maps: 64-column boxes in the 128-byte swizzle (w) and 8-column
// boxes with no swizzle (t), over q, k and v.
struct Maps {
  CUtensorMap qw, qt, kw, kt, vw, vt;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int WIDE, int TAILN, int NWG>
__global__ void __launch_bounds__(Cfg<WIDE, TAILN, NWG>::NT, Cfg<WIDE, TAILN, NWG>::MINB)
    flash_fwd_wgmma_kernel(const __grid_constant__ Maps maps, const Args a) {
  using C = Cfg<WIDE, TAILN, NWG>;
  constexpr int NS = BKV / 8;   // n8 tiles of the score tile
  constexpr int NO = C::NO;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows
  unsigned char* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = base;                   // [WIDE][BQ][128 swizzled], [TCH][BQ][16]
  unsigned char* sKV = base + C::Q_BYTES;     // stage st: K then V, each laid out as sQ
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::BAR_OFF);
  uint64_t* empty = full + C::STAGES;
  uint64_t* qbar = empty + C::STAGES;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int kh = h / (a.H / a.K);
  const int q0 = blockIdx.y * C::BQ;
  const int q_hi = min(q0 + C::BQ, a.S) - 1;
  const int nkt = (a.Sk + BKV - 1) / BKV;
  // tail chunks copied; [tload, TCH) stay zero. Past hd 128 the four
  // 64-column groups take any hd <= 256: TMA zero-fills a box's columns
  // past hd, and a zero column adds nothing to either product
  const int tload = max(0, (a.hd - 64 * WIDE) / 8);

  // Zero the tail's pad chunks once (TMA never writes them), then publish
  // them to the async proxy that wgmma reads through.
  for (int e = tid; e < (C::TCH - tload) * C::BQ; e += C::NT)
    reinterpret_cast<uint4*>(sQ + WIDE * C::BQ * 128 + tload * C::BQ * 16)[e] =
        make_uint4(0, 0, 0, 0);
  for (int e = tid; e < 2 * C::STAGES * (C::TCH - tload) * BKV; e += C::NT) {
    const int tile = e / ((C::TCH - tload) * BKV), r = e % ((C::TCH - tload) * BKV);
    reinterpret_cast<uint4*>(sKV + tile * C::KV_BYTES + WIDE * BKV * 128 + tload * BKV * 16)[r] =
        make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < C::STAGES; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], NWG * 128);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (tid >= NWG * 128) {
    // ---- producer warpgroup: one thread issues the TMA copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == NWG * 128) {
      // one tile of `rows` rows from `row0` of head `head`
      auto copy_tile = [&](unsigned char* dst, const CUtensorMap* mw, const CUtensorMap* mt,
                           uint64_t* bar, int rows, int head, int row0) {
        for (int g = 0; g < WIDE; ++g)
          hopper::tma_load_4d(dst + g * rows * 128, mw, bar, 64 * g, head, row0, b);
        for (int c = 0; c < tload; ++c)
          hopper::tma_load_4d(dst + WIDE * rows * 128 + c * rows * 16, mt, bar,
                              64 * WIDE + 8 * c, head, row0, b);
      };
      const int row_bytes = WIDE * 128 + tload * 16;   // bytes a tile row's copies bring
      hopper::mbar_expect_tx(qbar, C::BQ * row_bytes);
      copy_tile(sQ, &maps.qw, &maps.qt, qbar, C::BQ, h, q0);
      bool mixed;
      int i = 0;
      for (int kt = next_tile(a, 0, nkt, b, q0, q_hi, &mixed); kt < nkt;
           kt = next_tile(a, kt + 1, nkt, b, q0, q_hi, &mixed), ++i) {
        const int st = i % C::STAGES;
        if (i >= C::STAGES) hopper::mbar_wait(&empty[st], ((i / C::STAGES) - 1) & 1);
        unsigned char* sK = sKV + st * 2 * C::KV_BYTES;
        hopper::mbar_expect_tx(&full[st], 2 * BKV * row_bytes);
        copy_tile(sK, &maps.kw, &maps.kt, &full[st], BKV, kh, kt * BKV);
        copy_tile(sK + C::KV_BYTES, &maps.vw, &maps.vt, &full[st], BKV, kh, kt * BKV);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
    const int wgi = tid / 128;
    const int lane = tid % 32;
    const int g = lane >> 2, tg = lane & 3;
    const int row0 = wgi * 64 + ((tid % 128) / 32) * 16 + g;   // rows row0, row0 + 8
    const unsigned char* sQw = sQ + wgi * 64 * 128;                      // this warpgroup's rows
    const unsigned char* sQt = sQ + WIDE * C::BQ * 128 + wgi * 64 * 16;

    int qseg[2];
    float m_i[2], l_i[2], acc[NO * 4], sc[NS * 4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s = q0 + row0 + 8 * hh;
      qseg[hh] = s < a.S ? (a.seg ? a.seg[(size_t)b * a.S + s] : 0) : -1;
      m_i[hh] = NEG_INF;
      l_i[hh] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NO * 4; ++n) acc[n] = 0.f;
    const float scale2 = a.sm_scale * LOG2E;

    hopper::mbar_wait(qbar, 0);
    bool mixed;
    int i = 0;
    for (int kt = next_tile(a, 0, nkt, b, q0, q_hi, &mixed); kt < nkt; ++i) {
      bool mixed_next;
      const int kt_next = next_tile(a, kt + 1, nkt, b, q0, q_hi, &mixed_next);
      const int st = i % C::STAGES;
      const unsigned char* sK = sKV + st * 2 * C::KV_BYTES;
      const unsigned char* sV = sK + C::KV_BYTES;
      const int k0 = kt * BKV;
      // every (q, k) pair of the tile visible: no per-element masks
      const bool full_tile = !mixed && !a.seg && k0 + BKV <= a.Sk && q0 + C::BQ <= a.S &&
                             (!a.causal || q0 >= k0 + BKV - 1) &&
                             (a.window <= 0 || (q0 + C::BQ - 1 - k0 < a.window &&
                                                k0 + BKV - 1 - q0 < a.window));
      hopper::mbar_wait(&full[st], (i / C::STAGES) & 1);

      // S = Q K^T: 16-column steps over the swizzled groups, then the tail
      hopper::wgmma_fence();
#pragma unroll
      for (int gw = 0; gw < WIDE; ++gw)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::Wgmma<64>::template ss<0>(
              sc, hopper::desc_sw128(sQw + gw * C::BQ * 128 + kk * 32),
              hopper::desc_sw128(sK + gw * BKV * 128 + kk * 32), gw + kk > 0);
#pragma unroll
      for (int ks = 0; ks < C::TCH / 2; ++ks)
        hopper::Wgmma<64>::template ss<0>(
            sc, hopper::desc(sQt + 2 * ks * C::BQ * 16, C::BQ * 16, 128),
            hopper::desc(sK + WIDE * BKV * 128 + 2 * ks * BKV * 16, BKV * 16, 128),
            WIDE + ks > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
      hopper::fence_regs<NS * 4>(sc);

      // softmax in base 2: log2(e) folded into the scale
      if (a.softcap > 0.f) {
        const float inv = a.sm_scale / a.softcap, out = a.softcap * LOG2E;
#pragma unroll
        for (int e = 0; e < NS * 4; ++e) sc[e] = tanhf(sc[e] * inv) * out;
      } else {
#pragma unroll
        for (int e = 0; e < NS * 4; ++e) sc[e] *= scale2;
      }
      if (!full_tile) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = q0 + row0 + 8 * (e >> 1);
            const int kpos = k0 + n * 8 + tg * 2 + (e & 1);
            const int qs = qseg[e >> 1];
            const int ks_id =
                kpos < a.Sk ? (a.seg ? __ldg(a.seg + (size_t)b * a.Sk + kpos) : 0) : -1;
            bool allowed = (qpos < a.S) & (qs >= 0) & (ks_id == qs) &
                           (!a.causal | (qpos >= kpos)) &
                           ((a.window <= 0) |
                            ((qpos - kpos < a.window) & (kpos - qpos < a.window)));
            if (mixed)   // positions clamped: the read stays in bounds
              allowed &= a.bmap[((size_t)b * a.map_nq + min(qpos, a.S - 1) / a.map_bq) *
                                    a.map_nk +
                                min(kpos, a.Sk - 1) / a.map_bk] != 0;
            if (!allowed) sc[4 * n + e] = NEG_INF;
          }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = NEG_INF;
#pragma unroll
        for (int n = 0; n < NS; ++n)
          mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * hh], sc[4 * n + 2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_i[hh], mx);
        // a row with no visible key yet keeps p = 0: 2^(NEG_INF - 0) == 0
        const float m_use = m_new == NEG_INF ? 0.f : m_new;
        const float alpha = ex2(m_i[hh] - m_use);
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(sc[4 * n + 2 * hh + e] - m_use);
            sc[4 * n + 2 * hh + e] = p;
            rs += p;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l_i[hh] = l_i[hh] * alpha + rs;
        m_i[hh] = m_new;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[4 * n + 2 * hh] *= alpha;
          acc[4 * n + 2 * hh + 1] *= alpha;
        }
      }

      // O += P V: the score accumulators of n8 tiles 2kk, 2kk + 1, rounded
      // to bf16, are the A fragment of the kk-th 16-key step
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      hopper::fence_regs<NO * 4>(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
        for (int gw = 0; gw < WIDE; ++gw)
          hopper::Wgmma<64>::template rs<1>(
              acc + 32 * gw, pa[kk], hopper::desc_sw128(sV + gw * BKV * 128 + kk * 16 * 128), 1);
        if constexpr (TAILN > 0)
          hopper::Wgmma<TAILN>::template rs<1>(
              acc + 32 * WIDE, pa[kk],
              hopper::desc(sV + WIDE * BKV * 128 + kk * 16 * 16, 128, BKV * 16), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
      hopper::fence_regs<NO * 4>(acc);
      hopper::mbar_arrive(&empty[st]);
      kt = kt_next;
      mixed = mixed_next;
    }

    bf16* o = static_cast<bf16*>(a.o);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s = q0 + row0 + 8 * hh;
      if (s >= a.S) continue;
      const float inv = 1.f / fmaxf(l_i[hh], 1e-30f);
      bf16* row = o + ((size_t)(b * a.S + s) * a.H + h) * a.hd;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int d = n * 8 + tg * 2;
        if (d < a.hd)
          *reinterpret_cast<__nv_bfloat162*>(row + d) =
              __floats2bfloat162_rn(acc[4 * n + 2 * hh] * inv, acc[4 * n + 2 * hh + 1] * inv);
      }
    }
  }
}

// A tensor map over q [B, S, H, hd] or k, v [B, Sk, K, hd] as dims (hd,
// heads, S, B), boxes of `cols` columns x `rows` rows of one head.
cudaError_t qkv_map(CUtensorMap* m, const void* p, int B, int S, int heads, int hd, int cols,
                    int rows, bool swizzle128) {
  const uint64_t dims[4] = {(uint64_t)hd, (uint64_t)heads, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)hd * 2, (uint64_t)heads * hd * 2,
                               (uint64_t)S * heads * hd * 2};
  const uint32_t box[4] = {(uint32_t)cols, 1, (uint32_t)rows, 1};
  return hopper::bf16_map(m, p, 4, dims, strides, box, swizzle128);
}

template <int WIDE, int TAILN, int NWG>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<WIDE, TAILN, NWG>;
  auto kernel = flash_fwd_wgmma_kernel<WIDE, TAILN, NWG>;
  static cudaError_t configured = cudaErrorNotReady;
  if (configured == cudaErrorNotReady) {
    configured = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      C::SMEM);
    // the consumers' setmaxnreg.inc waits until the CTA's pool holds their
    // registers: if ptxas gave the kernel fewer at entry than that needs,
    // it would wait forever, so refuse the launch instead
    cudaFuncAttributes fa;
    if (configured == cudaSuccess) configured = cudaFuncGetAttributes(&fa, kernel);
    if (configured == cudaSuccess &&
        fa.numRegs * C::NT < 128 * (PRODUCER_REGS + C::CONSUMER_REGS * NWG))
      configured = cudaErrorInvalidConfiguration;
  }
  if (configured != cudaSuccess) return configured;
  Maps m = {};   // maps a call does not read stay zero
  cudaError_t err = cudaSuccess;
  const void* ptr[3] = {a.q, a.k, a.v};
  CUtensorMap* wide[3] = {&m.qw, &m.kw, &m.vw};
  CUtensorMap* tail[3] = {&m.qt, &m.kt, &m.vt};
  for (int t = 0; t < 3 && err == cudaSuccess; ++t) {
    const int S = t ? a.Sk : a.S, heads = t ? a.K : a.H, rows = t ? BKV : C::BQ;
    if (WIDE > 0) err = qkv_map(wide[t], ptr[t], a.B, S, heads, a.hd, 64, rows, true);
    if (err == cudaSuccess && a.hd > 64 * WIDE)
      err = qkv_map(tail[t], ptr[t], a.B, S, heads, a.hd, 8, rows, false);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + C::BQ - 1) / C::BQ);
  kernel<<<grid, C::NT, C::SMEM, stream>>>(m, a);
  return cudaGetLastError();
}

// hd (a multiple of 8, <= 256) as 64-column groups and a tail: 72 = 64 + 8
// on the DiT path; 64 and 128 have no tail, hd <= 56 is all tail; past 128
// four groups (256 on the language models' path), with 128-row CTAs only.
template <int NWG>
cudaError_t launch_hd(const Args& a, cudaStream_t stream) {
  if (a.hd > 128) return launch<4, 0, 2>(a, stream);
  if (a.hd <= 56) return launch<0, 64, NWG>(a, stream);
  if (a.hd == 64) return launch<1, 0, NWG>(a, stream);
  if (a.hd == 72) return launch<1, 8, NWG>(a, stream);
  if (a.hd <= 96) return launch<1, 32, NWG>(a, stream);
  if (a.hd <= 120) return launch<1, 64, NWG>(a, stream);
  return launch<2, 0, NWG>(a, stream);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// Launch

// Raise a kernel's dynamic shared-memory cap once (also keeps the call out
// of CUDA-graph captures after the first launch).
template <typename Kernel>
cudaError_t launch(Kernel kernel, bool& configured, size_t smem_max, size_t smem,
                   const Args& a, cudaStream_t stream) {
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(a.B * a.H, (a.S + BQ - 1) / BQ);
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD_MAX>
cudaError_t launch_hd(const Args& a, bool bf16_in, cudaStream_t stream) {
  static bool configured_f32 = false, configured_bf16 = false;
  if (bf16_in)
    return launch(flash_fwd_mma_kernel<HD_MAX>, configured_bf16,
                  mma_smem_bytes(HD_MAX), mma_smem_bytes(a.hd), a, stream);
  // multiples of 64 columns; hd 256 stages ~212 KB of float32 tiles
  constexpr int F32_MAX = HD_MAX <= 64 ? 64 : HD_MAX <= 128 ? 128 : 256;
  return launch(flash_fwd_kernel<F32_MAX>, configured_f32, smem_bytes(F32_MAX),
                smem_bytes(a.hd), a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. variant: 0 = float32 CUDA-core kernel,
// 1 = bf16 mma.sync kernel, 2 = bf16 TMA / wgmma kernel (hd a multiple of
// 8, 16-byte aligned bases). The caller chooses the variant; a variant
// that does not take the inputs is refused, never replaced. Returns a
// cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, const void* seg, const void* bmap,
                                   int dtype, int B, int S, int Sk, int H, int K,
                                   int hd, int causal, float softcap, int window,
                                   float sm_scale, int map_bq, int map_bk,
                                   int map_nq, int map_nk, int vec, int variant,
                                   void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.seg = static_cast<const int32_t*>(seg);
  a.bmap = static_cast<const int32_t*>(bmap);
  a.B = B;
  a.S = S;
  a.Sk = Sk;
  a.H = H;
  a.K = K;
  a.hd = hd;
  a.causal = causal;
  a.softcap = softcap;
  a.window = window;
  a.sm_scale = sm_scale;
  a.map_bq = map_bq;
  a.map_bk = map_bk;
  a.map_nq = map_nq;
  a.map_nk = map_nk;
  a.vec = vec;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 0 || hd > 256 || variant < 0 || variant > 2 || (variant == 0) != (dtype == 0) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (variant == 2) {
    const bool aligned = hd % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(v) % 16 == 0;
    if (!aligned) return (int)cudaErrorInvalidValue;
    return (int)(S <= 64 ? wg::launch_hd<1>(a, st) : wg::launch_hd<2>(a, st));
  }
  if (hd <= 64) return (int)launch_hd<64>(a, dtype == 1, st);
  if (hd <= 80) return (int)launch_hd<80>(a, dtype == 1, st);
  if (hd <= 128) return (int)launch_hd<128>(a, dtype == 1, st);
  return (int)launch_hd<256>(a, dtype == 1, st);
}
