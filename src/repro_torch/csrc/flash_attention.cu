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
// function is memory-bound. bf16 inputs take the tensor cores (mma.sync
// m16n8k16, float32 accumulation); float32 inputs take the CUDA cores in
// float32, so that they keep float32 accuracy (and stay the simple,
// unpipelined path). TMA / wgmma with a producer warp are the later step
// toward the byte bound.
//
// Design, rethought for the card rather than carried over from the TPU:
//   * One CTA of 4 warps per (b*h, 64-row query tile); the TPU's sequential
//     kv grid axis becomes a loop over 64-key tiles inside the CTA, with the
//     running max / normaliser / accumulator in registers (online softmax in
//     float32).
//   * q, k, v are read in their [B, S, H, hd] layout with their own strides,
//     so the wrapper makes no transposed or padded copy. Ragged tails (S, Sk
//     not multiples of the tile) are masked here.
//   * A kv tile is skipped before any load when the causal / window
//     envelope or the caller's block map rules it out. When the kernel's
//     tile straddles map entries that disagree, the map is applied per
//     element, so any map granularity gives the reference's answer.
//   * bf16 path: tiles are copied to shared memory as bf16 with cp.async
//     (no registers, zero-fill past the tails), hd zero-padded to a
//     multiple of 16 (72 -> 80); K/V tiles are double-buffered so the next
//     visited tile's copies fly while the current one is computed. A row
//     pitch of hd16 + 8 halves keeps every ldmatrix on distinct banks.
//     Each warp owns 16 query rows: the Q fragments stay in registers for
//     the whole kv loop, K and V fragments come from ldmatrix (V
//     transposed on the fly), and the score accumulators are re-packed in
//     registers as the A operand of P.V (P rounded to bf16, as the TPU
//     kernel rounds it to v's dtype). Instantiated for hd <= 64, 80, 128.
//   * float32 path: tiles staged as float32 at a pitch of round4(hd) + 4;
//     each thread keeps an 8-row x 4-key score tile and an 8-row x
//     4-column-chunk output tile in registers and reads shared memory 16
//     bytes at a time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// Plain C interface, bound with ctypes by kernels/attention/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

    for (int j = 0; j < BK; j += 4) {
      float4 vv[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int ch = cg + CG * c;
          vv[jj][c] = ch < n_chunks
                          ? *reinterpret_cast<const float4*>(&sV[(j + jj) * ld + 4 * ch])
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(&sP[(rg * ROWS + i) * PP + j]);
        const float pj[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc[i][c].x = fmaf(pj[jj], vv[jj][c].x, acc[i][c].x);
            acc[i][c].y = fmaf(pj[jj], vv[jj][c].y, acc[i][c].y);
            acc[i][c].z = fmaf(pj[jj], vv[jj][c].z, acc[i][c].z);
            acc[i][c].w = fmaf(pj[jj], vv[jj][c].w, acc[i][c].w);
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

  uint32_t qf[NKS][4];
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    if (ks * 16 < hd16) {
      const bf16* p0 = sQ + row0 * ld + ks * 16 + tg * 2;
      qf[ks][0] = lds32(p0);
      qf[ks][1] = lds32(p0 + 8 * ld);
      qf[ks][2] = lds32(p0 + 8);
      qf[ks][3] = lds32(p0 + 8 * ld + 8);
    }
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
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          // matrices: keys n*8.. x cols ks*16.. / +8, keys (n+1)*8.. likewise
          uint32_t bk[4];
          ldmatrix_x4(bk, sK + ((n + (lane >> 4)) * 8 + (lane & 7)) * ld + ks * 16 +
                              ((lane >> 3) & 1) * 8);
          mma16816(sc[n], qf[ks], bk[0], bk[1]);
          mma16816(sc[n + 1], qf[ks], bk[2], bk[3]);
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
  constexpr int F32_MAX = HD_MAX <= 64 ? 64 : 128;   // multiples of 64 columns
  return launch(flash_fwd_kernel<F32_MAX>, configured_f32, smem_bytes(F32_MAX),
                smem_bytes(a.hd), a, stream);
}

}  // namespace

extern "C" int flash_attention_max_head_dim() { return 128; }

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, const void* seg, const void* bmap,
                                   int dtype, int B, int S, int Sk, int H, int K,
                                   int hd, int causal, float softcap, int window,
                                   float sm_scale, int map_bq, int map_bk,
                                   int map_nq, int map_nk, int vec, void* stream) {
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
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (hd <= 64) return (int)launch_hd<64>(a, dtype == 1, st);
  if (hd <= 80) return (int)launch_hd<80>(a, dtype == 1, st);
  if (hd <= 128) return (int)launch_hd<128>(a, dtype == 1, st);
  return (int)cudaErrorInvalidValue;
}
