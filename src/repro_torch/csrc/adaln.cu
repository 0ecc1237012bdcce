// Fused adaLN passes of the packed DiT block for Hopper (sm_90a).
//
// Replace no Pallas kernel: the JAX package leaves the block's LayerNorm,
// modulation and gated residuals to XLA's fusion. In the port's packed
// forward (core/packing.py `_packed_block`, and the final adaLN of
// `packed_mixed_forward`) they were ~31 PyTorch element-wise launches a
// block over a gathered [R, C, 6d] copy of the per-segment adaLN table.
// Per token t of x [T, d], with seg = token_idx[t] and the table's
// columns cut into chunks of d (chunk c of row seg: tab_c):
//   residual:  x'[t] = x[t] + tab_gate * y[t]
//   norm:      h[t]  = LN(x'[t]) * (1 + tab_scale) + tab_shift
// (without a residual, x' = x). LN has no affine, eps 1e-6.
//
// Numbers. The plain chain (kernels/adaln/ref.py, models/dit.py `_ln`)
// rounds to x's dtype at each PyTorch op: LN's result, 1 + scale, the
// product, the sum, gate * y, and x + gate * y. The kernel rounds at the
// same points, each result rounded once (round to nearest even; `Quad`
// says why bf16x2 arithmetic gives PyTorch's float32-then-bf16 results),
// and nothing lets nvcc contract a product into the next add across a
// rounding point (__fmul_rn / __fadd_rn, inline PTX). LN's two row sums
// (the mean of x, then the mean of (x - mean)^2, each element rounded as
// PyTorch's ops round it) are float32 and taken in the order of PyTorch's
// CUDA reduce kernel for a contiguous row of 128 < d (vectorised input, one
// warp a row): lane l folds the 4-element chunks l, l + 32, ... into four
// running sums, one a position in the chunk, adds them ((s0 + s1) + s2) +
// s3, and the warp adds lanes by shfl_down at offsets 16, 8, .., 1; the sum
// times n / (n d) is the mean (torch 2.11: every output of a DiT-XL/2 norm
// at T 8,192 equals the chain's bit for bit, where the same sums with the
// offsets rising left 2e-6 of them one rounding apart). So where a warp
// holds a row of 128 < d (d <= 1,536 in bf16, 1,024 in float32) LN equals
// `_ln` bit for bit, and the outputs equal the chain's. At other widths
// only the order of the row sums differs. In float32 nothing is rounded
// beyond float32.
//
// What bounds it on the H100. The work is a few operations a byte: at
// DiT-XL/2's served layout (T = 8,192, d = 1,152, bf16) a norm moves 37.7
// MB (x in, h out: 11.3 us at 3.35 TB/s), a residual plus norm 75.5 MB
// (22.5 us), a residual 56.6 MB (16.9 us). Bytes bound it, so the design
// reads each input once and writes each output once:
//   * One row group (a warp; up to 8 warps for wider rows) holds a token's
//     row in registers, at most 12 chunks of 4 elements a thread in bf16
//     (8 in float32: wider counts spill, and each count is one more kernel
//     for nvcc to build); LN's
//     sums come from the registers, reduced by warp shuffles (and shared
//     memory across the warps of a wider row group).
//   * The table is read where it lies, never gathered: a row group walks a
//     run of consecutive tokens and reloads its columns of the segment's
//     shift, 1 + scale and gate only when token_idx changes. Segments are
//     runs of 64 or 256 tokens, so that is once or twice a run, and the
//     row groups of a CTA, on neighbouring tokens, meet the same table
//     lines in L1.
//   * A row group issues the next token's loads before it normalises the
//     current one (after the residual, whose y registers they reuse), so
//     each warp keeps a token's bytes in flight while its arithmetic runs;
//     that arithmetic is packed bf16x2 where the chain rounds to bf16.
//   * The runs are sized so that about 16 warps an SM are in flight
//     (kernels/adaln/adaln.py `launch_plan`), at the engine's smallest
//     layout (256 tokens) one token a warp over ~128 CTAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace adaln {

constexpr int MAX_D = 8192;
constexpr int CTA_THREADS = 256;

// Arithmetic on a chunk of 4 elements (float32: 16 bytes; bf16: 8 bytes),
// rounded where the plain chain rounds. bf16: the products and sums of bf16
// values by mul.rn / add.rn.bf16x2, which round the exact result once, as
// PyTorch's float32 op rounded to bf16 does (a product of two bf16 values
// is exact in float32; a sum is exact there too unless the exponents
// differ by more than 16, and then both give the larger operand); inline
// PTX, so nvcc cannot fuse a product and a sum into one rounding.
template <typename T>
struct Quad;

template <>
struct Quad<float> {
  using V = uint4;
  static constexpr int MAX_CHUNKS = 8;   // 4-element chunks a thread holds of a row
  static __device__ __forceinline__ float at(const V& v, int i) {
    return __uint_as_float(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w);
  }
  static __device__ __forceinline__ uint32_t res1(float x, float g, float y) {
    return __float_as_uint(__fadd_rn(x, __fmul_rn(g, y)));
  }
  static __device__ __forceinline__ uint32_t mod1(float x, float mu, float r, float s1,
                                                  float sh) {
    return __float_as_uint(__fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), r), s1), sh));
  }
  // x + g * y
  static __device__ __forceinline__ V residual(const V& x, const V& g, const V& y) {
    return make_uint4(res1(at(x, 0), at(g, 0), at(y, 0)), res1(at(x, 1), at(g, 1), at(y, 1)),
                      res1(at(x, 2), at(g, 2), at(y, 2)), res1(at(x, 3), at(g, 3), at(y, 3)));
  }
  static __device__ __forceinline__ V one_plus(const V& v) {
    return make_uint4(__float_as_uint(__fadd_rn(1.0f, at(v, 0))),
                      __float_as_uint(__fadd_rn(1.0f, at(v, 1))),
                      __float_as_uint(__fadd_rn(1.0f, at(v, 2))),
                      __float_as_uint(__fadd_rn(1.0f, at(v, 3))));
  }
  // LN (x - mu) * r, then * s1 + sh
  static __device__ __forceinline__ V modulate(const V& x, float mu, float r, const V& s1,
                                               const V& sh) {
    return make_uint4(mod1(at(x, 0), mu, r, at(s1, 0), at(sh, 0)),
                      mod1(at(x, 1), mu, r, at(s1, 1), at(sh, 1)),
                      mod1(at(x, 2), mu, r, at(s1, 2), at(sh, 2)),
                      mod1(at(x, 3), mu, r, at(s1, 3), at(sh, 3)));
  }
};

__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

template <>
struct Quad<__nv_bfloat16> {
  using V = uint2;
  static constexpr int MAX_CHUNKS = 12;
  // element 2i is the low half of word i (little-endian)
  static __device__ __forceinline__ float at(const V& v, int i) {
    const uint32_t w = i < 2 ? v.x : v.y;
    return __uint_as_float(i % 2 ? w & 0xffff0000u : w << 16);
  }
  static __device__ __forceinline__ V residual(const V& x, const V& g, const V& y) {
    return make_uint2(bf2_add(x.x, bf2_mul(g.x, y.x)), bf2_add(x.y, bf2_mul(g.y, y.y)));
  }
  static __device__ __forceinline__ V one_plus(const V& v) {
    constexpr uint32_t one = 0x3f803f80u;  // (1, 1)
    return make_uint2(bf2_add(one, v.x), bf2_add(one, v.y));
  }
  static __device__ __forceinline__ uint32_t modulate2(uint32_t x, float mu, float r,
                                                       uint32_t s1, uint32_t sh) {
    const float lo = __uint_as_float(x << 16), hi = __uint_as_float(x & 0xffff0000u);
    __nv_bfloat162 ln = __floats2bfloat162_rn(__fmul_rn(__fsub_rn(lo, mu), r),
                                              __fmul_rn(__fsub_rn(hi, mu), r));
    return bf2_add(bf2_mul(*reinterpret_cast<uint32_t*>(&ln), s1), sh);
  }
  static __device__ __forceinline__ V modulate(const V& x, float mu, float r, const V& s1,
                                               const V& sh) {
    return make_uint2(modulate2(x.x, mu, r, s1.x, sh.x), modulate2(x.y, mu, r, s1.y, sh.y));
  }
};

struct Args {
  const void* x;
  const void* y;             // null: no residual
  const void* table;
  const long long* token_idx;   // int64
  void* x_out;               // null: no residual
  void* h_out;               // null: no norm
  int n_tok, rows;           // tokens, table rows
  int nch;                   // 4-element chunks a row
  int ldc;                   // table row length in chunks
  int gate, shift, scale;    // column offsets in chunks
  int row_threads, tok_per_group;
  float factor;              // PyTorch's mean: n_tok / (n_tok * d) in float32
};

// The sum of a thread's partial over the row group, in PyTorch's reduce
// order: the warp adds lanes by shfl_down at offsets 16, 8, .., 1 (lane 0
// holds the sum); a wider row group (the whole CTA) adds its warps' sums in
// warp order through shared memory. Every thread gets the result.
__device__ __forceinline__ float row_sum(float v, int row_threads, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  v = __shfl_sync(0xffffffffu, v, 0);
  if (row_threads > 32) {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
    __syncthreads();
    v = red[0];
    for (int i = 1; i < row_threads / 32; ++i) v = __fadd_rn(v, red[i]);
    __syncthreads();
  }
  return v;
}

// Issue the loads of token t's x (and y) chunks and its segment index.
template <typename V, int NC, bool RES>
__device__ __forceinline__ void load_token(const Args& a, int t, int lane, V* xv, V* yv,
                                           long long& seg) {
  seg = __ldg(a.token_idx + t);
  const size_t base = static_cast<size_t>(t) * a.nch;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane + k * a.row_threads;
    if (c < a.nch) {
      xv[k] = __ldg(static_cast<const V*>(a.x) + base + c);
      if (RES) yv[k] = __ldg(static_cast<const V*>(a.y) + base + c);
    }
  }
}

// LN's row sum of f(element) in PyTorch's order: four running sums over the
// thread's chunks, one a position in the chunk, added ((s0 + s1) + s2) +
// s3, then `row_sum`.
template <typename T, int NC, typename F>
__device__ __forceinline__ float ln_sum(const typename Quad<T>::V* xv, int lane, int nch,
                                        int row_threads, float* red, F f) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (lane + k * row_threads >= nch) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = __fadd_rn(s[i], f(Quad<T>::at(xv[k], i)));
  }
  return row_sum(__fadd_rn(__fadd_rn(__fadd_rn(s[0], s[1]), s[2]), s[3]), row_threads, red);
}

template <typename T, int NC, bool RES, bool NORM>
__global__ void __launch_bounds__(CTA_THREADS) adaln_kernel(const Args a) {
  using Q = Quad<T>;
  using V = typename Q::V;
  __shared__ float red[CTA_THREADS / 32];
  const int lane = threadIdx.x % a.row_threads;
  const int group = blockIdx.x * (blockDim.x / a.row_threads) + threadIdx.x / a.row_threads;
  const int t0 = group * a.tok_per_group;
  const int t1 = min(t0 + a.tok_per_group, a.n_tok);
  const V* table = static_cast<const V*>(a.table);
  V sh[NC], s1[NC], gt[NC];          // this segment's columns: shift, 1 + scale, gate
  V xv[NC], yv[NC];                  // this token's row (and y)
  long long cur = -1, seg = 0;
  if (t0 < t1) load_token<V, NC, RES>(a, t0, lane, xv, yv, seg);
  for (int t = t0; t < t1; ++t) {
    if (seg != cur) {                // uniform over the row group
      if (seg < 0 || seg >= a.rows) __trap();
      cur = seg;
      const V* row = table + seg * a.ldc;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = lane + k * a.row_threads;
        if (c >= a.nch) continue;
        if (RES) gt[k] = __ldg(row + a.gate + c);
        if (NORM) {
          sh[k] = __ldg(row + a.shift + c);
          s1[k] = Q::one_plus(__ldg(row + a.scale + c));
        }
      }
    }
    const size_t base = static_cast<size_t>(t) * a.nch;
    if (RES) {                       // y is dead after this: its registers take the next token's
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = lane + k * a.row_threads;
        if (c >= a.nch) continue;
        xv[k] = Q::residual(xv[k], gt[k], yv[k]);
        static_cast<V*>(a.x_out)[base + c] = xv[k];
      }
    }
    // the next token's loads fly while this one is normalised
    V xn[NC];
    long long seg_n = 0;
    if (t + 1 < t1) load_token<V, NC, RES>(a, t + 1, lane, xn, yv, seg_n);
    if (NORM) {
      const float mu = __fmul_rn(
          ln_sum<T, NC>(xv, lane, a.nch, a.row_threads, red, [](float e) { return e; }),
          a.factor);
      const float var = __fmul_rn(ln_sum<T, NC>(xv, lane, a.nch, a.row_threads, red,
                                                [mu](float e) {
                                                  const float dl = __fsub_rn(e, mu);
                                                  return __fmul_rn(dl, dl);
                                                }),
                                  a.factor);
      const float r = rsqrtf(__fadd_rn(var, 1e-6f));
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = lane + k * a.row_threads;
        if (c >= a.nch) continue;
        static_cast<V*>(a.h_out)[base + c] = Q::modulate(xv[k], mu, r, s1[k], sh[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) xv[k] = xn[k];
    seg = seg_n;
  }
}

template <typename T, bool RES, bool NORM, int NC = 1>
cudaError_t launch(const Args& a, int chunks, int grid, int block, cudaStream_t s) {
  if constexpr (NC > Quad<T>::MAX_CHUNKS) {
    return cudaErrorInvalidValue;
  } else {
    if (chunks != NC) return launch<T, RES, NORM, NC + 1>(a, chunks, grid, block, s);
    adaln_kernel<T, NC, RES, NORM><<<grid, block, 0, s>>>(a);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch_kind(const Args& a, int chunks, int grid, int block, cudaStream_t s) {
  if (a.y && a.h_out) return launch<T, true, true>(a, chunks, grid, block, s);
  if (a.y) return launch<T, true, false>(a, chunks, grid, block, s);
  return launch<T, false, true>(a, chunks, grid, block, s);
}

}  // namespace adaln

// x, y, x_out, h_out: [n_tok, d] contiguous in the dtype (0 = float32, 1 =
// bfloat16); table: [rows, ld] contiguous in the dtype; token_idx: [n_tok]
// int64 in [0, rows). y and x_out (the residual), and h_out (the norm) may be
// null, not both. *_col: the column chunk of d (-1 where unused). The launch
// plan (row_threads threads a token's row, chunks 4-element chunks each,
// groups_per_cta row groups a CTA, tok_per_group consecutive tokens a row
// group, grid CTAs) comes from kernels/adaln/adaln.py `launch_plan`.
// Returns a cudaError_t (0 = launched).
extern "C" int adaln_fwd(const void* x, const void* y, const void* table,
                         const void* token_idx, void* x_out, void* h_out, int dtype, int n_tok,
                         int d, int ld, int rows, int gate_col, int shift_col, int scale_col,
                         int row_threads, int chunks, int groups_per_cta, int tok_per_group,
                         int grid, void* stream) {
  using namespace adaln;
  const bool res = y != nullptr, norm = h_out != nullptr;
  auto aligned = [](const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  auto col_ok = [&](int c, bool used) { return used ? c >= 0 && (c + 1) * d <= ld : true; };
  const int nch = d / 4;
  if ((dtype != 0 && dtype != 1) || (!res && !norm) || res != (x_out != nullptr) ||
      d <= 0 || d > MAX_D || d % 8 || ld % 8 || rows <= 0 || n_tok <= 0 ||
      !col_ok(gate_col, res) || !col_ok(shift_col, norm) || !col_ok(scale_col, norm) ||
      (row_threads != 32 && row_threads != 64 && row_threads != 128 && row_threads != 256) ||
      chunks < 1 || (nch + row_threads - 1) / row_threads != chunks ||
      groups_per_cta < 1 || groups_per_cta * row_threads > CTA_THREADS ||
      (row_threads > 32 && groups_per_cta != 1) || tok_per_group < 1 || grid < 1 ||
      static_cast<long long>(grid) * groups_per_cta * tok_per_group < n_tok ||
      !aligned(x) || !aligned(y) || !aligned(table) || !aligned(x_out) || !aligned(h_out))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.y = y;
  a.table = table;
  a.token_idx = static_cast<const long long*>(token_idx);
  a.x_out = x_out;
  a.h_out = h_out;
  a.n_tok = n_tok;
  a.rows = rows;
  a.nch = nch;
  a.ldc = ld / 4;
  a.gate = res ? gate_col * d / 4 : 0;
  a.shift = norm ? shift_col * d / 4 : 0;
  a.scale = norm ? scale_col * d / 4 : 0;
  a.row_threads = row_threads;
  a.tok_per_group = tok_per_group;
  // as PyTorch's mean_kernel_impl: outputs over elements, in float32
  a.factor = static_cast<float>(n_tok) / static_cast<float>(static_cast<long long>(n_tok) * d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int block = groups_per_cta * row_threads;
  cudaError_t err = dtype == 1 ? launch_kind<__nv_bfloat16>(a, chunks, grid, block, s)
                               : launch_kind<float>(a, chunks, grid, block, s);
  return (int)err;
}
