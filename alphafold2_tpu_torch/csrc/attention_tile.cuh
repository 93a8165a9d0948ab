// Shared online-softmax attention tile for the Hopper kernels of this package.
//
// One thread block owns a 64-row query tile of one (batch, head) and one
// output feature chunk of width FC. It streams 64-key tiles: logits are
// accumulated in registers over feature chunks of width FC (one chunk when
// the head dim fits, as in fused_attention.cu; R*D / 64 chunks for the tied
// MSA rows, as in tied_row_attention.cu), masked, folded into a running
// (max, sum) per query row, and the probabilities multiply the value tile
// of the block's output chunk. Nothing quadratic reaches device memory.
//
// Masking contract (shared with the plain PyTorch versions in
// ops/cuda/axial.py and ops/cuda/tied_row.py): a key that is masked or past
// the key count is excluded exactly (probability 0); a query row with no
// valid key and a masked query row both produce 0.
//
// With `lse` set (the training forward) the block of output chunk 0 also
// writes each query row's logsumexp of its scaled logits, m + log(l), which
// the backward (fused_attention_bwd.cu) uses to recompute probabilities as
// exp(s - lse). A row with no valid key writes +inf, so its recomputed
// probabilities are exactly 0 and never exp(s - (-inf)).
//
// Element (b, h, n, f) of an operand lives at
//     b*sb + h*sh + n*sn + (f / fd)*sr + f % fd
// so one kernel reads the (B, H, N, D) layout of fused attention and the
// (B, R, N, H, D) layout of tied-row attention (feature f = r*D + d)
// without any relayout copy.
//
// Two arithmetic paths share that schedule. float32 operands multiply on the
// CUDA cores in f32 (attention_kernel: tiles converted to f32 in shared
// memory), so they match the f32 plain versions to rounding. bfloat16
// operands multiply on the tensor cores (attention_kernel_mma: mma.sync
// m16n8k16, f32 accumulation, probabilities rounded to bf16 for P @ V as
// the TPU kernel did). wgmma, TMA and cp.async pipelining are later work.

#pragma once

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "launch_plan.cuh"

namespace af2 {

constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // keys per streamed tile
constexpr int kThreads = 128; // 4 warps

struct Operand {
  long long sb, sh, sn, sr;  // element strides of batch, head, token, row group
};

struct Problem {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const unsigned char* q_mask;   // (batch, nq) 0/1, or null
  const unsigned char* kv_mask;  // (batch, nk) 0/1, or null
  const float* tie_scale;        // (batch,) extra logit scale, or null
  float* lse = nullptr;          // (batch, heads, nq) f32 row logsumexp out, or null
  Operand qs, ks, vs, os;
  int batch, heads, nq, nk;
  int features;    // F: contraction width of the logits and width of the output
  int fd;          // features per row group (F itself for plain attention)
  int out_chunks;  // ceil(F / FC): one block per output chunk
  float sm_scale;
};

__device__ __forceinline__ long long offset(const Operand& op, int b, int h, int n, int f, int fd) {
  return (long long)b * op.sb + (long long)h * op.sh + (long long)n * op.sn +
         (long long)(f / fd) * op.sr + (f % fd);
}

// Copy a 64 x FC f32 tile (tokens n0.., features f0..) into shared memory,
// row stride FC + 1 (the pad keeps column reads off a single bank). Rows past
// n_limit and features past F read as 0.
template <int FC>
__device__ __forceinline__ void load_tile(float* dst, const float* src, const Operand& op,
                                          int b, int h, int n0, int n_limit, int f0,
                                          const Problem& p) {
  for (int e = threadIdx.x; e < kBlockM * FC; e += kThreads) {
    const int row = e / FC, col = e % FC;
    const int n = n0 + row, f = f0 + col;
    float x = 0.f;
    if (n < n_limit && f < p.features) x = src[offset(op, b, h, n, f, p.fd)];
    dst[row * (FC + 1) + col] = x;
  }
}

// Logsumexp of a row from its running max and sum; +inf for a row with no
// valid key.
__device__ __forceinline__ float row_lse(float m, float l) {
  return m == -CUDART_INF_F ? CUDART_INF_F : m + logf(l);
}

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// Thread (ty, tx) = (tid / 8, tid % 8) owns query rows ty*4 .. ty*4+3; logit
// columns tx + 8j (j < 8) and output features tx + 8c (c < FC/8). The eight
// lanes sharing a row group are adjacent in one warp, so row statistics
// reduce with three shuffles.
template <int FC>
__global__ void __launch_bounds__(kThreads) attention_kernel(Problem p) {
  static_assert(FC % 8 == 0 && FC <= 128, "feature chunk must be a multiple of 8, at most 128");
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockM * (FC + 1);
  float* vs = ks + kBlockN * (FC + 1);
  float* ps = vs + kBlockN * (FC + 1);  // kBlockM x (kBlockN + 1)

  const int q_tiles = (p.nq + kBlockM - 1) / kBlockM;
  long long blk = blockIdx.x;
  const int chunk = (int)(blk % p.out_chunks);
  blk /= p.out_chunks;
  const int qt = (int)(blk % q_tiles);
  const int bh = (int)(blk / q_tiles);
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = qt * kBlockM;
  const int f_out = chunk * FC;
  const int in_chunks = (p.features + FC - 1) / FC;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const float scale = p.sm_scale * (p.tie_scale ? p.tie_scale[b] : 1.f);

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  float* o = static_cast<float*>(p.o);

  constexpr int OC = FC / 8;
  float acc[4][OC];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  if (in_chunks == 1) load_tile<FC>(qs, q, p.qs, b, h, q0, p.nq, 0, p);

  for (int k0 = 0; k0 < p.nk; k0 += kBlockN) {
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;

    for (int c = 0; c < in_chunks; ++c) {
      if (in_chunks > 1) load_tile<FC>(qs, q, p.qs, b, h, q0, p.nq, c * FC, p);
      load_tile<FC>(ks, k, p.ks, b, h, k0, p.nk, c * FC, p);
      __syncthreads();
#pragma unroll 4
      for (int f = 0; f < FC; ++f) {
        float a[4], kk[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * (FC + 1) + f];
#pragma unroll
        for (int j = 0; j < 8; ++j) kk[j] = ks[(tx + 8 * j) * (FC + 1) + f];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
      }
      __syncthreads();
    }
    load_tile<FC>(vs, v, p.vs, b, h, k0, p.nk, f_out, p);

    bool valid[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kj = k0 + tx + 8 * j;
      valid[j] = kj < p.nk && (p.kv_mask == nullptr || p.kv_mask[(long long)b * p.nk + kj] != 0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = valid[j] ? s[i][j] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max8(mx);
      const float m_new = fmaxf(m_run[i], mx);
      float alpha = 1.f, rs = 0.f;
      if (m_new == -CUDART_INF_F) {
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      } else {
        alpha = expf(m_run[i] - m_new);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float e = valid[j] ? expf(s[i][j] - m_new) : 0.f;
          s[i][j] = e;
          rs += e;
        }
      }
      rs = row_sum8(rs);
      l_run[i] = l_run[i] * alpha + rs;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) ps[(ty * 4 + i) * (kBlockN + 1) + tx + 8 * j] = s[i][j];
    }
    __syncthreads();
    const int kn = min(kBlockN, p.nk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty * 4 + i) * (kBlockN + 1) + kk];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float vv = vs[kk * (FC + 1) + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pr[i], vv, acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    if (n >= p.nq) continue;
    if (p.lse != nullptr && chunk == 0 && tx == 0)
      p.lse[(long long)bh * p.nq + n] = row_lse(m_run[i], l_run[i]);
    const bool qv = p.q_mask == nullptr || p.q_mask[(long long)b * p.nq + n] != 0;
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int f = f_out + tx + 8 * c;
      if (f >= p.features) continue;
      o[offset(p.os, b, h, n, f, p.fd)] = qv ? acc[i][c] * inv : 0.f;
    }
  }
}

// ----------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//
// Each of the 4 warps owns 16 query rows of the 64-row tile. Lane (g, t) =
// (lane / 4, lane % 4) holds, per 8-column n-tile, the accumulator entries
// (row g, cols 2t, 2t+1) and (row g+8, cols 2t, 2t+1) — the PTX m16n8 C
// layout. That layout is also the A layout of the next product, so the
// probabilities go from the logit accumulators straight into P @ V without
// touching shared memory (the FlashAttention-2 arrangement). Tiles are
// staged in shared memory as bf16: q and k row-major (rows of FC + 8), v
// transposed (rows of 64 + 8 keys) so every fragment is one 32-bit load.

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of rows r0, r0 + 8 and features kc, kc + 8 of a
// token-major bf16 tile with rows of `ld` (the backward kernels).
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                       int r0, int kc) {
  a[0] = lds32(tile + r0 * ld + kc);
  a[1] = lds32(tile + (r0 + 8) * ld + kc);
  a[2] = lds32(tile + r0 * ld + kc + 8);
  a[3] = lds32(tile + (r0 + 8) * ld + kc + 8);
}

// The A fragment of 16 columns (n-tiles 2kk, 2kk+1) of an m16n8
// accumulator, rounded to bf16: p or ds passed on to the next product.
__device__ __forceinline__ void acc_frag(uint32_t (&a)[4], const float (&c)[8][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Stage a 64 x FC bf16 tile (tokens n0.., features f0..) in shared memory,
// row stride ld, or transposed (feature-major) when `transpose`. With `vec`
// every 8 consecutive features sit in one 16-byte-aligned row group and
// load as one 16-byte word. Rows past n_limit and features past F read 0.
template <int FC>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, int ld, bool transpose,
                                               const __nv_bfloat16* src, const Operand& op,
                                               int b, int h, int n0, int n_limit, int f0,
                                               const Problem& p, bool vec) {
  constexpr int V = 8;
  for (int e = threadIdx.x; e < kBlockM * (FC / V); e += kThreads) {
    const int row = e / (FC / V), col = (e % (FC / V)) * V;
    const int n = n0 + row, f = f0 + col;
    alignas(16) __nv_bfloat16 x[V];
    if (vec && n < n_limit && f + V <= p.features) {
      *reinterpret_cast<uint4*>(x) =
          *reinterpret_cast<const uint4*>(src + offset(op, b, h, n, f, p.fd));
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        x[i] = (n < n_limit && f + i < p.features) ? src[offset(op, b, h, n, f + i, p.fd)]
                                                   : __float2bfloat16(0.f);
    }
    if (transpose) {
#pragma unroll
      for (int i = 0; i < V; ++i) dst[(col + i) * ld + row] = x[i];
    } else {
      *reinterpret_cast<uint4*>(dst + row * ld + col) = *reinterpret_cast<uint4*>(x);
    }
  }
}

template <int FC>
__global__ void __launch_bounds__(kThreads) attention_kernel_mma(Problem p, int vec) {
  static_assert(FC % 16 == 0 && FC <= 128, "feature chunk must be a multiple of 16, at most 128");
  constexpr int LQ = FC + 8;        // row stride of the q and k tiles
  constexpr int LV = kBlockN + 8;   // row stride of the transposed v tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockM * LQ;
  __nv_bfloat16* vt = ks + kBlockN * LQ;  // FC x LV

  const int q_tiles = (p.nq + kBlockM - 1) / kBlockM;
  long long blk = blockIdx.x;
  const int chunk = (int)(blk % p.out_chunks);
  blk /= p.out_chunks;
  const int qt = (int)(blk % q_tiles);
  const int bh = (int)(blk / q_tiles);
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = qt * kBlockM;
  const int f_out = chunk * FC;
  const int in_chunks = (p.features + FC - 1) / FC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this lane's rows: r0 and r0 + 8
  const float scale = p.sm_scale * (p.tie_scale ? p.tie_scale[b] : 1.f);
  const bool v16 = vec != 0;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o);

  constexpr int ON = FC / 8;  // output n-tiles
  float acc[ON][4];
#pragma unroll
  for (int j = 0; j < ON; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};

  if (in_chunks == 1) load_tile_bf16<FC>(qs, LQ, false, q, p.qs, b, h, q0, p.nq, 0, p, v16);

  for (int k0 = 0; k0 < p.nk; k0 += kBlockN) {
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

    for (int c = 0; c < in_chunks; ++c) {
      if (in_chunks > 1)
        load_tile_bf16<FC>(qs, LQ, false, q, p.qs, b, h, q0, p.nq, c * FC, p, v16);
      load_tile_bf16<FC>(ks, LQ, false, k, p.ks, b, h, k0, p.nk, c * FC, p, v16);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FC / 16; ++kk) {
        const int kc = kk * 16 + 2 * t;
        const uint32_t a[4] = {lds32(qs + r0 * LQ + kc), lds32(qs + (r0 + 8) * LQ + kc),
                               lds32(qs + r0 * LQ + kc + 8), lds32(qs + (r0 + 8) * LQ + kc + 8)};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat16* kr = ks + (8 * j + g) * LQ + kc;
          mma_bf16(s[j], a, lds32(kr), lds32(kr + 8));
        }
      }
      __syncthreads();
    }
    load_tile_bf16<FC>(vt, LV, true, v, p.vs, b, h, k0, p.nk, f_out, p, v16);

    bool valid[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * j + 2 * t + e;
        valid[j][e] =
            kj < p.nk && (p.kv_mask == nullptr || p.kv_mask[(long long)b * p.nk + kj] != 0);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * r + e];
          x = valid[j][e] ? x * scale : -CUDART_INF_F;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      float alpha = 1.f, rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * r + e];
          x = (m_new == -CUDART_INF_F || !valid[j][e]) ? 0.f : expf(x - m_new);
          rs += x;
        }
      if (m_new != -CUDART_INF_F) alpha = expf(m_run[r] - m_new);
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_run[r] = l_run[r] * alpha + rs;
      m_run[r] = m_new;
#pragma unroll
      for (int j = 0; j < ON; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < ON; ++j) {
        const __nv_bfloat16* vr = vt + (8 * j + g) * LV + kk * 16 + 2 * t;
        mma_bf16(acc[j], a, lds32(vr), lds32(vr + 8));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + r0 + 8 * r;
    if (n >= p.nq) continue;
    if (p.lse != nullptr && chunk == 0 && t == 0)
      p.lse[(long long)bh * p.nq + n] = row_lse(m_run[r], l_run[r]);
    const bool qv = p.q_mask == nullptr || p.q_mask[(long long)b * p.nq + n] != 0;
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < ON; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int f = f_out + 8 * j + 2 * t + e;
        if (f < p.features)
          o[offset(p.os, b, h, n, f, p.fd)] = __float2bfloat16(qv ? acc[j][2 * r + e] * inv : 0.f);
      }
  }
}

__host__ inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<unsigned long long>(ptr) & 15ull) == 0;
}

// f32 operands run attention_kernel (CUDA cores); bf16 operands run
// attention_kernel_mma (tensor cores). One block per (batch, head, 64-row
// query tile, output chunk).
template <typename T, int FC>
Af2LaunchPlan plan_attention(const Problem& p) {
  static_assert(std::is_same<T, float>::value || std::is_same<T, __nv_bfloat16>::value,
                "operands are float32 or bfloat16");
  Af2LaunchPlan plan{};
  plan.blocks = (long long)p.batch * p.heads * ((p.nq + kBlockM - 1) / kBlockM) * p.out_chunks;
  plan.threads = kThreads;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    plan.dynamic_smem =
        (2 * kBlockM * (FC + 8) + FC * (kBlockN + 8)) * (int)sizeof(__nv_bfloat16);
    name_kernel(plan, "attention_kernel_mma<%d>", FC);
  } else {
    plan.dynamic_smem = (3 * kBlockM * (FC + 1) + kBlockM * (kBlockN + 1)) * (int)sizeof(float);
    name_kernel(plan, "attention_kernel<%d>", FC);
  }
  return plan;
}

// Launches the plan's kernel; with `plan_out` it only fills the plan.
template <typename T, int FC>
cudaError_t launch_attention(const Problem& p, cudaStream_t stream,
                             Af2LaunchPlan* plan_out = nullptr) {
  const Af2LaunchPlan plan = plan_attention<T, FC>(p);
  if (plan_out != nullptr) {
    *plan_out = plan;
    return cudaSuccess;
  }
  if (!grid_fits(plan)) return cudaErrorInvalidConfiguration;
  const unsigned blocks = (unsigned)plan.blocks;
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    bool vec = p.fd % 8 == 0 && aligned16(p.q) && aligned16(p.k) && aligned16(p.v);
    for (const Operand* op : {&p.qs, &p.ks, &p.vs})
      vec = vec && op->sb % 8 == 0 && op->sh % 8 == 0 && op->sn % 8 == 0 && op->sr % 8 == 0;
    err = cudaFuncSetAttribute(attention_kernel_mma<FC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, plan.dynamic_smem);
    if (err != cudaSuccess) return err;
    attention_kernel_mma<FC><<<blocks, plan.threads, plan.dynamic_smem, stream>>>(p, vec ? 1 : 0);
  } else {
    err = cudaFuncSetAttribute(attention_kernel<FC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, plan.dynamic_smem);
    if (err != cudaSuccess) return err;
    attention_kernel<FC><<<blocks, plan.threads, plan.dynamic_smem, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace af2

extern "C" const char* af2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
