// K2 and its backward at wide R*D, redesigned for Hopper (sm_90a): the
// shared logits computed once over the fused R*D axis in feature splits,
// the splits summed in a fixed order with the softmax (forward) or p and ds
// (backward), then the products by column group. Included by
// tied_row_attention.cu and tied_row_attention_bwd.cu, whose plans route
// here every bf16 problem at head dim (row width) 32, 64 or 128 whose
// operands TMA can describe and which the resident kernels
// (tied_row_attention_sm90.cuh, tied_row_attention_bwd_sm90.cuh) do not
// take: R*D above 512 (forward) or 448 (backward) at head dim 64.
//
// Replaces the TPU path alphafold2_tpu/ops/pallas/tied_row.py
// `tied_row_attention` (:53) at those widths, which folds the rows into head
// dim R*D and runs ops/pallas/axial.py `_run` (pallas_call :249) and, under
// jax.grad, `_run_dq` (:275) and `_run_dkv` (:313). With s = sm_scale *
// tie[b] on the f32 logits:
//     S = Q'K'^T (over the fused (r, d) axis), P = softmax(s S | kv_mask)
//     out = P V'; dS = P o (dO'V'^T - dsum); dq = s dS K'; dk = s dS^T Q';
//     dv = P^T dO'
// with the masking contract of attention_tile.cuh (masked keys weigh 0,
// masked queries and rows with no valid key give 0 and, in the backward,
// add nothing).
//
// Why not the resident design: a block that keeps its 64 rows over the
// whole R*D axis needs 128 * R*D bytes a tile (1 MB at the PLM grid's R*D
// 8192); the chunked kernels that took these widths before recompute the
// logit tile once per 64-wide output chunk (R*D / 64 times: 128x at R*D
// 8192) from ordinary loads. Here the logits are computed once:
//
// (a) tied_wide_logits_kernel<D, OPS>: one block per (batch * head, feature
//     split, 64-query tile, 64-key tile). A producer warp streams the
//     split's Q and K (the backward also dO and V) as 5-D TMA boxes of 64
//     tokens x 128 fused features (whole rows r; a row of 128 as two boxes
//     along D) through a ring of three stages; one consumer warpgroup
//     accumulates S = Q K^T (and dP = dO V^T) over the split with wgmma
//     m64n64k16 and writes the f32 partial tile to the workspace (OPS/2,
//     splits, B*H, Nq', Nk'), Nq' and Nk' being N rounded up to 64 (padded
//     tokens read as 0 through TMA's fill). The plan picks the split count
//     so that the grid fills the card's waves best (a pure function of the
//     shape, at most kMaxSplits, the partials within kWorkspaceBudget).
// (b) forward, tied_wide_softmax_kernel: one warp a query row sums the
//     partials in split order, scales by s * log2 e, takes the row's max and
//     sum over its valid keys (a butterfly whose combine is symmetric, so
//     every lane holds the same bits), writes the lse (+inf for a row with
//     no valid key) and P = 2^(x - lse2) rounded to bf16 (0 for masked keys,
//     masked queries and key-less rows), (B*H, Nq', Nk'). Backward,
//     tied_wide_grad_kernel: one block a 64 x 64 tile: p = 2^(S s log2 e -
//     lse log2 e) (0 for a masked key and a dead row), ds = p (dP - dsum),
//     both rounded to bf16 as the resident kernels round them, written as dS
//     (Nq' x Nk') and, through shared memory, dS^T and P^T (Nk' x Nq').
// (c) tied_wide_product_kernel<D, C>: one block per (batch * head, 64-row
//     tile, group of C = 64 or 128 fused output columns): its A rows (P, dS,
//     dS^T or P^T) from the workspace straight into wgmma A fragments, X (V,
//     K, Q or dO) as 64-token x CW boxes of the block's columns through a
//     ring of four stages, wgmma m64nCWk16, then the tile times 1 (out, dv)
//     or s (dq, dk) as bf16 into the (B, R, N, H, D) output through its
//     strides. The last group repeats its last chunk where R*D is not a
//     multiple of C and does not store it.
//
// No atomics: every sum has one owner and a fixed order, so two runs give
// the same bits. What bounds each pass on the H100 at the PLM grid's tied
// rows (1 x 128 rows x 128 x 8 heads x 64, R*D 8192, bf16): (a) bytes, Q and
// K (16.8 MB each; the backward also dO and V) read once per tile of the
// other side (twice at N 128, the second mostly from L2), against 2 * 64 *
// 64 * 128 operations a 32 KB stage, far below the tensor cores' rate;
// (b) bytes, the partials (0.5 MB a split) read twice and P written; (c)
// bytes, V (K, Q, dO) read once per 64-row tile of the other side and the
// output written once. Every mbarrier wait traps after kSpinLimit polls
// (sm90_ptx.cuh).

#pragma once

#include <climits>

#include "sm90_ptx.cuh"

namespace af2 {
namespace sm90 {
namespace wide {

constexpr int kRows = 64;            // tokens of every tile
constexpr int kStageFeatures = 128;  // fused features a logits stage carries
constexpr int kLogitStages = 3;      // ring of (a)
constexpr int kProductStages = 4;    // ring of (c)
constexpr int kMaxSplits = 8;
constexpr long long kWorkspaceBudget = 64LL << 20;  // bytes of f32 partials with splits > 1
constexpr int kThreads = 128 + 32;  // one consumer warpgroup, one producer warp
constexpr int kReduceThreads = 256;  // (b): eight warps
constexpr int kSMs = 132;            // the H100 SXM's: the plan's wave
constexpr int kSmemLimit = 232448;   // dynamic shared memory a block may take
constexpr int kSmemPerSM = 233472;   // an SM's shared memory, 1 KB of it reserved a block
constexpr int kControlBytes = 128;   // the ring's barriers, rounded up
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static_assert(D == 32 || D == 64 || D == 128, "row width 32, 64 or 128");
  static constexpr int CW = D < 64 ? D : 64;  // columns of one swizzled chunk
  static constexpr int NDC = D / CW;          // chunks along one row's width
  static constexpr int SWB = CW * 2;          // bytes per chunk row = swizzle span
  static constexpr int kChunk = kRows * SWB;  // bytes of one 64-token chunk
  static constexpr int SR = kStageFeatures / D;              // rows r a logits stage carries
  static constexpr int kOperandBytes = kRows * kStageFeatures * 2;  // one operand of a stage
  static constexpr int kStageChunks = SR * NDC;              // its chunks
};

struct Control {
  uint64_t full[kProductStages];
  uint64_t empty[kProductStages];
};
static_assert(sizeof(Control) <= kControlBytes, "kControlBytes must hold the barriers");
static_assert(kLogitStages <= kProductStages, "Control holds the larger ring");

// Dynamic shared memory of a logits block (OPS operands a stage) and of a
// product block (C columns a stage), after up to 1 KB of alignment.
__host__ __device__ constexpr long long logits_smem(int ops) {
  return 1024 + (long long)kLogitStages * ops * kRows * kStageFeatures * 2 + kControlBytes;
}
__host__ __device__ constexpr long long product_smem(int columns) {
  return 1024 + (long long)kProductStages * kRows * columns * 2 + kControlBytes;
}

__host__ __device__ constexpr long long round64(long long n) { return (n + 63) / 64 * 64; }

__device__ __forceinline__ void init_ring(Control& ctl, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&ctl.full[s], 1);     // the producer's one arrival with its bytes
      mbar_init(&ctl.empty[s], 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---------------------------------------------------------------- (a)

struct LogitParams {
  float* ws;         // (OPS / 2, splits, B*H, nqp, nkp) f32
  long long plane;   // B*H * nqp * nkp
  int heads, nqp, nkp, q_tiles, k_tiles, splits, per_split, stages;  // stages: over R*D
};

template <int D, int OPS>
__global__ void __launch_bounds__(kThreads, 1)
    tied_wide_logits_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tv, const LogitParams p) {
  using G = Cfg<D>;
  static_assert(OPS == 2 || OPS == 4, "S alone, or S and dP");
  constexpr int kStageBytes = OPS * G::kOperandBytes;
  extern __shared__ unsigned char wide_smem[];
  unsigned char* ring = align1024(wide_smem);
  Control& ctl = *reinterpret_cast<Control*>(ring + kLogitStages * kStageBytes);

  long long blk = blockIdx.x;
  const int kt = (int)(blk % p.k_tiles);
  blk /= p.k_tiles;
  const int qt = (int)(blk % p.q_tiles);
  blk /= p.q_tiles;
  const int sp = (int)(blk % p.splits);
  const long long bh = blk / p.splits;
  const int b = (int)(bh / p.heads), h = (int)(bh % p.heads);
  const int s0 = sp * p.per_split;
  const int count = min(p.per_split, p.stages - s0);

  init_ring(ctl, kLogitStages);
  // the role, broadcast from lane 0 so that ptxas sees the branch as
  // warp-uniform (a branch it cannot prove uniform serialises every wgmma)
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == 1) {  // the producer warp: one lane issues every copy
    if ((threadIdx.x & 31) == 0) {
      const CUtensorMap* maps[4] = {&tq, &tk, &tdo, &tv};
      const int tok[4] = {qt * kRows, kt * kRows, qt * kRows, kt * kRows};
      for (int it = 0; it < count; ++it) {
        const int st = it % kLogitStages;
        mbar_wait(&ctl.empty[st], ((it / kLogitStages) & 1) ^ 1);
        unsigned char* stage = ring + st * kStageBytes;
        mbar_arrive_expect_tx(&ctl.full[st], kStageBytes);
        const int r0 = (s0 + it) * G::SR;  // rows past R land as zeros
#pragma unroll
        for (int o = 0; o < OPS; ++o)
#pragma unroll
          for (int dc = 0; dc < G::NDC; ++dc)
            tma_load_5d(stage + o * G::kOperandBytes + dc * G::SR * G::kChunk, maps[o],
                        &ctl.full[st], dc * G::CW, h, tok[o], r0, b);
      }
    }
    return;
  }

  const int wt = threadIdx.x;
  const int lane = wt & 31, t = lane & 3;
  const int lrow = 16 * (wt / 32) + (lane >> 2);  // this thread's rows: lrow, lrow + 8
  float s[kRows / 2], dp[kRows / 2];  // [4j + 2r + e]: row lrow + 8r, key 8j + 2t + e
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) s[i] = dp[i] = 0.f;
  for (int it = 0; it < count; ++it) {
    const int st = it % kLogitStages;
    mbar_wait(&ctl.full[st], (it / kLogitStages) & 1);
    const uint32_t base = smem_u32(ring + st * kStageBytes);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < G::kStageChunks; ++c)
#pragma unroll
      for (int kk = 0; kk < G::CW / 16; ++kk) {
        const uint32_t off = c * G::kChunk + kk * 32;
        wgmma_ss<kRows>(s, kmajor_desc<G::SWB>(base + off),
                        kmajor_desc<G::SWB>(base + G::kOperandBytes + off), 1);
        if constexpr (OPS == 4)
          wgmma_ss<kRows>(dp, kmajor_desc<G::SWB>(base + 2 * G::kOperandBytes + off),
                          kmajor_desc<G::SWB>(base + 3 * G::kOperandBytes + off), 1);
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);
    if constexpr (OPS == 4) fence_operands(dp);
    mbar_arrive(&ctl.empty[st]);
  }

  // the partial tile, unguarded: the workspace is padded to whole tiles
  const long long tile = sp * p.plane + bh * p.nqp * p.nkp;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = tile + (long long)(qt * kRows + lrow + 8 * r) * p.nkp + kt * kRows;
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      *reinterpret_cast<float2*>(p.ws + row + 8 * j + 2 * t) =
          make_float2(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
      if constexpr (OPS == 4)
        *reinterpret_cast<float2*>(p.ws + (long long)p.splits * p.plane + row + 8 * j + 2 * t) =
            make_float2(dp[4 * j + 2 * r], dp[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- (b)

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}

struct SoftmaxParams {
  const float* ws;       // (splits, B*H, nqp, nkp) f32 partials of S
  unsigned short* prob;  // bf16 P (B*H, nqp, nkp)
  float* lse;            // (B, H, nq) f32, or null (serving)
  const unsigned char* q_mask;
  const unsigned char* kv_mask;
  const float* tie_scale;  // (B,) f32, or null (1)
  long long plane;
  int heads, nq, nk, nqp, nkp, splits;
  float scale_log2;  // sm_scale * log2(e); the kernel multiplies in tie[b]
};

__global__ void __launch_bounds__(kReduceThreads)
    tied_wide_softmax_kernel(const SoftmaxParams p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kReduceThreads / 32) + warp;  // of B*H*nqp
  const long long bh = row / p.nqp;
  const int q = (int)(row % p.nqp), b = (int)(bh / p.heads);
  const float scale = p.scale_log2 * (p.tie_scale != nullptr ? p.tie_scale[b] : 1.f);
  const float* w = p.ws + row * p.nkp;
  const unsigned char* km = p.kv_mask != nullptr ? p.kv_mask + (long long)b * p.nk : nullptr;

  float m = -CUDART_INF_F, l = 0.f;
  for (int k = lane; k < p.nk; k += 32) {
    if (km != nullptr && km[k] == 0) continue;
    float acc = 0.f;
    for (int sp = 0; sp < p.splits; ++sp) acc += w[sp * p.plane + k];
    const float x = acc * scale;
    if (x > m) {
      l = __fmaf_rn(l, exp2f(m - x), 1.f);
      m = x;
    } else {
      l += exp2f(x - m);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, m2);
    // symmetric in the two lanes (no contraction), so all lanes agree
    if (mn != -CUDART_INF_F)
      l = __fadd_rn(__fmul_rn(l, exp2f(m - mn)), __fmul_rn(l2, exp2f(m2 - mn)));
    m = mn;
  }
  const bool keyed = m != -CUDART_INF_F;
  const float lse2 = keyed ? m + log2f(l) : CUDART_INF_F;
  if (lane == 0 && p.lse != nullptr && q < p.nq)
    p.lse[bh * p.nq + q] = keyed ? lse2 * kLn2 : CUDART_INF_F;
  const bool live = keyed && q < p.nq &&
                    (p.q_mask == nullptr || p.q_mask[(long long)b * p.nq + q] != 0);
  unsigned short* pr = p.prob + row * p.nkp;
  for (int k = lane; k < p.nkp; k += 32) {
    float pv = 0.f;
    if (live && k < p.nk && (km == nullptr || km[k] != 0)) {
      float acc = 0.f;
      for (int sp = 0; sp < p.splits; ++sp) acc += w[sp * p.plane + k];
      pv = exp2f(acc * scale - lse2);
    }
    pr[k] = bf16_bits(pv);
  }
}

struct GradParams {
  const float* ws;      // (2, splits, B*H, nqp, nkp) f32 partials: S, then dP
  unsigned short* ds;   // bf16 dS (B*H, nqp, nkp)
  unsigned short* ds_t; // bf16 dS^T (B*H, nkp, nqp)
  unsigned short* p_t;  // bf16 P^T (B*H, nkp, nqp)
  const float* lse;     // (B, H, nq) f32; +inf: no valid key
  const float* dsum;    // (B, H, nq) f32
  const unsigned char* q_mask;
  const unsigned char* kv_mask;
  const float* tie_scale;  // (B,) f32, or null (1)
  long long plane;
  int heads, nq, nk, nqp, nkp, splits, q_tiles, k_tiles;
  float scale_log2;  // sm_scale * log2(e)
};

__global__ void __launch_bounds__(kReduceThreads) tied_wide_grad_kernel(const GradParams p) {
  __shared__ unsigned short tp[kRows][kRows + 2], tds[kRows][kRows + 2];
  long long blk = blockIdx.x;
  const int kt = (int)(blk % p.k_tiles);
  blk /= p.k_tiles;
  const int qt = (int)(blk % p.q_tiles);
  const long long bh = blk / p.q_tiles;
  const int b = (int)(bh / p.heads);
  const float scale = p.scale_log2 * (p.tie_scale != nullptr ? p.tie_scale[b] : 1.f);
  for (int e = threadIdx.x; e < kRows * kRows; e += kReduceThreads) {
    const int ql = e / kRows, kl = e % kRows;
    const int q = qt * kRows + ql, k = kt * kRows + kl;
    const bool qv = q < p.nq && (p.q_mask == nullptr || p.q_mask[(long long)b * p.nq + q] != 0);
    const float l = qv ? p.lse[bh * p.nq + q] : CUDART_INF_F;
    float pv = 0.f, dsv = 0.f;
    if (l < CUDART_INF_F && k < p.nk &&
        (p.kv_mask == nullptr || p.kv_mask[(long long)b * p.nk + k] != 0)) {
      const long long at = (bh * p.nqp + q) * p.nkp + k;
      float sacc = 0.f, dacc = 0.f;
      for (int sp = 0; sp < p.splits; ++sp) {
        sacc += p.ws[sp * p.plane + at];
        dacc += p.ws[(p.splits + sp) * p.plane + at];
      }
      pv = exp2f(sacc * scale - l * kLog2e);
      dsv = pv * (dacc - p.dsum[bh * p.nq + q]);
    }
    const unsigned short pb = bf16_bits(pv), db = bf16_bits(dsv);
    p.ds[(bh * p.nqp + q) * p.nkp + k] = db;
    tp[ql][kl] = pb;
    tds[ql][kl] = db;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * kRows; e += kReduceThreads) {
    const int kl = e / kRows, ql = e % kRows;
    const long long at = (bh * p.nkp + kt * kRows + kl) * p.nqp + qt * kRows + ql;
    p.p_t[at] = tp[ql][kl];
    p.ds_t[at] = tds[ql][kl];
  }
}

// ---------------------------------------------------------------- (c)

struct ProductParams {
  const unsigned short* a;  // bf16 A (B*H, mp, kp), zero past its rows and columns
  void* out;                // bf16 through os
  Operand os;               // element strides (batch, head, token, row)
  const float* tie_scale;   // (B,) f32, or null (1)
  float sm_scale;           // with `scaled`: the output times sm_scale * tie[b]
  int scaled;
  int heads, m, mp, kp, m_tiles, k_tiles, groups, chunks;  // chunks: R * NDC of the fused axis
};

__device__ __forceinline__ uint32_t ldg32(const unsigned short* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D, int C>
__global__ void __launch_bounds__(kThreads, 1)
    tied_wide_product_kernel(const __grid_constant__ CUtensorMap tx, const ProductParams p) {
  using G = Cfg<D>;
  constexpr int CPG = C / G::CW;
  constexpr int kStageBytes = CPG * G::kChunk;
  extern __shared__ unsigned char wide_smem[];
  unsigned char* ring = align1024(wide_smem);
  Control& ctl = *reinterpret_cast<Control*>(ring + kProductStages * kStageBytes);

  long long blk = blockIdx.x;
  const int g = (int)(blk % p.groups);
  blk /= p.groups;
  const int mt = (int)(blk % p.m_tiles);
  const long long bh = blk / p.m_tiles;
  const int b = (int)(bh / p.heads), h = (int)(bh % p.heads);
  const int fc0 = g * CPG;

  init_ring(ctl, kProductStages);
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == 1) {
    if ((threadIdx.x & 31) == 0) {
      for (int kt = 0; kt < p.k_tiles; ++kt) {
        const int st = kt % kProductStages;
        mbar_wait(&ctl.empty[st], ((kt / kProductStages) & 1) ^ 1);
        unsigned char* stage = ring + st * kStageBytes;
        mbar_arrive_expect_tx(&ctl.full[st], kStageBytes);
#pragma unroll
        for (int c = 0; c < CPG; ++c) {
          const int fc = min(fc0 + c, p.chunks - 1);  // the last group repeats its last chunk
          tma_load_5d(stage + c * G::kChunk, &tx, &ctl.full[st], (fc % G::NDC) * G::CW, h,
                      kt * kRows, fc / G::NDC, b);
        }
      }
    }
    return;
  }

  const int wt = threadIdx.x;
  const int lane = wt & 31, t = lane & 3;
  const int lrow = 16 * (wt / 32) + (lane >> 2);
  float o[CPG][G::CW / 2];
#pragma unroll
  for (int c = 0; c < CPG; ++c)
#pragma unroll
    for (int i = 0; i < G::CW / 2; ++i) o[c][i] = 0.f;
  // this thread's A rows lrow and lrow + 8, columns 2t, 2t + 1 (+8) of each
  // 16-wide k-step: the mma.m16n8k16 A fragment
  const unsigned short* arow = p.a + (bh * p.mp + mt * kRows + lrow) * p.kp + 2 * t;
  for (int kt = 0; kt < p.k_tiles; ++kt) {
    uint32_t af[kRows / 16][4];
    const unsigned short* ak = arow + kt * kRows;
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      af[kk][0] = ldg32(ak + 16 * kk);
      af[kk][1] = ldg32(ak + 8 * p.kp + 16 * kk);
      af[kk][2] = ldg32(ak + 16 * kk + 8);
      af[kk][3] = ldg32(ak + 8 * p.kp + 16 * kk + 8);
    }
    const int st = kt % kProductStages;
    mbar_wait(&ctl.full[st], (kt / kProductStages) & 1);
    const uint32_t base = smem_u32(ring + st * kStageBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
#pragma unroll
      for (int c = 0; c < CPG; ++c)
        wgmma_rs<G::CW>(o[c], af[kk],
                        mnmajor_desc<G::SWB>(base + c * G::kChunk + kk * 16 * G::SWB), 1);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < CPG; ++c) fence_operands(o[c]);
    mbar_arrive(&ctl.empty[st]);
  }

  const float scale =
      p.scaled ? p.sm_scale * (p.tie_scale != nullptr ? p.tie_scale[b] : 1.f) : 1.f;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = mt * kRows + lrow + 8 * r;
    if (n >= p.m) continue;
#pragma unroll
    for (int c = 0; c < CPG; ++c) {
      const int fc = fc0 + c;
      if (fc >= p.chunks) continue;  // the last group's repeated chunk
      __nv_bfloat16* row = out + (long long)b * p.os.sb + (long long)h * p.os.sh +
                           (long long)n * p.os.sn + (long long)(fc / G::NDC) * p.os.sr +
                           (fc % G::NDC) * G::CW;
#pragma unroll
      for (int j = 0; j < G::CW / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t) =
            pack_bf16(o[c][4 * j + 2 * r] * scale, o[c][4 * j + 2 * r + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------- host

// The wide route's plan at a shape: the logits pass's feature splits (each
// `per_split` stages of kStageFeatures), 0 where the route does not take
// the shape (row width outside 32/64/128, a fused axis that is not whole
// rows, or fewer rows than one stage holds). A pure function of the shape:
// the split count (at most kMaxSplits, the partials within
// kWorkspaceBudget) that fills the logits grid's waves best, the fewest
// splits among equals.
struct WidePlan {
  int splits, per_split, stages;
};

__host__ inline int blocks_per_sm(long long smem) {
  return (int)(kSmemPerSM / (smem + 1024));
}

__host__ inline WidePlan plan_wide(bool bwd, int batch, int heads, int nq, int nk, int features,
                                   int row_width) {
  if (row_width != 32 && row_width != 64 && row_width != 128) return {0, 0, 0};
  if (features < row_width || features % row_width != 0 || nq < 1 || nk < 1) return {0, 0, 0};
  const int rows = features / row_width, sr = kStageFeatures / row_width;
  if (rows < sr) return {0, 0, 0};
  const int stages = (rows + sr - 1) / sr;
  const int ops = bwd ? 4 : 2;
  const long long tiles = (long long)batch * heads * ((nq + kRows - 1) / kRows) *
                          ((nk + kRows - 1) / kRows);
  const long long wave = (long long)kSMs * blocks_per_sm(logits_smem(ops));
  const long long split_bytes = 4LL * (ops / 2) * batch * heads * round64(nq) * round64(nk);
  WidePlan best{1, stages, stages};
  long long best_cost = LLONG_MAX;
  for (int s = 1; s <= kMaxSplits && s <= stages; ++s) {
    if (s > 1 && s * split_bytes > kWorkspaceBudget) break;
    const int per = (stages + s - 1) / s;
    const int splits = (stages + per - 1) / per;
    const long long cost = (tiles * splits + wave - 1) / wave * per;
    if (cost < best_cost) {
      best = {splits, per, stages};
      best_cost = cost;
    }
  }
  return best;
}

// Output columns a product block (64 or 128): 128 where the grid then
// fills a wave of the card's SMs, as the resident kernels choose.
__host__ inline int product_columns(int batch, int heads, int m, int features) {
  const long long blocks = (long long)batch * heads * ((m + kRows - 1) / kRows) *
                           ((features + 127) / 128);
  return features >= 128 && blocks >= kSMs ? 128 : 64;
}

// Bytes of the wrapper's workspace: the f32 partials, then bf16 P (forward)
// or dS, dS^T and P^T (backward), each part 256-byte aligned.
__host__ inline long long align256(long long n) { return (n + 255) / 256 * 256; }

__host__ inline long long workspace_bytes(bool bwd, const WidePlan& wp, int batch, int heads,
                                          int nq, int nk) {
  const long long tile = (long long)batch * heads * round64(nq) * round64(nk);
  return align256(4 * tile * wp.splits * (bwd ? 2 : 1)) + (bwd ? 3 : 1) * align256(2 * tile);
}

// A product launch writing the `m` tokens of an output over the fused axis.
__host__ inline Af2LaunchPlan plan_product(int batch, int heads, int m, int features,
                                           int row_width) {
  Af2LaunchPlan plan{};
  const int columns = product_columns(batch, heads, m, features);
  plan.blocks = (long long)batch * heads * ((m + kRows - 1) / kRows) *
                ((features + columns - 1) / columns);
  plan.threads = kThreads;
  plan.dynamic_smem = (int)product_smem(columns);
  name_kernel(plan, "tied_wide_product_kernel<%d,%d>", row_width, columns);
  return plan;
}

// The plan of one pass of the wide route. Forward passes: 0 the logits, 1
// the softmax, 2 P V'. Backward passes: 0 the logits (S and dP), 1 p and
// ds, 2 the dq product, 3 a dk or dv product (launched twice).
__host__ inline Af2LaunchPlan plan_pass(bool bwd, int pass, const WidePlan& wp, int batch,
                                        int heads, int nq, int nk, int features,
                                        int row_width) {
  Af2LaunchPlan plan{};
  const long long bhs = (long long)batch * heads;
  const long long qt = (nq + kRows - 1) / kRows, kt = (nk + kRows - 1) / kRows;
  if (pass == 0) {
    plan.blocks = bhs * qt * kt * wp.splits;
    plan.threads = kThreads;
    plan.dynamic_smem = (int)logits_smem(bwd ? 4 : 2);
    name_kernel(plan, "tied_wide_logits_kernel<%d,%d>", row_width, bwd ? 4 : 2);
  } else if (pass == 1) {
    plan.blocks = bwd ? bhs * qt * kt : bhs * qt * kRows / (kReduceThreads / 32);
    plan.threads = kReduceThreads;
    plan.dynamic_smem = 0;
    name_kernel(plan, bwd ? "tied_wide_grad_kernel" : "tied_wide_softmax_kernel");
  } else {
    plan = plan_product(batch, heads, pass == 3 ? nk : nq, features, row_width);
  }
  return plan;
}

// One problem of the wide route, forward or backward, as the two sources
// receive it: operands through their (batch, head, token, row) element
// strides, the outputs the call writes (null where it writes none).
struct WideOperands {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;              // backward
  const float* lse;              // backward: the forward's
  const float* dsum;             // backward
  const unsigned char* q_mask;   // (B, Nq) 0/1, or null
  const unsigned char* kv_mask;  // (B, Nk) 0/1, or null
  const float* tie_scale;        // (B,) f32, or null (1)
  void* out;                     // forward
  float* lse_out;                // forward, or null (serving)
  void* dq;
  void* dk;
  void* dv;
  Operand qs, ks, vs, dos, os, dqs, dks, dvs;
  int batch, heads, nq, nk, features, row_width;
  float sm_scale;
  void* work;
  long long work_bytes;
};

template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

template <int D, int C>
__host__ inline cudaError_t launch_product_columns(const CUtensorMap& tx, const ProductParams& pp,
                                                   const Af2LaunchPlan& plan,
                                                   cudaStream_t stream) {
  const cudaError_t err = allow_smem(tied_wide_product_kernel<D, C>, plan.dynamic_smem);
  if (err != cudaSuccess) return err;
  tied_wide_product_kernel<D, C>
      <<<(unsigned)plan.blocks, kThreads, plan.dynamic_smem, stream>>>(tx, pp);
  return cudaGetLastError();
}

// out[m, cols] = A[m, :] X[:, cols] (times s where `scaled`) over the m
// tokens of `out`, X the (B, R, N, H, D) operand `x` of `n` tokens.
template <int D>
__host__ inline cudaError_t launch_product(const WideOperands& a, int m, const void* x,
                                           const Operand& xs, int n, const unsigned short* amat,
                                           void* out, const Operand& os, int scaled,
                                           cudaStream_t stream) {
  using G = Cfg<D>;
  const int rows = a.features / D;
  const Af2LaunchPlan plan = plan_product(a.batch, a.heads, m, a.features, D);
  if (!grid_fits(plan)) return cudaErrorInvalidValue;
  CUtensorMap tx;
  if (!encode_rows(&tx, x, xs, a.batch, a.heads, n, rows, D, 1)) return cudaErrorInvalidValue;
  ProductParams pp;
  pp.a = amat;
  pp.out = out;
  pp.os = os;
  pp.tie_scale = a.tie_scale;
  pp.sm_scale = a.sm_scale;
  pp.scaled = scaled;
  pp.heads = a.heads;
  pp.m = m;
  pp.mp = (int)round64(m);
  pp.kp = (int)round64(n);
  pp.m_tiles = (m + kRows - 1) / kRows;
  pp.k_tiles = (n + kRows - 1) / kRows;
  const int columns = product_columns(a.batch, a.heads, m, a.features);
  pp.groups = (a.features + columns - 1) / columns;
  pp.chunks = rows * G::NDC;
  return columns == 128 ? launch_product_columns<D, 128>(tx, pp, plan, stream)
                        : launch_product_columns<D, 64>(tx, pp, plan, stream);
}

// Pass (a) on 5-D maps whose boxes hold one stage's SR rows.
template <int D, int OPS>
__host__ inline cudaError_t launch_logits(const WideOperands& a, const WidePlan& wp, float* ws,
                                          cudaStream_t stream) {
  using G = Cfg<D>;
  const int rows = a.features / D;
  const Af2LaunchPlan plan = plan_pass(OPS == 4, 0, wp, a.batch, a.heads, a.nq, a.nk,
                                       a.features, D);
  if (!grid_fits(plan)) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tdo, tv;
  if (!encode_rows(&tq, a.q, a.qs, a.batch, a.heads, a.nq, rows, D, G::SR) ||
      !encode_rows(&tk, a.k, a.ks, a.batch, a.heads, a.nk, rows, D, G::SR))
    return cudaErrorInvalidValue;
  if (OPS == 4) {
    if (!encode_rows(&tdo, a.dout, a.dos, a.batch, a.heads, a.nq, rows, D, G::SR) ||
        !encode_rows(&tv, a.v, a.vs, a.batch, a.heads, a.nk, rows, D, G::SR))
      return cudaErrorInvalidValue;
  } else {
    tdo = tq;
    tv = tk;
  }
  LogitParams lp;
  lp.ws = ws;
  lp.heads = a.heads;
  lp.nqp = (int)round64(a.nq);
  lp.nkp = (int)round64(a.nk);
  lp.plane = (long long)a.batch * a.heads * lp.nqp * lp.nkp;
  lp.q_tiles = lp.nqp / kRows;
  lp.k_tiles = lp.nkp / kRows;
  lp.splits = wp.splits;
  lp.per_split = wp.per_split;
  lp.stages = wp.stages;
  const cudaError_t err = allow_smem(tied_wide_logits_kernel<D, OPS>, plan.dynamic_smem);
  if (err != cudaSuccess) return err;
  tied_wide_logits_kernel<D, OPS>
      <<<(unsigned)plan.blocks, kThreads, plan.dynamic_smem, stream>>>(tq, tk, tdo, tv, lp);
  return cudaGetLastError();
}

__host__ inline bool work_fits(const WideOperands& a, bool bwd, const WidePlan& wp) {
  return a.work != nullptr && reinterpret_cast<uintptr_t>(a.work) % 256 == 0 &&
         a.work_bytes >= workspace_bytes(bwd, wp, a.batch, a.heads, a.nq, a.nk);
}

// The forward: (a), the softmax, P V' into a.out (and the lse into
// a.lse_out where given).
template <int D>
__host__ inline cudaError_t launch_forward(const WideOperands& a, const WidePlan& wp,
                                           cudaStream_t stream) {
  if (!work_fits(a, false, wp)) return cudaErrorInvalidValue;
  const long long nqp = round64(a.nq), nkp = round64(a.nk);
  const long long tile = (long long)a.batch * a.heads * nqp * nkp;
  float* ws = static_cast<float*>(a.work);
  auto* prob = reinterpret_cast<unsigned short*>(static_cast<unsigned char*>(a.work) +
                                                 align256(4 * tile * wp.splits));
  cudaError_t err = launch_logits<D, 2>(a, wp, ws, stream);
  if (err != cudaSuccess) return err;
  SoftmaxParams sp;
  sp.ws = ws;
  sp.prob = prob;
  sp.lse = a.lse_out;
  sp.q_mask = a.q_mask;
  sp.kv_mask = a.kv_mask;
  sp.tie_scale = a.tie_scale;
  sp.plane = tile;
  sp.heads = a.heads;
  sp.nq = a.nq;
  sp.nk = a.nk;
  sp.nqp = (int)nqp;
  sp.nkp = (int)nkp;
  sp.splits = wp.splits;
  sp.scale_log2 = a.sm_scale * kLog2e;
  const Af2LaunchPlan red = plan_pass(false, 1, wp, a.batch, a.heads, a.nq, a.nk, a.features, D);
  if (!grid_fits(red)) return cudaErrorInvalidValue;
  tied_wide_softmax_kernel<<<(unsigned)red.blocks, kReduceThreads, 0, stream>>>(sp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_product<D>(a, a.nq, a.v, a.vs, a.nk, prob, a.out, a.os, 0, stream);
}

// The backward: (a) with dP, p and ds, then the products of the outputs
// asked for: dq = s dS K'; dk = s dS^T Q' and dv = P^T dO'.
template <int D>
__host__ inline cudaError_t launch_backward(const WideOperands& a, const WidePlan& wp,
                                            bool want_dq, bool want_dkv, cudaStream_t stream) {
  if (!work_fits(a, true, wp)) return cudaErrorInvalidValue;
  const long long nqp = round64(a.nq), nkp = round64(a.nk);
  const long long tile = (long long)a.batch * a.heads * nqp * nkp;
  unsigned char* base = static_cast<unsigned char*>(a.work);
  float* ws = reinterpret_cast<float*>(base);
  auto* ds = reinterpret_cast<unsigned short*>(base + align256(8 * tile * wp.splits));
  auto* ds_t = ds + align256(2 * tile) / 2;
  auto* p_t = ds_t + align256(2 * tile) / 2;
  cudaError_t err = launch_logits<D, 4>(a, wp, ws, stream);
  if (err != cudaSuccess) return err;
  GradParams gp;
  gp.ws = ws;
  gp.ds = ds;
  gp.ds_t = ds_t;
  gp.p_t = p_t;
  gp.lse = a.lse;
  gp.dsum = a.dsum;
  gp.q_mask = a.q_mask;
  gp.kv_mask = a.kv_mask;
  gp.tie_scale = a.tie_scale;
  gp.plane = tile;
  gp.heads = a.heads;
  gp.nq = a.nq;
  gp.nk = a.nk;
  gp.nqp = (int)nqp;
  gp.nkp = (int)nkp;
  gp.splits = wp.splits;
  gp.q_tiles = (int)(nqp / kRows);
  gp.k_tiles = (int)(nkp / kRows);
  gp.scale_log2 = a.sm_scale * kLog2e;
  const Af2LaunchPlan red = plan_pass(true, 1, wp, a.batch, a.heads, a.nq, a.nk, a.features, D);
  if (!grid_fits(red)) return cudaErrorInvalidValue;
  tied_wide_grad_kernel<<<(unsigned)red.blocks, kReduceThreads, 0, stream>>>(gp);
  err = cudaGetLastError();
  if (err == cudaSuccess && want_dq)
    err = launch_product<D>(a, a.nq, a.k, a.ks, a.nk, ds, a.dq, a.dqs, 1, stream);
  if (err == cudaSuccess && want_dkv)
    err = launch_product<D>(a, a.nk, a.q, a.qs, a.nq, ds_t, a.dk, a.dks, 1, stream);
  if (err == cudaSuccess && want_dkv)
    err = launch_product<D>(a, a.nk, a.dout, a.dos, a.nq, p_t, a.dv, a.dvs, 0, stream);
  return err;
}

}  // namespace wide
}  // namespace sm90
}  // namespace af2
