// K3a/K3b's bf16 backward redesigned for Hopper (sm_90a): TMA-fed tiles,
// wgmma, skipped dead tiles, and a split over the long loop with an
// ordered merge. Included by fused_attention_bwd.cu, whose plan routes every
// bf16 problem these kernels take here (head dim 32, 64 or 128, operands TMA
// can describe); every other bf16 problem runs dq_kernel_mma /
// dkv_kernel_mma and f32 runs dq_kernel / dkv_kernel, as before.
//
// Replaces the TPU kernels alphafold2_tpu/ops/pallas/axial.py `_run_dq`
// (:268, pallas_call :275, body `_dq_kernel` :123) and `_run_dkv` (:306,
// pallas_call :313, body `_dkv_kernel` :166). With the forward's lse and
// dsum = rowsum(dO * O):
//
//     p  = exp(sm_scale * q.k - lse)   (0: masked key, dead query row)
//     ds = p * (dO.v - dsum)
//     K3a  dq = sm_scale * ds K          dq_kernel_sm90: a block owns 64 queries
//     K3b  dv = p^T dO                   dkv_kernel_sm90: a block owns 64 keys
//          dk = sm_scale * ds^T Q
//
// The design:
//
// * Block: one consumer warpgroup (64 rows) and one producer warp, 160
//   threads; at head dim 32 and 64 two blocks share an SM (their wgmma and
//   their exp work interleave), at 128 one. No setmaxnreg: the producer is a
//   single warp, not a warpgroup, so the register split cannot apply; the
//   budget is 65536 / (160 x blocks an SM) registers a thread. Tiles are
//   64 rows on both sides: S and dP of a 64 x 64 tile pair take 32
//   registers each, so K3b's four live accumulators (S^T, dP^T, dk, dv)
//   fit two blocks an SM at head dim 64 (168 registers); 128-row streamed
//   tiles would double S and dP and leave one block an SM.
// * Resident: the block's own 64 rows of Q and dO (K3a) or K and V (K3b),
//   loaded once by TMA. Streamed: K and V (K3a) or Q and dO with their lse
//   and dsum slices (K3b), 64 rows a tile, through a ring of kStages (3 at
//   head dim <= 64, 2 at 128) with full and empty mbarriers, kept in flight
//   by the producer. Tensor maps are 4-D over the callers' strided (B, H,
//   N, D) views (the projection outputs as given), encoded on the host per
//   call; tiles land in 64-column chunks swizzled at 128 bytes (a D-64 bf16
//   row fills one span exactly), 64 bytes at head dim 32. Tails past N are
//   zero-filled by TMA.
// * The producer ballots each tile's valid keys (K3a) or live queries (K3b:
//   in the mask, lse < inf, in range) into two 32-bit words. A tile with
//   none is never staged: it would add exactly 0. A staged K3a tile carries
//   its words, which mask the logits; a staged K3b tile carries its
//   queries' liveness in its lse slice instead (+inf for a dead query). A
//   block whose own 64 rows are all dead streams nothing and writes 0.
// * Products: S = Q K^T and dP = dO V^T (K3a), or S^T = K Q^T and dP^T =
//   V dO^T (K3b, so p^T and ds^T come out key-major), each a run of wgmma
//   m64n64k16 with both operands in shared memory (K-major). p = 2^(s *
//   scale*log2(e) - lse*log2(e)) and ds stay in registers; a dead query
//   carries lse = +inf, so its p is exactly 0 without a select. K3b reads
//   each column's lse and dsum from the stage's slice (float2 per lane pair
//   of columns). p and ds are rounded to bf16 into wgmma A fragments (the
//   accumulator layout of S is the A layout of the next product), as
//   `_dkv_kernel` rounds them (axial.py:199, :207), and the second products
//   dq += ds K, dv += p^T dO, dk += ds^T Q read K, dO and Q transposed
//   (MN-major) through their descriptors: no transposed copy exists.
// * Split: where the grid leaves the 132 SMs short of two waves,
//   ops/cuda/axial.py grad_splits() cuts the streamed axis into S
//   contiguous ranges of whole 64-row tiles (the plan takes S as given).
//   Each block then writes its f32 partials, unscaled, to scratch the
//   wrapper allocates, and grad_merge_kernel adds the S partials in split
//   order, applies sm_scale (dq, dk), rounds to bf16 and writes through the
//   caller's strides. No atomics: two runs give the same bits.
// * Deadlocks cannot hang the card: every mbarrier wait traps after
//   kSpinLimit polls (sm90_ptx.cuh).

#pragma once

#include "sm90_ptx.cuh"

namespace af2 {
namespace sm90 {
namespace grad {

constexpr int kRows = 64;       // rows of every tile, resident or streamed
constexpr int kThreads = 160;   // one consumer warpgroup and one producer warp
constexpr int kMaskWords = kRows / 32;
constexpr int kMaxStages = 3;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
  static constexpr int CW = D < 64 ? D : 64;    // columns of one swizzled chunk
  static constexpr int NCH = D / CW;            // chunks per row
  static constexpr int SWB = CW * 2;            // bytes per chunk row = swizzle span
  static constexpr int kChunk = kRows * SWB;    // one 64-row chunk
  static constexpr int kTile = NCH * kChunk;    // one 64 x D bf16 tile
  static constexpr int kStages = D <= 64 ? 3 : 2;
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;  // blocks an SM
};

struct Control {
  uint64_t full[kMaxStages];
  uint64_t empty[kMaxStages];
  uint64_t resbar;  // the resident tiles
  // K3b: each streamed query's lse * log2(e) (+inf when dead) and dsum (0)
  alignas(16) float lse[kMaxStages][kRows];
  alignas(16) float dsum[kMaxStages][kRows];
  uint32_t mask[kMaxStages][kMaskWords];  // K3a: the staged tile's valid keys
  int tile[kMaxStages];  // first row of the staged tile, -1 ends the stream
};

template <int D>
constexpr int smem_bytes() {
  return 1024 + (2 + 2 * Cfg<D>::kStages) * Cfg<D>::kTile + (int)sizeof(Control);
}

struct GradParams {
  const float* lse;   // (B, H, Nq) f32 from the forward; +inf: no valid key
  const float* dsum;  // (B, H, Nq) f32 rowsum(dO * O)
  const unsigned char* q_mask;   // (B, Nq) 0/1, or null
  const unsigned char* kv_mask;  // (B, Nk) 0/1, or null
  void* out0;   // bf16 dq (K3a) or dk (K3b) through o0 strides; unused with splits
  void* out1;   // bf16 dv (K3b) through o1 strides; unused with splits
  float* part;  // splits > 1: f32 partials (outs, splits, B * H * rows, D), or null
  long long o0b, o0h, o0n, o1b, o1h, o1n;
  int batch, heads, nq, nk;
  int tiles;       // 64-row tiles of the block's own axis (queries K3a, keys K3b)
  int long_tiles;  // 64-row tiles of the streamed axis
  int splits;
  float sm_scale;
  float scale_log2;  // sm_scale * log2(e)
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The lse of query row n in log2 units, +inf where the row takes no part in
// the backward: past Nq, masked, or with no valid key (lse = +inf).
__device__ __forceinline__ float live_lse2(const GradParams& p, int b, int bh, int n) {
  if (n >= p.nq) return CUDART_INF_F;
  if (p.q_mask != nullptr && p.q_mask[(long long)b * p.nq + n] == 0) return CUDART_INF_F;
  const float l = p.lse[(long long)bh * p.nq + n];
  return l < CUDART_INF_F ? l * kLog2e : CUDART_INF_F;
}

__device__ __forceinline__ bool key_live(const GradParams& p, int b, int n) {
  return n < p.nk && (p.kv_mask == nullptr || p.kv_mask[(long long)b * p.nk + n] != 0);
}

// Output o's f32 partial of split `split` for row n of (batch * head) bh.
template <int D>
__device__ __forceinline__ float* partial_row(const GradParams& p, int o, int split, int bh,
                                              int n, int n_rows) {
  const long long rows = (long long)p.batch * p.heads * n_rows;
  return p.part + ((long long)(o * p.splits + split) * rows + (long long)bh * n_rows + n) * D;
}

__device__ __forceinline__ __nv_bfloat16* out_row(const GradParams& p, int o, int b, int h,
                                                  int n) {
  return o == 0 ? static_cast<__nv_bfloat16*>(p.out0) + (long long)b * p.o0b +
                      (long long)h * p.o0h + (long long)n * p.o0n
                : static_cast<__nv_bfloat16*>(p.out1) + (long long)b * p.o1b +
                      (long long)h * p.o1h + (long long)n * p.o1n;
}

// A block whose own 64 rows (from r0) are all dead: zeros for each of its
// `outs` outputs, as bf16 rows or as the split's f32 partial.
template <int D>
__device__ __forceinline__ void zero_rows(const GradParams& p, int outs, int b, int h, int bh,
                                          int r0, int n_rows, int split) {
  for (int o = 0; o < outs; ++o) {
    if (p.part != nullptr) {
      for (int e = threadIdx.x; e < kRows * (D / 4); e += kThreads) {
        const int n = r0 + e / (D / 4);
        if (n < n_rows)
          reinterpret_cast<float4*>(partial_row<D>(p, o, split, bh, n, n_rows))[e % (D / 4)] =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int e = threadIdx.x; e < kRows * (D / 8); e += kThreads) {
        const int n = r0 + e / (D / 8);
        if (n < n_rows)
          reinterpret_cast<uint4*>(out_row(p, o, b, h, n))[e % (D / 8)] = make_uint4(0, 0, 0, 0);
      }
    }
  }
}

// One thread's rows (lrow, lrow + 8 of the block's 64 from r0) of output o:
// acc[c][4j + 2r + e] is (row lrow + 8r, column c*CW + 8j + 2t + e). As
// bf16 times `scale` through the strides, or as the split's f32 partial.
template <int D>
__device__ __forceinline__ void store_rows(const GradParams& p, int o,
                                           const float (&acc)[Cfg<D>::NCH][Cfg<D>::CW / 2],
                                           float scale, int b, int h, int bh, int r0, int lrow,
                                           int t, int n_rows, int split) {
  using C = Cfg<D>;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = r0 + lrow + 8 * r;
    if (n >= n_rows) continue;
    if (p.part != nullptr) {
      float* dst = partial_row<D>(p, o, split, bh, n, n_rows);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c)
#pragma unroll
        for (int j = 0; j < C::CW / 8; ++j)
          *reinterpret_cast<float2*>(dst + c * C::CW + 8 * j + 2 * t) =
              make_float2(acc[c][4 * j + 2 * r], acc[c][4 * j + 2 * r + 1]);
    } else {
      __nv_bfloat16* dst = out_row(p, o, b, h, n);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c)
#pragma unroll
        for (int j = 0; j < C::CW / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + c * C::CW + 8 * j + 2 * t) =
              pack_bf16(acc[c][4 * j + 2 * r] * scale, acc[c][4 * j + 2 * r + 1] * scale);
    }
  }
}

// The A fragment of keys (K3a) or queries (K3b) 16kk .. 16kk + 15 of an
// m64n64 accumulator, rounded to bf16.
__device__ __forceinline__ void a_frag16(uint32_t (&a)[4], const float (&x)[32], int kk) {
  a[0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
  a[1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}

// x = a b^T over the head dim for one 64 x 64 tile pair: a and b are 64-row
// K-major tiles at shared addresses a_addr, b_addr.
template <int D>
__device__ __forceinline__ void tile_product(float (&x)[32], uint32_t a_addr, uint32_t b_addr) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 / C::CW, off = (kk * 16 % C::CW) * 2;
    wgmma_ss<64>(x, kmajor_desc<C::SWB>(a_addr + c * C::kChunk + off),
                 kmajor_desc<C::SWB>(b_addr + c * C::kChunk + off), kk > 0);
  }
}

// acc += a(64 x 64, registers) . tile (64 rows x D, read MN-major).
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[Cfg<D>::NCH][Cfg<D>::CW / 2],
                                           const uint32_t (&a)[4], uint32_t tile_addr, int kk) {
  using C = Cfg<D>;
#pragma unroll
  for (int c = 0; c < C::NCH; ++c)
    wgmma_rs<C::CW>(acc[c], a, mnmajor_desc<C::SWB>(tile_addr + c * C::kChunk + kk * 16 * C::SWB),
                    1);
}

// ---------------------------------------------------------------- K3a

// ds of one staged key tile, in place of s: row r of this thread is lse2[r]
// and dsum[r]; key 8j + 2t + e is bit 8(j % 4) + e of mw[j / 4] (the tile's
// mask words shifted by 2t). kMasked: the tile holds masked keys.
template <bool kMasked>
__device__ __forceinline__ void ds_rows(float (&s)[32], const float (&dp)[32],
                                        const uint32_t (&mw)[kMaskWords], float scale_log2,
                                        const float (&lse2)[2], const float (&dsum)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        float pr = ex2(fmaf(s[i], scale_log2, -lse2[r]));
        if (kMasked && !((mw[j / 4] >> (8 * (j % 4) + e)) & 1u)) pr = 0.f;
        s[i] = pr * (dp[i] - dsum[r]);
      }
}

template <int D>
__device__ __forceinline__ void producer_dq(const CUtensorMap* tq, const CUtensorMap* tdo,
                                            const CUtensorMap* tk, const CUtensorMap* tv,
                                            const GradParams& p, unsigned char* res,
                                            unsigned char* ring, Control& ctl, int b, int h,
                                            int q0, int t_begin, int t_end) {
  using C = Cfg<D>;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_arrive_expect_tx(&ctl.resbar, 2 * C::kTile);
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) {
      tma_load_4d(res + c * C::kChunk, tq, &ctl.resbar, c * C::CW, q0, h, b);
      tma_load_4d(res + C::kTile + c * C::kChunk, tdo, &ctl.resbar, c * C::CW, q0, h, b);
    }
  }
  int it = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kRows;
    const uint32_t w0 = __ballot_sync(0xffffffffu, key_live(p, b, k0 + lane));
    const uint32_t w1 = __ballot_sync(0xffffffffu, key_live(p, b, k0 + 32 + lane));
    if ((w0 | w1) == 0) continue;  // no valid key: the tile adds nothing
    const int st = it % C::kStages;
    mbar_wait(&ctl.empty[st], ((it / C::kStages) & 1) ^ 1);
    unsigned char* ks = ring + st * 2 * C::kTile;
    if (lane == 0) {
      ctl.mask[st][0] = w0;
      ctl.mask[st][1] = w1;
      ctl.tile[st] = k0;
      mbar_arrive_expect_tx(&ctl.full[st], 2 * C::kTile);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
        tma_load_4d(ks + c * C::kChunk, tk, &ctl.full[st], c * C::CW, k0, h, b);
        tma_load_4d(ks + C::kTile + c * C::kChunk, tv, &ctl.full[st], c * C::CW, k0, h, b);
      }
    } else {
      mbar_arrive(&ctl.full[st]);
    }
    ++it;
  }
  const int st = it % C::kStages;  // the end of the stream
  mbar_wait(&ctl.empty[st], ((it / C::kStages) & 1) ^ 1);
  if (lane == 0) ctl.tile[st] = -1;
  mbar_arrive(&ctl.full[st]);
}

template <int D>
__device__ __forceinline__ void consumer_dq(const GradParams& p, unsigned char* res,
                                            unsigned char* ring, Control& ctl, int b, int h,
                                            int bh, int q0, int split) {
  using C = Cfg<D>;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int lrow = 16 * (threadIdx.x >> 5) + (lane >> 2);  // rows lrow, lrow + 8
  float lse2[2], dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + lrow + 8 * r;
    lse2[r] = live_lse2(p, b, bh, n);
    dsum[r] = lse2[r] < CUDART_INF_F ? p.dsum[(long long)bh * p.nq + n] : 0.f;
  }
  float dq[C::NCH][C::CW / 2];
#pragma unroll
  for (int c = 0; c < C::NCH; ++c)
#pragma unroll
    for (int i = 0; i < C::CW / 2; ++i) dq[c][i] = 0.f;

  const uint32_t qaddr = smem_u32(res), doaddr = qaddr + C::kTile;
  mbar_wait(&ctl.resbar, 0);
  for (int it = 0;; ++it) {
    const int st = it % C::kStages;
    mbar_wait(&ctl.full[st], (it / C::kStages) & 1);
    if (__shfl_sync(0xffffffffu, ctl.tile[st], 0) < 0) break;  // uniform, as `role`
    const uint32_t kaddr = smem_u32(ring + st * 2 * C::kTile), vaddr = kaddr + C::kTile;

    float s[32], dp[32];  // [4j + 2r + e]: row lrow + 8r, key 8j + 2t + e
    wgmma_fence();
    tile_product<D>(s, qaddr, kaddr);
    tile_product<D>(dp, doaddr, vaddr);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);
    fence_operands(dp);

    const uint32_t m0 = ctl.mask[st][0], m1 = ctl.mask[st][1];
    const uint32_t mw[kMaskWords] = {m0 >> (2 * t), m1 >> (2 * t)};
    if (__shfl_sync(0xffffffffu, (m0 & m1) == ~0u, 0))
      ds_rows<false>(s, dp, mw, p.scale_log2, lse2, dsum);
    else
      ds_rows<true>(s, dp, mw, p.scale_log2, lse2, dsum);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t a[4];
      a_frag16(a, s, kk);
      accumulate<D>(dq, a, kaddr, kk);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) fence_operands(dq[c]);
    mbar_arrive(&ctl.empty[st]);
  }
  store_rows<D>(p, 0, dq, p.sm_scale, b, h, bh, q0, lrow, t, p.nq, split);
}

// One block per (batch * head, 64-query tile, key split); the splits of one
// query tile are adjacent blocks.
template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
    dq_kernel_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const GradParams p) {
  using C = Cfg<D>;
  extern __shared__ unsigned char grad_smem[];
  unsigned char* res = align1024(grad_smem);  // Q, then dO
  unsigned char* ring = res + 2 * C::kTile;   // stages of K, then V
  Control& ctl = *reinterpret_cast<Control*>(ring + 2 * C::kStages * C::kTile);

  long long blk = blockIdx.x;
  const int split = (int)(blk % p.splits);
  blk /= p.splits;
  const int qt = (int)(blk % p.tiles);
  const int bh = (int)(blk / p.tiles);
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = qt * kRows;

  const bool live = threadIdx.x < kRows && live_lse2(p, b, bh, q0 + (int)threadIdx.x) <
                                               CUDART_INF_F;
  if (!__syncthreads_or(live)) {  // every query row dead: dq = 0, no key read
    zero_rows<D>(p, 1, b, h, bh, q0, p.nq, split);
    return;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&ctl.full[s], 32);    // the producer warp
      mbar_init(&ctl.empty[s], 128);  // every consumer thread
    }
    mbar_init(&ctl.resbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role, broadcast from lane 0 so that ptxas sees the branch as
  // warp-uniform (a branch it cannot prove uniform serialises every wgmma)
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == 1) {
    const int t_begin = (int)((long long)split * p.long_tiles / p.splits);
    const int t_end = (int)((long long)(split + 1) * p.long_tiles / p.splits);
    producer_dq<D>(&tq, &tdo, &tk, &tv, p, res, ring, ctl, b, h, q0, t_begin, t_end);
  } else {
    consumer_dq<D>(p, res, ring, ctl, b, h, bh, q0, split);
  }
}

// ---------------------------------------------------------------- K3b

template <int D>
__device__ __forceinline__ void producer_dkv(const CUtensorMap* tq, const CUtensorMap* tdo,
                                             const CUtensorMap* tk, const CUtensorMap* tv,
                                             const GradParams& p, unsigned char* res,
                                             unsigned char* ring, Control& ctl, int b, int h,
                                             int bh, int k0, int t_begin, int t_end) {
  using C = Cfg<D>;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_arrive_expect_tx(&ctl.resbar, 2 * C::kTile);
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) {
      tma_load_4d(res + c * C::kChunk, tk, &ctl.resbar, c * C::CW, k0, h, b);
      tma_load_4d(res + C::kTile + c * C::kChunk, tv, &ctl.resbar, c * C::CW, k0, h, b);
    }
  }
  int it = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int q0 = t * kRows;
    const float l0 = live_lse2(p, b, bh, q0 + lane), l1 = live_lse2(p, b, bh, q0 + 32 + lane);
    const uint32_t w0 = __ballot_sync(0xffffffffu, l0 < CUDART_INF_F);
    const uint32_t w1 = __ballot_sync(0xffffffffu, l1 < CUDART_INF_F);
    if ((w0 | w1) == 0) continue;  // no live query: the tile adds nothing
    const float* dsum = p.dsum + (long long)bh * p.nq + q0;
    const float d0 = l0 < CUDART_INF_F ? dsum[lane] : 0.f;
    const float d1 = l1 < CUDART_INF_F ? dsum[32 + lane] : 0.f;
    const int st = it % C::kStages;
    mbar_wait(&ctl.empty[st], ((it / C::kStages) & 1) ^ 1);
    ctl.lse[st][lane] = l0;
    ctl.lse[st][32 + lane] = l1;
    ctl.dsum[st][lane] = d0;
    ctl.dsum[st][32 + lane] = d1;
    unsigned char* qs = ring + st * 2 * C::kTile;
    if (lane == 0) {
      ctl.tile[st] = q0;
      mbar_arrive_expect_tx(&ctl.full[st], 2 * C::kTile);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
        tma_load_4d(qs + c * C::kChunk, tq, &ctl.full[st], c * C::CW, q0, h, b);
        tma_load_4d(qs + C::kTile + c * C::kChunk, tdo, &ctl.full[st], c * C::CW, q0, h, b);
      }
    } else {
      mbar_arrive(&ctl.full[st]);
    }
    ++it;
  }
  const int st = it % C::kStages;  // the end of the stream
  mbar_wait(&ctl.empty[st], ((it / C::kStages) & 1) ^ 1);
  if (lane == 0) ctl.tile[st] = -1;
  mbar_arrive(&ctl.full[st]);
}

template <int D>
__device__ __forceinline__ void consumer_dkv(const GradParams& p, unsigned char* res,
                                             unsigned char* ring, Control& ctl, int b, int h,
                                             int bh, int k0, int split) {
  using C = Cfg<D>;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int lrow = 16 * (threadIdx.x >> 5) + (lane >> 2);  // key rows lrow, lrow + 8
  const bool kv[2] = {key_live(p, b, k0 + lrow), key_live(p, b, k0 + lrow + 8)};
  float dk[C::NCH][C::CW / 2], dv[C::NCH][C::CW / 2];
#pragma unroll
  for (int c = 0; c < C::NCH; ++c)
#pragma unroll
    for (int i = 0; i < C::CW / 2; ++i) dk[c][i] = dv[c][i] = 0.f;

  const uint32_t kaddr = smem_u32(res), vaddr = kaddr + C::kTile;
  mbar_wait(&ctl.resbar, 0);
  for (int it = 0;; ++it) {
    const int st = it % C::kStages;
    mbar_wait(&ctl.full[st], (it / C::kStages) & 1);
    if (__shfl_sync(0xffffffffu, ctl.tile[st], 0) < 0) break;  // uniform, as `role`
    const uint32_t qaddr = smem_u32(ring + st * 2 * C::kTile), doaddr = qaddr + C::kTile;

    float s[32], dp[32];  // [4j + 2r + e]: key row lrow + 8r, query 8j + 2t + e
    wgmma_fence();
    tile_product<D>(s, kaddr, qaddr);
    tile_product<D>(dp, vaddr, doaddr);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);
    fence_operands(dp);

    // p^T in s, ds^T in dp; a dead query column has lse2 = +inf (p = 0)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(&ctl.lse[st][8 * j + 2 * t]);
      const float2 d2 = *reinterpret_cast<const float2*>(&ctl.dsum[st][8 * j + 2 * t]);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          float pr = ex2(fmaf(s[i], p.scale_log2, -(e ? l2.y : l2.x)));
          if (!kv[r]) pr = 0.f;
          s[i] = pr;
          dp[i] = pr * (dp[i] - (e ? d2.y : d2.x));
        }
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t ap[4], ad[4];
      a_frag16(ap, s, kk);
      a_frag16(ad, dp, kk);
      accumulate<D>(dv, ap, doaddr, kk);
      accumulate<D>(dk, ad, qaddr, kk);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) {
      fence_operands(dk[c]);
      fence_operands(dv[c]);
    }
    mbar_arrive(&ctl.empty[st]);
  }
  store_rows<D>(p, 0, dk, p.sm_scale, b, h, bh, k0, lrow, t, p.nk, split);
  store_rows<D>(p, 1, dv, 1.f, b, h, bh, k0, lrow, t, p.nk, split);
}

// One block per (batch * head, 64-key tile, query split); the splits of one
// key tile are adjacent blocks.
template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
    dkv_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const GradParams p) {
  using C = Cfg<D>;
  extern __shared__ unsigned char grad_smem[];
  unsigned char* res = align1024(grad_smem);  // K, then V
  unsigned char* ring = res + 2 * C::kTile;   // stages of Q, then dO
  Control& ctl = *reinterpret_cast<Control*>(ring + 2 * C::kStages * C::kTile);

  long long blk = blockIdx.x;
  const int split = (int)(blk % p.splits);
  blk /= p.splits;
  const int kt = (int)(blk % p.tiles);
  const int bh = (int)(blk / p.tiles);
  const int b = bh / p.heads, h = bh % p.heads;
  const int k0 = kt * kRows;

  const bool live = threadIdx.x < kRows && key_live(p, b, k0 + (int)threadIdx.x);
  if (!__syncthreads_or(live)) {  // every key masked: dk = dv = 0, no query read
    zero_rows<D>(p, 2, b, h, bh, k0, p.nk, split);
    return;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&ctl.full[s], 32);
      mbar_init(&ctl.empty[s], 128);
    }
    mbar_init(&ctl.resbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == 1) {
    const int t_begin = (int)((long long)split * p.long_tiles / p.splits);
    const int t_end = (int)((long long)(split + 1) * p.long_tiles / p.splits);
    producer_dkv<D>(&tq, &tdo, &tk, &tv, p, res, ring, ctl, b, h, bh, k0, t_begin, t_end);
  } else {
    consumer_dkv<D>(p, res, ring, ctl, b, h, bh, k0, split);
  }
}

// ---------------------------------------------------------------- merge

struct MergeParams {
  const float* part;  // (outs, splits, batch * heads * n, D) f32
  void* out0;         // bf16 (B, H, N, D) through os0 strides
  void* out1;         // bf16, the second output (outs = 2), or null
  long long os0[3], os1[3];
  float scale0, scale1;
  int outs, batch, heads, n, splits;
};

// The merge: each row's partials added in split order, times the output's
// scale, rounded to bf16. D / 8 threads a row, 8 features (one 16-byte
// store) each.
template <int D>
__global__ void __launch_bounds__(128) grad_merge_kernel(const MergeParams p) {
  constexpr int TPR = D / 8, RPB = 128 / TPR;
  const long long rows = (long long)p.batch * p.heads * p.n;
  long long row = (long long)blockIdx.x * RPB + threadIdx.x / TPR;
  if (row >= p.outs * rows) return;
  const int o = row >= rows ? 1 : 0;
  row -= o * rows;
  const int c0 = (threadIdx.x % TPR) * 8;
  const float* src = p.part + ((long long)o * p.splits * rows + row) * D + c0;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < p.splits; ++s) {
    const float4* x = reinterpret_cast<const float4*>(src + (long long)s * rows * D);
    const float4 lo = x[0], hi = x[1];
    acc[0] += lo.x; acc[1] += lo.y; acc[2] += lo.z; acc[3] += lo.w;
    acc[4] += hi.x; acc[5] += hi.y; acc[6] += hi.z; acc[7] += hi.w;
  }
  const float scale = o ? p.scale1 : p.scale0;
  uint4 v;
  v.x = pack_bf16(acc[0] * scale, acc[1] * scale);
  v.y = pack_bf16(acc[2] * scale, acc[3] * scale);
  v.z = pack_bf16(acc[4] * scale, acc[5] * scale);
  v.w = pack_bf16(acc[6] * scale, acc[7] * scale);
  const int nn = (int)(row % p.n);
  const int bh = (int)(row / p.n);
  const int b = bh / p.heads, h = bh % p.heads;
  // each stride picked by value: indexing a parameter array with a runtime
  // value would copy the parameters to the stack
  const long long sb = o ? p.os1[0] : p.os0[0], sh = o ? p.os1[1] : p.os0[1],
                  sn = o ? p.os1[2] : p.os0[2];
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(o ? p.out1 : p.out0);
  *reinterpret_cast<uint4*>(out + (long long)b * sb + (long long)h * sh + (long long)nn * sn +
                            c0) = v;
}

// ---------------------------------------------------------------- host

// One backward problem as fused_attention_bwd.cu receives it.
struct GradOperands {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* dsum;
  const unsigned char* q_mask;
  const unsigned char* kv_mask;
  void* out0;  // dq | dk
  void* out1;  // -  | dv
  Operand qs, ks, vs, dos, o0s, o1s;
  int batch, heads, nq, nk;
  float sm_scale;
};

// Can TMA (and the 16-byte epilogue stores) address every operand the
// kernel reads or writes? The head dim is the caller's test.
__host__ inline bool takes(const GradOperands& a, bool dkv) {
  const int rows = dkv ? a.nk : a.nq;
  return tma_operand(a.q, a.qs, a.batch, a.heads, a.nq) &&
         tma_operand(a.k, a.ks, a.batch, a.heads, a.nk) &&
         tma_operand(a.v, a.vs, a.batch, a.heads, a.nk) &&
         tma_operand(a.dout, a.dos, a.batch, a.heads, a.nq) &&
         tma_operand(a.out0, a.o0s, a.batch, a.heads, rows) &&
         (!dkv || tma_operand(a.out1, a.o1s, a.batch, a.heads, rows));
}

template <int D>
__host__ inline Af2LaunchPlan plan_grad(bool dkv, int batch, int heads, int nq, int nk,
                                        int splits) {
  Af2LaunchPlan plan{};
  const int rows = dkv ? nk : nq;
  plan.blocks = (long long)batch * heads * ((rows + kRows - 1) / kRows) * splits;
  plan.threads = kThreads;
  plan.dynamic_smem = smem_bytes<D>();
  name_kernel(plan, dkv ? "dkv_kernel_sm90<%d>" : "dq_kernel_sm90<%d>", D);
  return plan;
}

template <int D>
__host__ inline Af2LaunchPlan plan_merge(int outs, int batch, int heads, int n) {
  constexpr int rows_per_block = 128 / (D / 8);
  Af2LaunchPlan plan{};
  plan.blocks = ((long long)outs * batch * heads * n + rows_per_block - 1) / rows_per_block;
  plan.threads = 128;
  plan.dynamic_smem = 0;
  name_kernel(plan, "grad_merge_kernel<%d>", D);
  return plan;
}

// Launches dq_kernel_sm90 or dkv_kernel_sm90; with splits > 1 each block
// writes its partials into `part` ((1 or 2) * splits * B*H*rows * D
// floats) and grad_merge_kernel must follow.
template <int D>
__host__ inline cudaError_t launch_grad(bool dkv, const GradOperands& a, int splits, float* part,
                                        cudaStream_t stream) {
  const Af2LaunchPlan plan = plan_grad<D>(dkv, a.batch, a.heads, a.nq, a.nk, splits);
  if (!grid_fits(plan) || splits < 1 || (splits > 1 && part == nullptr))
    return cudaErrorInvalidConfiguration;
  CUtensorMap tq, tdo, tk, tv;
  if (!encode_bf16(&tq, a.q, a.qs, a.batch, a.heads, a.nq, D, kRows) ||
      !encode_bf16(&tdo, a.dout, a.dos, a.batch, a.heads, a.nq, D, kRows) ||
      !encode_bf16(&tk, a.k, a.ks, a.batch, a.heads, a.nk, D, kRows) ||
      !encode_bf16(&tv, a.v, a.vs, a.batch, a.heads, a.nk, D, kRows))
    return cudaErrorInvalidValue;
  GradParams p;
  p.lse = a.lse;
  p.dsum = a.dsum;
  p.q_mask = a.q_mask;
  p.kv_mask = a.kv_mask;
  p.out0 = a.out0;
  p.out1 = a.out1;
  p.part = splits > 1 ? part : nullptr;
  p.o0b = a.o0s.sb;
  p.o0h = a.o0s.sh;
  p.o0n = a.o0s.sn;
  p.o1b = a.o1s.sb;
  p.o1h = a.o1s.sh;
  p.o1n = a.o1s.sn;
  p.batch = a.batch;
  p.heads = a.heads;
  p.nq = a.nq;
  p.nk = a.nk;
  p.tiles = ((dkv ? a.nk : a.nq) + kRows - 1) / kRows;
  p.long_tiles = ((dkv ? a.nq : a.nk) + kRows - 1) / kRows;
  p.splits = splits;
  p.sm_scale = a.sm_scale;
  p.scale_log2 = a.sm_scale * kLog2e;
  const unsigned blocks = (unsigned)plan.blocks;
  const int smem = plan.dynamic_smem;
  cudaError_t err;
  if (dkv) {
    err = cudaFuncSetAttribute(dkv_kernel_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    dkv_kernel_sm90<D><<<blocks, kThreads, smem, stream>>>(tq, tdo, tk, tv, p);
  } else {
    err = cudaFuncSetAttribute(dq_kernel_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    dq_kernel_sm90<D><<<blocks, kThreads, smem, stream>>>(tq, tdo, tk, tv, p);
  }
  return cudaGetLastError();
}

template <int D>
__host__ inline cudaError_t launch_merge(const MergeParams& m, cudaStream_t stream) {
  const Af2LaunchPlan plan = plan_merge<D>(m.outs, m.batch, m.heads, m.n);
  if (!grid_fits(plan)) return cudaErrorInvalidConfiguration;
  grad_merge_kernel<D><<<(unsigned)plan.blocks, plan.threads, 0, stream>>>(m);
  return cudaGetLastError();
}

}  // namespace grad
}  // namespace sm90
}  // namespace af2
