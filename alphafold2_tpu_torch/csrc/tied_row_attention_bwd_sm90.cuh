// K2's bf16 backward redesigned for Hopper (sm_90a): S and dO.V^T computed
// once per 64-row tile pair over the whole fused R*D axis, from TMA-fed
// (B, R, N, H, D) boxes, with wgmma. Included by tied_row_attention_bwd.cu,
// whose plan routes here every bf16 problem at row width 32, 64 or 128
// whose operands TMA can describe and whose resident tile pair and one
// streamed pair fit shared memory (R*D <= 448 at row width 64); wider bf16
// problems at those row widths take the wide route (tied_row_wide_sm90.cuh),
// every other problem chunked_dq_kernel_mma / chunked_dkv_kernel_mma (bf16)
// and chunked_dq_kernel / chunked_dkv_kernel (f32).
//
// Replaces, on the tied-row route, alphafold2_tpu/ops/pallas/axial.py
// `_run_dq` (:268, pallas_call :275) and `_run_dkv` (:306, pallas_call :313)
// as ops/pallas/tied_row.py `tied_row_attention` (:53) reaches them under
// jax.grad (head dim R*D on folded operands). With s = sm_scale * tie[b],
// the forward's lse and dsum = tied_row_dsum(out, dO):
//
//     p  = exp(s * Q'K'^T - lse)    (0: masked key, dead query row)
//     ds = p o (dO'V'^T - dsum)
//     dq = s * ds K'                tied_dq_kernel_sm90: a block owns 64 queries
//     dk = s * ds^T Q'              tied_dkv_kernel_sm90: a block owns 64 keys
//     dv = p^T dO'
//
// over the fused (r, d) axis, in place: element (b, h, n, r*D + d) of an
// operand lives at b*sb + h*sh + n*sn + r*sr + d. The same map describes
// K1's (B, H, N, D) view at a head dim past 128 as R = D/64 rows of 64
// features (sr = 64, tie 1), so K3a/K3b take these kernels there too.
//
// The design, K2's forward (tied_row_attention_sm90.cuh) on K3's consumers
// (fused_attention_bwd_sm90.cuh):
//
// * Operands are read through 5-D tensor maps over the callers' strides:
//   dims {D, H, N, R, B}, box {CW, 1, 64, R, 1} (CW = min(D, 64) columns,
//   128-byte swizzled at CW 64, 64-byte at 32; row width 128 takes two
//   boxes along D). One copy lands a 64-token tile as R K-major chunks of 64
//   x CW, the layout in which wgmma contracts the fused axis.
// * Block: one consumer warpgroup (the 64 rows) and one producer warp, 160
//   threads. Resident: the block's Q and dO tiles (dq) or K and V tiles
//   (dk/dv) over all R rows, one TMA wait. Streamed: K and V (dq) or Q and
//   dO with their lse and dsum slices (dk/dv), 64 rows over all R rows a
//   stage, through a ring of one or two stages with full and empty
//   mbarriers, kept full by the producer. A stage carries its keys'
//   validity words (dq) or its queries' liveness in the lse slice (+inf for
//   a dead query, so its p is exactly 0); a tile with no valid key (no live
//   query) is never staged.
// * S and dP (dq: Q K^T and dO V^T; dk/dv: K Q^T and V dO^T, key-major) are
//   each one wgmma m64n64k16 chain of R*D / 16 k-steps, once per streamed
//   tile within a column group. p and ds follow K3's ds_rows / dkv_cols in
//   log2 units, the tie scale multiplied into the f32 scale. They are
//   rounded to bf16 into A fragments, and the second products read the
//   block's output columns MN-major from the staged tile: dq[:, cols] +=
//   ds K[:, cols]; dv[:, cols] += p^T dO[:, cols]; dk[:, cols] += ds^T
//   Q[:, cols]. No transposed copy exists.
// * Column groups: a block covers C of the R*D output columns (CW-wide
//   chunks; the last group repeats the last chunk where R*D is not a
//   multiple of C, and does not store it), and G = ceil(R*D / C) blocks
//   share a row tile, each recomputing S and dP. dk/dv holds four
//   accumulators (S^T, dP^T, dk, dv), so C = 64 there, as K3b at head dim
//   64; dq holds three, so C = 128 fits (as K3a at head dim 128) and the
//   plan takes it where the grid then fills a wave of 132 SMs, else C = 64
//   (more blocks for a grid short of a wave: the tied training pass gets 40
//   blocks of each kernel, G = 5). S or dS is not handed over between
//   warpgroups: these grids leave SMs idle, so a second block recomputing
//   S costs less than two barriers a tile.
// * Shared memory sets the reach: the resident pair and one streamed pair
//   take 4 * 64 * R*D bytes (160 KB at R*D 320, one block an SM); two
//   stages fit up to R*D 288 (head dim 256: two). R*D 512 (JAX's gate
//   shape) does not fit one stage and takes the wide route.
// * No atomics: each output element is summed by one thread of one block,
//   in key (query) order, so two runs give the same bits. A block whose own
//   64 rows are all dead writes zeros and reads nothing. Every mbarrier wait
//   traps after kSpinLimit polls (sm90_ptx.cuh).

#pragma once

#include "fused_attention_bwd_sm90.cuh"

namespace af2 {
namespace sm90 {
namespace tied_grad {

constexpr int kRows = 64;  // rows of every tile, resident or streamed
constexpr int kMaxStages = 2;
constexpr int kThreads = 128 + 32;  // one consumer warpgroup, one producer warp
constexpr int kSMs = 132;           // the H100 SXM's: the plan's wave
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may take
constexpr int kControlBytes = 1152;  // the ring's control block, rounded up
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static_assert(D == 32 || D == 64 || D == 128, "row width 32, 64 or 128");
  static constexpr int CW = D < 64 ? D : 64;  // columns of one swizzled chunk
  static constexpr int NDC = D / CW;          // chunks along one row's width
  static constexpr int SWB = CW * 2;          // bytes per chunk row = swizzle span
  static constexpr int kChunk = kRows * SWB;  // bytes of one 64-row chunk
};

struct Control {
  uint64_t full[kMaxStages];
  uint64_t empty[kMaxStages];
  uint64_t resbar;  // the resident tiles
  // dk/dv: each streamed query's lse * log2(e) (+inf when dead) and dsum (0)
  alignas(16) float lse[kMaxStages][kRows];
  alignas(16) float dsum[kMaxStages][kRows];
  uint32_t mask[kMaxStages][2];  // dq: the staged keys' validity
  int tile[kMaxStages];          // >= 0 while the stream runs, -1 ends it
};
static_assert(sizeof(Control) <= kControlBytes, "kControlBytes must hold the control block");

// Dynamic shared memory of one block: the resident tile pair and `stages`
// streamed pairs, each tile 64 rows x R*D bf16, after up to 1 KB of
// alignment, then the control block.
__host__ __device__ constexpr long long smem_bytes(int features, int stages) {
  return 1024 + 4LL * kRows * features * (1 + stages) + kControlBytes;
}

struct TiedGradParams {
  const float* lse;   // (B, H, Nq) f32 from the forward; +inf: no valid key
  const float* dsum;  // (B, H, Nq) f32 over the whole fused axis
  const unsigned char* q_mask;   // (B, Nq) 0/1, or null
  const unsigned char* kv_mask;  // (B, Nk) 0/1, or null
  const float* tie_scale;        // (B,) f32, or null (1)
  void* out0;  // bf16 dq (dq) or dk (dk/dv) through o0
  void* out1;  // bf16 dv (dk/dv) through o1
  Operand o0, o1;  // element strides (batch, head, token, row)
  int batch, rows, heads, nq, nk, tiles, groups, stages;
  float sm_scale;
};

__device__ __forceinline__ float tie_of(const TiedGradParams& p, int b) {
  return p.tie_scale != nullptr ? p.tie_scale[b] : 1.f;
}

// The lse of query row n in log2 units, +inf where the row takes no part in
// the backward: past Nq, masked, or with no valid key (lse = +inf).
__device__ __forceinline__ float live_lse2(const TiedGradParams& p, int b, long long bh, int n) {
  if (n >= p.nq) return CUDART_INF_F;
  if (p.q_mask != nullptr && p.q_mask[(long long)b * p.nq + n] == 0) return CUDART_INF_F;
  const float l = p.lse[bh * p.nq + n];
  return l < CUDART_INF_F ? l * kLog2e : CUDART_INF_F;
}

__device__ __forceinline__ bool key_live(const TiedGradParams& p, int b, int n) {
  return n < p.nk && (p.kv_mask == nullptr || p.kv_mask[(long long)b * p.nk + n] != 0);
}

// Element (b, h, n, fused column f) of output o.
template <int D>
__device__ __forceinline__ __nv_bfloat16* out_at(const TiedGradParams& p, int o, int b, int h,
                                                 int n, int f) {
  // each stride picked by value, as grad_merge_kernel does
  const long long sb = o ? p.o1.sb : p.o0.sb, sh = o ? p.o1.sh : p.o0.sh,
                  sn = o ? p.o1.sn : p.o0.sn, sr = o ? p.o1.sr : p.o0.sr;
  return static_cast<__nv_bfloat16*>(o ? p.out1 : p.out0) + (long long)b * sb +
         (long long)h * sh + (long long)n * sn + (long long)(f / D) * sr + f % D;
}

// The shared-memory chunk (of a tile landed as NDC boxes of R chunks) that
// holds fused output chunk fc: row fc / NDC, columns (fc % NDC) * CW on.
template <int D>
__device__ __forceinline__ int staged_chunk(int fc, int rows) {
  return (fc % Cfg<D>::NDC) * rows + fc / Cfg<D>::NDC;
}

// A block whose own 64 rows (from r0) are all dead: zeros in its column
// group of each of its `outs` outputs.
template <int D, int C>
__device__ __forceinline__ void zero_block(const TiedGradParams& p, int outs, int b, int h,
                                           int r0, int n_rows, int fc0) {
  using G = Cfg<D>;
  constexpr int CPG = C / G::CW, kVecs = G::CW / 8;  // 16-byte stores a chunk row
  const int chunks = p.rows * G::NDC;
  for (int o = 0; o < outs; ++o)
    for (int e = threadIdx.x; e < kRows * CPG * kVecs; e += kThreads) {
      const int n = r0 + e / (CPG * kVecs), fc = fc0 + (e / kVecs) % CPG;
      if (n < n_rows && fc < chunks)
        *reinterpret_cast<uint4*>(out_at<D>(p, o, b, h, n, fc * G::CW + (e % kVecs) * 8)) =
            make_uint4(0, 0, 0, 0);
    }
}

// One thread's rows (lrow, lrow + 8 of the block's 64 from r0) of output o
// in the block's column group: acc[c][4j + 2r + e] is (row lrow + 8r,
// column 8j + 2t + e of fused chunk fc0 + c), times `scale`, as bf16.
template <int D, int C>
__device__ __forceinline__ void store_cols(const TiedGradParams& p, int o,
                                           const float (&acc)[C / Cfg<D>::CW][Cfg<D>::CW / 2],
                                           float scale, int b, int h, int r0, int lrow, int t,
                                           int n_rows, int fc0) {
  using G = Cfg<D>;
  constexpr int CPG = C / G::CW;
  const int chunks = p.rows * G::NDC;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = r0 + lrow + 8 * r;
    if (n >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < CPG; ++c) {
      if (fc0 + c >= chunks) continue;  // the last group's repeated chunk
      __nv_bfloat16* dst = out_at<D>(p, o, b, h, n, (fc0 + c) * G::CW);
#pragma unroll
      for (int j = 0; j < G::CW / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t) =
            pack_bf16(acc[c][4 * j + 2 * r] * scale, acc[c][4 * j + 2 * r + 1] * scale);
    }
  }
}

// x = a b^T over the whole fused axis for one 64 x 64 tile pair: a and b
// are 64-row tiles landed as `chunks` K-major chunks at a_addr, b_addr.
template <int D>
__device__ __forceinline__ void fused_product(float (&x)[32], uint32_t a_addr, uint32_t b_addr,
                                              int chunks) {
  using G = Cfg<D>;
  for (int c = 0; c < chunks; ++c)
#pragma unroll
    for (int kk = 0; kk < G::CW / 16; ++kk) {
      const uint32_t off = c * G::kChunk + kk * 32;
      wgmma_ss<kRows>(x, kmajor_desc<G::SWB>(a_addr + off), kmajor_desc<G::SWB>(b_addr + off),
                      (c | kk) != 0);
    }
}

// acc[c] += a(64 x 16 of the tile pair, registers) . the staged tile's rows
// 16kk .. 16kk + 15 at the block's output chunks (smem chunks sc[c], read
// MN-major).
template <int D, int CPG>
__device__ __forceinline__ void accumulate_cols(float (&acc)[CPG][Cfg<D>::CW / 2],
                                                const uint32_t (&a)[4], uint32_t tile_addr,
                                                const int (&sc)[CPG], int kk) {
  using G = Cfg<D>;
#pragma unroll
  for (int c = 0; c < CPG; ++c)
    wgmma_rs<G::CW>(acc[c], a,
                    mnmajor_desc<G::SWB>(tile_addr + sc[c] * G::kChunk + kk * 16 * G::SWB), 1);
}

// Lands one 64-row tile of operand `map` (rows n0 .. n0 + 63 of (b, h), all
// R rows) at dst as NDC boxes of R chunks.
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int rows, int b, int h, int n0) {
  using G = Cfg<D>;
#pragma unroll
  for (int dc = 0; dc < G::NDC; ++dc)
    tma_load_5d(dst + dc * rows * G::kChunk, map, bar, dc * G::CW, h, n0, 0, b);
}

// Thread 0 initialises the ring's barriers; every thread then syncs.
__device__ __forceinline__ void init_ring(Control& ctl, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&ctl.full[s], 32);    // the producer warp
      mbar_init(&ctl.empty[s], 128);  // every consumer thread
    }
    mbar_init(&ctl.resbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The end of the producer's stream after `it` staged tiles.
__device__ __forceinline__ void end_stream(Control& ctl, int it, int stages) {
  const int st = it % stages;
  mbar_wait(&ctl.empty[st], ((it / stages) & 1) ^ 1);
  if ((threadIdx.x & 31) == 0) ctl.tile[st] = -1;
  mbar_arrive(&ctl.full[st]);
}

// ---------------------------------------------------------------- dq

template <int D>
__device__ __forceinline__ void producer_dq(const CUtensorMap* tq, const CUtensorMap* tdo,
                                            const CUtensorMap* tk, const CUtensorMap* tv,
                                            const TiedGradParams& p, unsigned char* res,
                                            unsigned char* ring, Control& ctl, int b, int h,
                                            int q0) {
  const int lane = threadIdx.x & 31;
  const uint32_t tbytes = 2u * kRows * p.rows * D;  // one tile over the fused axis
  if (lane == 0) {
    mbar_arrive_expect_tx(&ctl.resbar, 2 * tbytes);
    load_tile<D>(res, tq, &ctl.resbar, p.rows, b, h, q0);
    load_tile<D>(res + tbytes, tdo, &ctl.resbar, p.rows, b, h, q0);
  }
  int it = 0;
  for (int k0 = 0; k0 < p.nk; k0 += kRows) {
    const uint32_t w0 = __ballot_sync(0xffffffffu, key_live(p, b, k0 + lane));
    const uint32_t w1 = __ballot_sync(0xffffffffu, key_live(p, b, k0 + 32 + lane));
    if ((w0 | w1) == 0u) continue;  // no valid key: the tile adds nothing
    const int st = it % p.stages;
    mbar_wait(&ctl.empty[st], ((it / p.stages) & 1) ^ 1);
    unsigned char* ks = ring + st * 2 * tbytes;
    if (lane == 0) {
      ctl.mask[st][0] = w0;
      ctl.mask[st][1] = w1;
      ctl.tile[st] = k0;
      mbar_arrive_expect_tx(&ctl.full[st], 2 * tbytes);
      load_tile<D>(ks, tk, &ctl.full[st], p.rows, b, h, k0);
      load_tile<D>(ks + tbytes, tv, &ctl.full[st], p.rows, b, h, k0);
    } else {
      mbar_arrive(&ctl.full[st]);
    }
    ++it;
  }
  end_stream(ctl, it, p.stages);
}

template <int D, int C>
__device__ __forceinline__ void consumer_dq(const TiedGradParams& p, unsigned char* res,
                                            unsigned char* ring, Control& ctl, int b, int h,
                                            int q0, int fc0) {
  using G = Cfg<D>;
  constexpr int CPG = C / G::CW;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int lrow = 16 * (threadIdx.x >> 5) + (lane >> 2);  // rows lrow, lrow + 8
  const long long bh = (long long)b * p.heads + h;
  const uint32_t tbytes = 2u * kRows * p.rows * D;
  const int chunks = p.rows * G::NDC;
  const float scale = p.sm_scale * tie_of(p, b);
  float lse2[2], dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + lrow + 8 * r;
    lse2[r] = live_lse2(p, b, bh, n);
    dsum[r] = lse2[r] < CUDART_INF_F ? p.dsum[bh * p.nq + n] : 0.f;
  }
  int sc[CPG];
#pragma unroll
  for (int c = 0; c < CPG; ++c) sc[c] = staged_chunk<D>(min(fc0 + c, chunks - 1), p.rows);
  float dq[CPG][G::CW / 2];
#pragma unroll
  for (int c = 0; c < CPG; ++c)
#pragma unroll
    for (int i = 0; i < G::CW / 2; ++i) dq[c][i] = 0.f;

  const uint32_t qaddr = smem_u32(res), doaddr = qaddr + tbytes;
  mbar_wait(&ctl.resbar, 0);
  for (int it = 0;; ++it) {
    const int st = it % p.stages;
    mbar_wait(&ctl.full[st], (it / p.stages) & 1);
    if (__shfl_sync(0xffffffffu, ctl.tile[st], 0) < 0) break;  // uniform, as `role`
    const uint32_t kaddr = smem_u32(ring + st * 2 * tbytes), vaddr = kaddr + tbytes;

    float s[32], dp[32];  // [4j + 2r + e]: row lrow + 8r, key 8j + 2t + e
    wgmma_fence();
    fused_product<D>(s, qaddr, kaddr, chunks);
    fused_product<D>(dp, doaddr, vaddr, chunks);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);
    fence_operands(dp);

    const uint32_t m0 = ctl.mask[st][0], m1 = ctl.mask[st][1];
    const uint32_t mw[grad::kMaskWords] = {m0 >> (2 * t), m1 >> (2 * t)};
    if (__shfl_sync(0xffffffffu, (m0 & m1) == ~0u, 0))
      grad::ds_rows<false>(s, dp, mw, scale * kLog2e, lse2, dsum);
    else
      grad::ds_rows<true>(s, dp, mw, scale * kLog2e, lse2, dsum);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t a[4];
      grad::a_frag16(a, s, kk);
      accumulate_cols<D, CPG>(dq, a, kaddr, sc, kk);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < CPG; ++c) fence_operands(dq[c]);
    mbar_arrive(&ctl.empty[st]);
  }
  store_cols<D, C>(p, 0, dq, scale, b, h, q0, lrow, t, p.nq, fc0);
}

// One block per (batch * head, 64-query tile, column group); the groups of
// one query tile are adjacent blocks, so they read its tiles from L2.
template <int D, int C>
__global__ void __launch_bounds__(kThreads, 1)
    tied_dq_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const TiedGradParams p) {
  constexpr int CPG = C / Cfg<D>::CW;
  extern __shared__ unsigned char tied_grad_smem[];
  unsigned char* res = align1024(tied_grad_smem);  // Q, then dO
  const uint32_t tbytes = 2u * kRows * p.rows * D;
  unsigned char* ring = res + 2 * tbytes;  // stages of K, then V
  Control& ctl = *reinterpret_cast<Control*>(ring + p.stages * 2 * tbytes);

  long long blk = blockIdx.x;
  const int g = (int)(blk % p.groups);
  blk /= p.groups;
  const int qt = (int)(blk % p.tiles);
  const long long bh = blk / p.tiles;
  const int b = (int)(bh / p.heads), h = (int)(bh % p.heads);
  const int q0 = qt * kRows, fc0 = g * CPG;

  const bool live = threadIdx.x < kRows && live_lse2(p, b, bh, q0 + (int)threadIdx.x) <
                                               CUDART_INF_F;
  if (!__syncthreads_or(live)) {  // every query row dead: dq = 0, no key read
    zero_block<D, C>(p, 1, b, h, q0, p.nq, fc0);
    return;
  }
  init_ring(ctl, p.stages);

  // the role, broadcast from lane 0 so that ptxas sees the branch as
  // warp-uniform (a branch it cannot prove uniform serialises every wgmma)
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == 1)
    producer_dq<D>(&tq, &tdo, &tk, &tv, p, res, ring, ctl, b, h, q0);
  else
    consumer_dq<D, C>(p, res, ring, ctl, b, h, q0, fc0);
}

// ---------------------------------------------------------------- dk, dv

template <int D>
__device__ __forceinline__ void producer_dkv(const CUtensorMap* tq, const CUtensorMap* tdo,
                                             const CUtensorMap* tk, const CUtensorMap* tv,
                                             const TiedGradParams& p, unsigned char* res,
                                             unsigned char* ring, Control& ctl, int b, int h,
                                             int k0) {
  const int lane = threadIdx.x & 31;
  const long long bh = (long long)b * p.heads + h;
  const uint32_t tbytes = 2u * kRows * p.rows * D;
  if (lane == 0) {
    mbar_arrive_expect_tx(&ctl.resbar, 2 * tbytes);
    load_tile<D>(res, tk, &ctl.resbar, p.rows, b, h, k0);
    load_tile<D>(res + tbytes, tv, &ctl.resbar, p.rows, b, h, k0);
  }
  int it = 0;
  for (int q0 = 0; q0 < p.nq; q0 += kRows) {
    const float l0 = live_lse2(p, b, bh, q0 + lane), l1 = live_lse2(p, b, bh, q0 + 32 + lane);
    const uint32_t w0 = __ballot_sync(0xffffffffu, l0 < CUDART_INF_F);
    const uint32_t w1 = __ballot_sync(0xffffffffu, l1 < CUDART_INF_F);
    if ((w0 | w1) == 0u) continue;  // no live query: the tile adds nothing
    const float* dsum = p.dsum + bh * p.nq + q0;
    const float d0 = l0 < CUDART_INF_F ? dsum[lane] : 0.f;
    const float d1 = l1 < CUDART_INF_F ? dsum[32 + lane] : 0.f;
    const int st = it % p.stages;
    mbar_wait(&ctl.empty[st], ((it / p.stages) & 1) ^ 1);
    ctl.lse[st][lane] = l0;
    ctl.lse[st][32 + lane] = l1;
    ctl.dsum[st][lane] = d0;
    ctl.dsum[st][32 + lane] = d1;
    unsigned char* qs = ring + st * 2 * tbytes;
    if (lane == 0) {
      ctl.tile[st] = q0;
      mbar_arrive_expect_tx(&ctl.full[st], 2 * tbytes);
      load_tile<D>(qs, tq, &ctl.full[st], p.rows, b, h, q0);
      load_tile<D>(qs + tbytes, tdo, &ctl.full[st], p.rows, b, h, q0);
    } else {
      mbar_arrive(&ctl.full[st]);
    }
    ++it;
  }
  end_stream(ctl, it, p.stages);
}

template <int D, int C>
__device__ __forceinline__ void consumer_dkv(const TiedGradParams& p, unsigned char* res,
                                             unsigned char* ring, Control& ctl, int b, int h,
                                             int k0, int fc0) {
  using G = Cfg<D>;
  constexpr int CPG = C / G::CW;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int lrow = 16 * (threadIdx.x >> 5) + (lane >> 2);  // key rows lrow, lrow + 8
  const uint32_t tbytes = 2u * kRows * p.rows * D;
  const int chunks = p.rows * G::NDC;
  const float scale = p.sm_scale * tie_of(p, b);
  const bool kv[2] = {key_live(p, b, k0 + lrow), key_live(p, b, k0 + lrow + 8)};
  int sc[CPG];
#pragma unroll
  for (int c = 0; c < CPG; ++c) sc[c] = staged_chunk<D>(min(fc0 + c, chunks - 1), p.rows);
  float dk[CPG][G::CW / 2], dv[CPG][G::CW / 2];
#pragma unroll
  for (int c = 0; c < CPG; ++c)
#pragma unroll
    for (int i = 0; i < G::CW / 2; ++i) dk[c][i] = dv[c][i] = 0.f;

  const uint32_t kaddr = smem_u32(res), vaddr = kaddr + tbytes;
  mbar_wait(&ctl.resbar, 0);
  for (int it = 0;; ++it) {
    const int st = it % p.stages;
    mbar_wait(&ctl.full[st], (it / p.stages) & 1);
    if (__shfl_sync(0xffffffffu, ctl.tile[st], 0) < 0) break;  // uniform, as `role`
    const uint32_t qaddr = smem_u32(ring + st * 2 * tbytes), doaddr = qaddr + tbytes;

    float s[32], dp[32];  // [4j + 2r + e]: key row lrow + 8r, query 8j + 2t + e
    wgmma_fence();
    fused_product<D>(s, kaddr, qaddr, chunks);
    fused_product<D>(dp, vaddr, doaddr, chunks);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);
    fence_operands(dp);

    // p^T in s, ds^T in dp; a dead query column has lse2 = +inf (p = 0)
    const uint32_t all[grad::kMaskWords] = {~0u, ~0u};
    grad::dkv_cols<false>(s, dp, all, scale * kLog2e, kv, ctl.lse[st], ctl.dsum[st], t);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t ap[4], ad[4];
      grad::a_frag16(ap, s, kk);
      grad::a_frag16(ad, dp, kk);
      accumulate_cols<D, CPG>(dv, ap, doaddr, sc, kk);
      accumulate_cols<D, CPG>(dk, ad, qaddr, sc, kk);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < CPG; ++c) {
      fence_operands(dk[c]);
      fence_operands(dv[c]);
    }
    mbar_arrive(&ctl.empty[st]);
  }
  store_cols<D, C>(p, 0, dk, scale, b, h, k0, lrow, t, p.nk, fc0);
  store_cols<D, C>(p, 1, dv, 1.f, b, h, k0, lrow, t, p.nk, fc0);
}

// One block per (batch * head, 64-key tile, column group).
template <int D, int C>
__global__ void __launch_bounds__(kThreads, 1)
    tied_dkv_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const TiedGradParams p) {
  constexpr int CPG = C / Cfg<D>::CW;
  extern __shared__ unsigned char tied_grad_smem[];
  unsigned char* res = align1024(tied_grad_smem);  // K, then V
  const uint32_t tbytes = 2u * kRows * p.rows * D;
  unsigned char* ring = res + 2 * tbytes;  // stages of Q, then dO
  Control& ctl = *reinterpret_cast<Control*>(ring + p.stages * 2 * tbytes);

  long long blk = blockIdx.x;
  const int g = (int)(blk % p.groups);
  blk /= p.groups;
  const int kt = (int)(blk % p.tiles);
  const long long bh = blk / p.tiles;
  const int b = (int)(bh / p.heads), h = (int)(bh % p.heads);
  const int k0 = kt * kRows, fc0 = g * CPG;

  const bool live = threadIdx.x < kRows && key_live(p, b, k0 + (int)threadIdx.x);
  if (!__syncthreads_or(live)) {  // every key masked: dk = dv = 0, no query read
    zero_block<D, C>(p, 2, b, h, k0, p.nk, fc0);
    return;
  }
  init_ring(ctl, p.stages);

  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == 1)
    producer_dkv<D>(&tq, &tdo, &tk, &tv, p, res, ring, ctl, b, h, k0);
  else
    consumer_dkv<D, C>(p, res, ring, ctl, b, h, k0, fc0);
}

// ---------------------------------------------------------------- host

// The Hopper K2 backward's launch at a shape: output columns a block (64
// or 128) and ring stages (1 or 2); columns 0 where these kernels do not
// take the shape (row width outside 32/64/128, a fused axis that is not
// whole rows, or one too wide for the resident pair and one stage). A pure
// function of the shape, for bf16 operands TMA can describe: as many
// stages as shared memory holds, up to two; dk/dv C = 64 (four
// accumulators); dq C = 128 where the grid then fills a wave of the card's
// SMs, else 64.
struct TiedGradPlan {
  int columns, stages;
};

__host__ inline TiedGradPlan plan_shape(bool dkv, int batch, int heads, int nq, int nk,
                                        int features, int row_width) {
  if (row_width != 32 && row_width != 64 && row_width != 128) return {0, 0};
  if (features < row_width || features % row_width != 0) return {0, 0};
  int stages = kMaxStages;
  while (stages > 0 && smem_bytes(features, stages) > kSmemLimit) --stages;
  if (stages == 0) return {0, 0};
  const long long tiles = (long long)batch * heads * (((dkv ? nk : nq) + kRows - 1) / kRows);
  const bool wide = !dkv && features >= 128 && tiles * ((features + 127) / 128) >= kSMs;
  return {wide ? 128 : 64, stages};
}

template <int D, int C>
__host__ inline Af2LaunchPlan plan_tied_grad(bool dkv, int batch, int heads, int nq, int nk,
                                             int features, int stages) {
  Af2LaunchPlan plan{};
  const int rows = dkv ? nk : nq;
  plan.blocks = (long long)batch * heads * ((rows + kRows - 1) / kRows) *
                ((features + C - 1) / C);
  plan.threads = kThreads;
  plan.dynamic_smem = (int)smem_bytes(features, stages);
  name_kernel(plan, dkv ? "tied_dkv_kernel_sm90<%d,%d>" : "tied_dq_kernel_sm90<%d,%d>", D, C);
  return plan;
}

// One backward problem as tied_row_attention_bwd.cu receives it: operands
// and outputs through element strides (batch, head, token, row).
struct TiedGradOperands {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* dsum;
  const unsigned char* q_mask;
  const unsigned char* kv_mask;
  const float* tie_scale;
  void* out0;  // dq | dk
  void* out1;  // -  | dv
  Operand qs, ks, vs, dos, o0s, o1s;
  int batch, heads, nq, nk, features, row_width;
  float sm_scale;
};

// rows_operand (sm90_ptx.cuh): can TMA, and the 16-byte zero stores, address
// each operand?
__host__ inline bool takes(const TiedGradOperands& a, bool dkv) {
  if (a.row_width < 1 || a.features % a.row_width != 0) return false;
  const int rows = a.features / a.row_width, n = dkv ? a.nk : a.nq;
  return rows_operand(a.q, a.qs, a.batch, a.heads, a.nq, rows) &&
         rows_operand(a.k, a.ks, a.batch, a.heads, a.nk, rows) &&
         rows_operand(a.v, a.vs, a.batch, a.heads, a.nk, rows) &&
         rows_operand(a.dout, a.dos, a.batch, a.heads, a.nq, rows) &&
         rows_operand(a.out0, a.o0s, a.batch, a.heads, n, rows) &&
         (!dkv || rows_operand(a.out1, a.o1s, a.batch, a.heads, n, rows));
}

// Launches tied_dkv_kernel_sm90<D, C> (kDkv) or tied_dq_kernel_sm90<D, C>.
template <int D, int C, bool kDkv>
__host__ inline cudaError_t launch_tied_grad(const TiedGradOperands& a, int stages,
                                             cudaStream_t stream) {
  constexpr bool dkv = kDkv;
  const Af2LaunchPlan plan =
      plan_tied_grad<D, C>(dkv, a.batch, a.heads, a.nq, a.nk, a.features, stages);
  const int rows = a.features / D;
  if (!grid_fits(plan) || a.row_width != D || stages < 1 || stages > kMaxStages)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv;
  if (!encode_rows(&tq, a.q, a.qs, a.batch, a.heads, a.nq, rows, D, rows) ||
      !encode_rows(&tdo, a.dout, a.dos, a.batch, a.heads, a.nq, rows, D, rows) ||
      !encode_rows(&tk, a.k, a.ks, a.batch, a.heads, a.nk, rows, D, rows) ||
      !encode_rows(&tv, a.v, a.vs, a.batch, a.heads, a.nk, rows, D, rows))
    return cudaErrorInvalidValue;
  TiedGradParams p;
  p.lse = a.lse;
  p.dsum = a.dsum;
  p.q_mask = a.q_mask;
  p.kv_mask = a.kv_mask;
  p.tie_scale = a.tie_scale;
  p.out0 = a.out0;
  p.out1 = a.out1;
  p.o0 = a.o0s;
  p.o1 = a.o1s;
  p.batch = a.batch;
  p.rows = rows;
  p.heads = a.heads;
  p.nq = a.nq;
  p.nk = a.nk;
  p.tiles = ((dkv ? a.nk : a.nq) + kRows - 1) / kRows;
  p.groups = (a.features + C - 1) / C;
  p.stages = stages;
  p.sm_scale = a.sm_scale;
  const unsigned blocks = (unsigned)plan.blocks;
  const int smem = plan.dynamic_smem;
  cudaError_t err;
  if constexpr (kDkv) {
    err = cudaFuncSetAttribute(tied_dkv_kernel_sm90<D, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    tied_dkv_kernel_sm90<D, C><<<blocks, kThreads, smem, stream>>>(tq, tdo, tk, tv, p);
  } else {
    err = cudaFuncSetAttribute(tied_dq_kernel_sm90<D, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    tied_dq_kernel_sm90<D, C><<<blocks, kThreads, smem, stream>>>(tq, tdo, tk, tv, p);
  }
  return cudaGetLastError();
}

}  // namespace tied_grad
}  // namespace sm90
}  // namespace af2
