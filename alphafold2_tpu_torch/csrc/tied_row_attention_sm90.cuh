// K2's bf16 forward redesigned for Hopper (sm_90a): the shared logits of a
// 64-query tile computed once per 64-key tile over the whole fused R*D axis,
// from TMA-fed (B, R, N, H, D) boxes, with wgmma. Included by
// tied_row_attention.cu, whose plan routes here every bf16 problem at head
// dim 32, 64 or 128 with 16-byte aligned operands and R*D narrow enough for
// the resident q tile and two stages (R*D <= 512 at head dim 64); wider
// bf16 problems at those head dims take the wide route
// (tied_row_wide_sm90.cuh), the rest attention_kernel_mma
// (attention_tile.cuh), and f32 keeps attention_kernel.
//
// Replaces the TPU path alphafold2_tpu/ops/pallas/tied_row.py
// `tied_row_attention` (:53), which folds the rows into head dim R*D and
// runs ops/pallas/axial.py `_run` (pallas_call :249). Computes
//     logits[b, h, i, j] = sm_scale * tie[b] * sum_r q[b, r, i, h] . k[b, r, j, h]
//     out[b, r, i, h]    = sum_j softmax_j(logits | kv_mask) v[b, r, j, h]
// with the masking contract of attention_tile.cuh: masked keys weigh 0,
// masked queries and rows with no valid key write 0, and with lse each
// row's logsumexp of the scaled logits (+inf for a row with no valid key),
// written by the blocks of column group 0 alone.
//
// What bounds it: at the main-path shapes (R*D 320, N 64-128) the work is
// small (4 * R*D operations per (query, key) pair against 2 * R*D bytes of
// q and k per row), so one block's latency bounds it: loading its q tile,
// its K stages and its V columns, and the chain of R*D / 16 wgmma k-steps
// of S. attention_kernel_mma recomputes S once per 64-wide output chunk
// (5x at R*D 320) from tiles staged by ordinary loads. The design:
//
// * Operands are read in place through one 5-D tensor map each: dims
//   {D, H, N, R, B}, the operand's byte strides (contiguous K2: {2D, 2HD,
//   2NHD, 2RNHD}; K1's (B, H, N, E) view of a (B, N, H, E) buffer at a head
//   dim E past 128, read as E/64 rows of 64: {2E, 2HE, 128, 2NHE}, the token
//   stride doubled for the k and v halves of one projection), box {CW, 1,
//   64, R, 1} for q and k (CW = min(D, 64) columns, 128-byte swizzled at CW 64,
//   64-byte at 32; head dim 128 takes two boxes along D). One copy lands a
//   64-token tile as R K-major chunks of 64 x CW, the layout in which wgmma
//   contracts the fused (r, d) axis; no fold copy. v's map has box {CW, 1,
//   64, 1, 1}: a stage holds only the block's output chunks.
// * Block: one consumer warpgroup (the 64 query rows) and one producer
//   warp, 160 threads. The q tile stays resident (40 KB at R*D 320, 64 KB
//   at 512); K and V stream through a ring of one or two 64-key stages
//   with full and empty mbarriers (one where that lets two blocks share an
//   SM and the grid needs it: the serving pass, 99,392 bytes a block).
//   Beside each stage the producer stages its keys' validity as two 32-bit
//   words (one ballot each over the mask bytes, keys past N invalid) and
//   skips a tile with no valid key.
// * S (64 x 64, f32) is one wgmma m64n64k16 chain of R*D / 16 k-steps over
//   the chunks of q and K: once per key tile within a column group. The
//   online softmax runs in log2 units (K1's softmax_tile: one FMA and one
//   ex2 a logit, no mask arithmetic on a tile whose keys are all valid, the
//   row's smallest raw logit for a negative scale). The per-batch tie scale
//   multiplies the f32 logits (scale = sm_scale * tie[b] * log2 e), never a
//   rounded copy of q; K1's head dim read as rows passes none (tie 1). P goes to P V' as bf16 A fragments from registers;
//   V' is read MN-major from the stage through its descriptor, as K1 reads V.
// * Column groups: a consumer's f32 accumulator for 64 rows x C columns
//   costs C / 2 registers a thread, so a block covers C = 64 or 128 of the
//   R*D output columns (CW-wide chunks; the last group repeats the last
//   chunk where R*D is not a multiple of C, and does not store it) and
//   G = ceil(R*D / C) blocks share a query tile, each recomputing S: G
//   times the logits work, against R*D / 64 in attention_kernel_mma. Two consumer
//   warpgroups of one block would need the same P: that block would either
//   compute S twice on one SM's tensor cores or hand P over through shared
//   memory with two more barriers a tile; neither gains over more blocks at
//   these grids, which leave most SMs idle. The plan (a pure function of the
//   shape) takes C = 128 where the grid then fills a wave of 132 SMs, else
//   C = 64: the serving pass (64 query tiles) runs 3 groups of 128, 192
//   blocks, two an SM; the training pass (8 query tiles) 5 groups of 64,
//   40 blocks.
// * Without lse (serving), a block whose 64 query rows are all masked
//   writes 0 to its columns and reads no key. Rows past N are zero-filled
//   by TMA and never written. The epilogue writes each thread's bf16 pairs
//   straight from registers into the output through its strides.

#pragma once

#include "fused_attention_sm90.cuh"

namespace af2 {
namespace sm90 {
namespace tied {

constexpr int kRows = 64;    // query rows a block, keys a stage
constexpr int kMaxStages = 2;
constexpr int kThreads = 128 + 32;  // one consumer warpgroup, one producer warp
constexpr int kSMs = 132;           // the H100 SXM's: the plan's wave
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may take
constexpr int kSmemPerSM = 233472;  // an SM's shared memory, 1 KB of it reserved a block
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
  static constexpr int CW = D < 64 ? D : 64;  // columns of one swizzled chunk
  static constexpr int NDC = D / CW;          // chunks along one row's head dim
  static constexpr int SWB = CW * 2;          // bytes per chunk row = swizzle span
  static constexpr int kChunk = kRows * SWB;  // bytes of one 64-row chunk
};

struct Control {
  uint64_t full[kMaxStages];
  uint64_t empty[kMaxStages];
  uint64_t qbar;
  uint32_t mask[kMaxStages][2];
  int tile[kMaxStages];  // first key of the staged tile, -1 ends the stream
};

// Dynamic shared memory of one block: the q tile and `stages` stages of K
// (64 x R*D) and V (64 x C), bf16, after up to 1 KB of alignment.
__host__ __device__ constexpr long long smem_bytes(int features, int columns, int stages) {
  return 1024 + 2LL * kRows * (features + stages * (features + columns)) +
         (long long)sizeof(Control);
}

struct TiedParams {
  void* out;     // bf16 (B, R, Nq, H, D) through os's element strides
  float* lse;    // (B, H, Nq) f32, or null (serving)
  const unsigned char* q_mask;
  const unsigned char* kv_mask;
  const float* tie_scale;  // (B,) f32, or null (1)
  Operand os;              // the output's (batch, head, token, row) strides
  int batch, rows, heads, nq, nk, q_tiles, groups, stages;
  float scale_log2;  // sm_scale * log2(e); the kernel multiplies in tie[b]
};

// The producer warp: q once, then each key tile with a valid key as one
// stage (K over all R*D features, V over the block's CPG output chunks from
// fused chunk fc0 on), then the end of the stream.
template <int D, int C>
__device__ __forceinline__ void producer(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, const TiedParams& p,
                                         unsigned char* qs, unsigned char* ring, Control& ctl,
                                         int b, int h, int q0, int fc0) {
  using G = Cfg<D>;
  constexpr int CPG = C / G::CW;
  const int lane = threadIdx.x & 31;
  const uint32_t kbytes = 2u * kRows * p.rows * D, vbytes = 2u * kRows * C;
  const int chunks = p.rows * G::NDC;  // fused output chunks
  if (lane == 0) {
    mbar_arrive_expect_tx(&ctl.qbar, kbytes);
#pragma unroll
    for (int dc = 0; dc < G::NDC; ++dc)
      tma_load_5d(qs + dc * p.rows * G::kChunk, tq, &ctl.qbar, dc * G::CW, h, q0, 0, b);
  }
  const unsigned char* km = p.kv_mask != nullptr ? p.kv_mask + (long long)b * p.nk : nullptr;
  int it = 0;
  for (int k0 = 0; k0 < p.nk; k0 += kRows) {
    const int key0 = k0 + lane, key1 = k0 + 32 + lane;
    const uint32_t w0 = __ballot_sync(0xffffffffu, key0 < p.nk && (km == nullptr || km[key0]));
    const uint32_t w1 = __ballot_sync(0xffffffffu, key1 < p.nk && (km == nullptr || km[key1]));
    if ((w0 | w1) == 0u) continue;  // no valid key: the tile changes nothing
    const int st = it % p.stages;
    mbar_wait(&ctl.empty[st], ((it / p.stages) & 1) ^ 1);
    unsigned char* ks = ring + st * (kbytes + vbytes);
    unsigned char* vs = ks + kbytes;
    if (lane == 0) {
      ctl.mask[st][0] = w0;
      ctl.mask[st][1] = w1;
      ctl.tile[st] = k0;
      mbar_arrive_expect_tx(&ctl.full[st], kbytes + vbytes);
#pragma unroll
      for (int dc = 0; dc < G::NDC; ++dc)
        tma_load_5d(ks + dc * p.rows * G::kChunk, tk, &ctl.full[st], dc * G::CW, h, k0, 0, b);
#pragma unroll
      for (int c = 0; c < CPG; ++c) {
        const int fc = min(fc0 + c, chunks - 1);  // the last group repeats its last chunk
        tma_load_5d(vs + c * G::kChunk, tv, &ctl.full[st], (fc % G::NDC) * G::CW, h, k0,
                    fc / G::NDC, b);
      }
    } else {
      mbar_arrive(&ctl.full[st]);
    }
    ++it;
  }
  const int st = it % p.stages;  // the end of the stream
  mbar_wait(&ctl.empty[st], ((it / p.stages) & 1) ^ 1);
  if (lane == 0) ctl.tile[st] = -1;
  mbar_arrive(&ctl.full[st]);
}

// The consumer warpgroup: rows q0 .. q0 + 63 of (b, h), output chunks fc0 ..
// fc0 + CPG - 1 of the fused axis (chunk fc is row fc / NDC, columns
// (fc % NDC) * CW .. + CW of its head dim).
template <int D, int C>
__device__ __forceinline__ void consumer(const TiedParams& p, unsigned char* qs,
                                         unsigned char* ring, Control& ctl, int b, int h,
                                         int q0, int fc0, bool writes_lse) {
  using G = Cfg<D>;
  constexpr int CPG = C / G::CW;
  const int wt = threadIdx.x;
  const int lane = wt & 31, t = lane & 3;
  const int lrow = 16 * (wt / 32) + (lane >> 2);  // this thread's rows: lrow, lrow + 8
  const uint32_t kbytes = 2u * kRows * p.rows * D, vbytes = 2u * kRows * C;
  const int qk_chunks = p.rows * G::NDC;  // K-major chunks of q and K, in shared-memory order

  float o[CPG][G::CW / 2];
#pragma unroll
  for (int c = 0; c < CPG; ++c)
#pragma unroll
    for (int i = 0; i < G::CW / 2; ++i) o[c][i] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};
  const float scale = p.scale_log2 * (p.tie_scale != nullptr ? p.tie_scale[b] : 1.f);
  const bool neg = scale < 0.f;

  const uint32_t qaddr = smem_u32(qs);
  mbar_wait(&ctl.qbar, 0);
  for (int it = 0;; ++it) {
    const int st = it % p.stages;
    mbar_wait(&ctl.full[st], (it / p.stages) & 1);
    if (__shfl_sync(0xffffffffu, ctl.tile[st], 0) < 0) break;  // uniform, as `role`
    const uint32_t kaddr = smem_u32(ring + st * (kbytes + vbytes));
    const uint32_t vaddr = kaddr + kbytes;

    // S over the whole fused axis: R*D / 16 k-steps on one accumulator (the
    // sum's order over chunks is immaterial)
    float s[kRows / 2];  // [4j + 2r + e]: row lrow + 8r, key 8j + 2t + e of the stage
    wgmma_fence();
    for (int c = 0; c < qk_chunks; ++c)
#pragma unroll
      for (int kk = 0; kk < G::CW / 16; ++kk) {
        const uint32_t off = c * G::kChunk + kk * 32;
        wgmma_ss<kRows>(s, kmajor_desc<G::SWB>(qaddr + off), kmajor_desc<G::SWB>(kaddr + off),
                        (c | kk) != 0);
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);

    const uint32_t m0 = ctl.mask[st][0], m1 = ctl.mask[st][1];
    const uint32_t mw[2] = {m0 >> (2 * t), m1 >> (2 * t)};
    // broadcast from lane 0, so that ptxas sees the branch as warp-uniform
    const bool full = __shfl_sync(0xffffffffu, (m0 & m1) == ~0u, 0);
    if (full) {
      if (neg) softmax_tile<false, true>(s, mw, scale, m_run, l_run, o);
      else softmax_tile<false, false>(s, mw, scale, m_run, l_run, o);
    } else {
      if (neg) softmax_tile<true, true>(s, mw, scale, m_run, l_run, o);
      else softmax_tile<true, false>(s, mw, scale, m_run, l_run, o);
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[8 * kk + 0], s[8 * kk + 1]),
                             pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                             pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                             pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
#pragma unroll
      for (int c = 0; c < CPG; ++c)
        wgmma_rs<G::CW>(o[c], a,
                        mnmajor_desc<G::SWB>(vaddr + c * G::kChunk + kk * 16 * G::SWB), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < CPG; ++c) fence_operands(o[c]);
    mbar_arrive(&ctl.empty[st]);
  }

  const int chunks = p.rows * G::NDC;
  const long long bh = (long long)b * p.heads + h;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + lrow + 8 * r;
    if (n >= p.nq) continue;
    const bool qv = p.q_mask == nullptr || p.q_mask[(long long)b * p.nq + n] != 0;
    if (writes_lse && t == 0)
      p.lse[bh * p.nq + n] =
          m_run[r] == -CUDART_INF_F ? CUDART_INF_F : m_run[r] * kLn2 + logf(l_run[r]);
    const float inv = qv ? 1.f / fmaxf(l_run[r], 1e-30f) : 0.f;
#pragma unroll
    for (int c = 0; c < CPG; ++c) {
      const int fc = fc0 + c;
      if (fc >= chunks) continue;  // the last group's repeated chunk
      __nv_bfloat16* row = out + (long long)b * p.os.sb + (long long)(fc / G::NDC) * p.os.sr +
                           (long long)n * p.os.sn + (long long)h * p.os.sh +
                           (fc % G::NDC) * G::CW;
#pragma unroll
      for (int j = 0; j < G::CW / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t) =
            pack_bf16(o[c][4 * j + 2 * r] * inv, o[c][4 * j + 2 * r + 1] * inv);
    }
  }
}

// One block per (batch, head, 64-query tile, column group); the groups of
// one query tile are adjacent, so they read its q and K tiles from L2.
template <int D, int C>
__global__ void __launch_bounds__(kThreads, 1)
    tied_row_attention_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv, const TiedParams p) {
  using G = Cfg<D>;
  constexpr int CPG = C / G::CW;
  extern __shared__ unsigned char tied_smem[];
  unsigned char* qs = align1024(tied_smem);
  const int features = p.rows * D;
  unsigned char* ring = qs + 2 * kRows * features;
  Control& ctl = *reinterpret_cast<Control*>(ring + p.stages * 2 * kRows * (features + C));

  long long blk = blockIdx.x;
  const int g = (int)(blk % p.groups);
  blk /= p.groups;
  const int qt = (int)(blk % p.q_tiles);
  const int bh = (int)(blk / p.q_tiles);
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = qt * kRows, fc0 = g * CPG;

  if (p.lse == nullptr) {  // serving: a block of masked rows reads no key
    const int n = q0 + (int)threadIdx.x;
    const bool live = threadIdx.x < kRows && n < p.nq &&
                      (p.q_mask == nullptr || p.q_mask[(long long)b * p.nq + n] != 0);
    if (!__syncthreads_or(live)) {
      const int chunks = p.rows * G::NDC;
      constexpr int kVecs = G::CW / 8;  // 16-byte stores a chunk row
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
      for (int e = threadIdx.x; e < kRows * CPG * kVecs; e += kThreads) {
        const int n_ = q0 + e / (CPG * kVecs), fc = fc0 + (e / kVecs) % CPG;
        if (n_ < p.nq && fc < chunks)
          *reinterpret_cast<uint4*>(out + (long long)b * p.os.sb +
                                    (long long)(fc / G::NDC) * p.os.sr + (long long)n_ * p.os.sn +
                                    (long long)h * p.os.sh + (fc % G::NDC) * G::CW +
                                    (e % kVecs) * 8) = make_uint4(0, 0, 0, 0);
      }
      return;
    }
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&ctl.full[s], 32);   // the producer warp
      mbar_init(&ctl.empty[s], 128);  // every consumer thread
    }
    mbar_init(&ctl.qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role, broadcast from lane 0 so that ptxas sees the branch as
  // warp-uniform (a branch it cannot prove uniform serialises every wgmma)
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == 1)
    producer<D, C>(&tq, &tk, &tv, p, qs, ring, ctl, b, h, q0, fc0);
  else
    consumer<D, C>(p, qs, ring, ctl, b, h, q0, fc0, p.lse != nullptr && g == 0);
}

// ---------------------------------------------------------------- host

// The Hopper K2's launch at a shape: output columns a block (64 or 128)
// and ring stages (1 or 2); columns 0 where the kernel does not take the
// shape (head dim outside 32/64/128, or R*D too wide for the q tile and two
// stages). A pure function of the shape, for bf16 operands TMA can
// describe: C = 128 where the grid then fills a wave of the card's SMs and
// shared memory allows, else 64; two stages, or one where the grid
// outgrows what two-stage blocks hold in one wave and one stage lets more
// blocks share an SM (the serving pass: two blocks an SM, one wave).
struct TiedPlan {
  int columns, stages;
};

__host__ inline int blocks_per_sm(long long smem) {
  return (int)(kSmemPerSM / (smem + 1024));
}

__host__ inline TiedPlan plan_shape(int batch, int rows, int heads, int nq, int head_dim) {
  if (head_dim != 32 && head_dim != 64 && head_dim != 128) return {0, 0};
  const int features = rows * head_dim;
  const long long tiles = (long long)batch * heads * ((nq + kRows - 1) / kRows);
  int columns = 64;
  if (smem_bytes(features, 128, 2) <= kSmemLimit && tiles * ((features + 127) / 128) >= kSMs)
    columns = 128;
  else if (smem_bytes(features, 64, 2) > kSmemLimit)
    return {0, 0};
  const long long blocks = tiles * ((features + columns - 1) / columns);
  const int two = blocks_per_sm(smem_bytes(features, columns, 2));
  const int one = blocks_per_sm(smem_bytes(features, columns, 1));
  return {columns, blocks > (long long)kSMs * two && one > two ? 1 : 2};
}

template <int D, int C>
__host__ inline Af2LaunchPlan plan_tied(int batch, int rows, int heads, int nq, int stages) {
  Af2LaunchPlan plan{};
  const int features = rows * D;
  plan.blocks = (long long)batch * heads * ((nq + kRows - 1) / kRows) * ((features + C - 1) / C);
  plan.threads = kThreads;
  plan.dynamic_smem = (int)smem_bytes(features, C, stages);
  name_kernel(plan, "tied_row_attention_kernel_sm90<%d,%d>", D, C);
  return plan;
}

// Launches tied_row_attention_kernel_sm90<D, C> on operands through their
// element strides (a.qs .. a.os: batch, head, token, row; K2's contiguous
// (B, R, N, H, D), or a (B, H, N, R*D) view of K1 read as rows); p.lse for
// the training forward; a.tie_scale null for a tie scale of 1; rows = R.
template <int D, int C>
__host__ inline cudaError_t launch_tied(const Problem& a, int rows, int stages,
                                        cudaStream_t stream) {
  const Af2LaunchPlan plan = plan_tied<D, C>(a.batch, rows, a.heads, a.nq, stages);
  if (!grid_fits(plan) || stages < 1 || stages > kMaxStages) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode_rows(&tq, a.q, a.qs, a.batch, a.heads, a.nq, rows, D, rows) ||
      !encode_rows(&tk, a.k, a.ks, a.batch, a.heads, a.nk, rows, D, rows) ||
      !encode_rows(&tv, a.v, a.vs, a.batch, a.heads, a.nk, rows, D, 1))
    return cudaErrorInvalidValue;
  TiedParams p;
  p.out = a.o;
  p.os = a.os;
  p.lse = a.lse;
  p.q_mask = a.q_mask;
  p.kv_mask = a.kv_mask;
  p.tie_scale = a.tie_scale;
  p.batch = a.batch;
  p.rows = rows;
  p.heads = a.heads;
  p.nq = a.nq;
  p.nk = a.nk;
  p.q_tiles = (a.nq + kRows - 1) / kRows;
  p.groups = (rows * D + C - 1) / C;
  p.stages = stages;
  p.scale_log2 = a.sm_scale * kLog2e;
  cudaError_t err =
      cudaFuncSetAttribute(tied_row_attention_kernel_sm90<D, C>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, plan.dynamic_smem);
  // all of the SM's 228 KB as shared memory, so that one-stage blocks share it
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tied_row_attention_kernel_sm90<D, C>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  tied_row_attention_kernel_sm90<D, C>
      <<<(unsigned)plan.blocks, plan.threads, plan.dynamic_smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace tied
}  // namespace sm90
}  // namespace af2
