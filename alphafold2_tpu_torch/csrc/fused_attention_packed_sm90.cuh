// K1's bf16 forward on short problems, redesigned for Hopper (sm_90a):
// several problems of one head packed into one 128 x 128 tile, walked by
// persistent blocks. Included by fused_attention.cu, whose plan routes here
// every bf16 problem at head dim 32, 64 or 128 with fewer than 64 queries
// and fewer than 64 keys whose operands TMA can describe; every other bf16
// problem keeps attention_kernel_sm90 (fused_attention_sm90.cuh) or
// attention_kernel_mma.
//
// Replaces the TPU kernel alphafold2_tpu/ops/pallas/axial.py `_run`
// (pallas_call at :249, body `_fwd_core` :56) on the shapes where a problem
// is a handful of tokens: the template axis (147,456 x 8 problems of 5 x 5
// at crop 384 with 4 templates), the MSA column pass (5, 8 or 16 keys).
// The masking contract is K1's, per problem: a masked key weighs 0; a
// masked query, or a row with no valid key, gives exactly 0; with lse each
// row's logsumexp over its valid keys, +inf for a row with none.
//
// What bounds it: at 5 x 5 x 64 a problem does 6,400 multiply-adds against
// 2,560 bytes of q, k, v and output, far under the card's ridge, so the
// bytes bound it (0.902 ms for the template axis's 3.02 GB on an H100).
// attention_kernel_sm90 ran one 288-thread block per (problem, head), each
// paying barrier setup, three TMA boxes and a 64 x 128 S per warpgroup for
// 5 real rows and keys; 1.18 M blocks took 41 ms. The design:
//
// * Packing. A tile holds G consecutive problems (batch entries) of one
//   head: Gh = floor(64 / nq) a consumer warpgroup's 64 query rows, G =
//   min(2 Gh, floor(128 / nk)) in all, so that their G*nk keys fit one
//   128-key stage (24 problems at n = 5, 8 at 16). One 4-D TMA box {CW, n,
//   1, problems} of the operand's own (B, H, N, D) map lands the problems'
//   rows one after another, whatever the batch and token strides: the
//   projections' (B, n, H*D) rows and the training path's grid-strided
//   column views alike. Rows past a tile's problems are never loaded; the
//   ring is zeroed once when the block starts, so they stay 0 (a P of 0
//   times a stale V row could be NaN), and past B TMA fills zeros.
// * Block-diagonal mask. Warpgroup row r belongs to problem p = w Gh +
//   r / nq and sees key c only if c / nk = p and the key's kv_mask bit is
//   set. The bits are staged beside each tile as four 32-bit words (one
//   ballot each over the mask bytes, keys past B*nk invalid); each thread
//   keeps its two rows' key windows in registers and tests a key with one
//   unsigned compare (softmax_rows with a per-row validity).
// * One key tile a problem set. The whole softmax is one tile: no online
//   rescale, no running max carried across tiles. A row starts at a finite
//   max (-FLT_MAX), so a row with no valid key comes out with l = 0 and
//   o = 0 instead of a NaN; its lse is then +inf.
// * Setup paid per block, not per tile. One block an SM (kStages stages
//   of q, K and V fill 192 KB of shared memory), two consumer warpgroups
//   and one producer warp, 288 threads; block i walks tiles i, i + grid,
//   ... with the heads of one problem set adjacent, so neighbouring blocks
//   read neighbouring bytes. The producer keeps up to kStages tiles in
//   flight (q, K, V and the mask words), so a tile's loads overlap the
//   previous tiles' products and stores.
// * The products are K1's: qk_tile (one wgmma m64n128k16 a 16-feature
//   step), pv_tile (P as bf16 A fragments from registers, V read MN-major),
//   and store_rows (the output staged in the warpgroup's q half of the
//   stage, each row written by 16-byte stores to its (batch, token), rows
//   past the tile's problems or past B never written). The stage is
//   released after a proxy fence, since the producer's next TMA load
//   overwrites the staged output.

#pragma once

#include <cfloat>

#include "fused_attention_sm90.cuh"

namespace af2 {
namespace sm90 {
namespace packed {

constexpr int kRows = 128;         // query rows and keys a tile (kBlockM, kBlockN)
constexpr int kMaxN = 63;          // longest problem: two share a tile at least
constexpr int kMaxStages = 8;      // the ring's stages at head dim 32
constexpr int kRingBytes = 196608;  // 192 KB of stages: one block an SM
constexpr int kSMs = 132;          // the H100 SXM's: the persistent grid

template <int D>
struct PCfg {
  using C = Cfg<D>;
  static constexpr int kStageBytes = kConsumers * C::kQBytes + 2 * C::kKVBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;  // 8, 4, 2 at D 32, 64, 128
  static_assert(kStages >= 2 && kStages <= kMaxStages, "stages");
};

struct PackedControl {
  uint64_t full[kMaxStages];
  uint64_t empty[kMaxStages];
  uint32_t mask[kMaxStages][kMaskWords];
  int tile[kMaxStages];  // the staged tile, -1 ends the stream
  // warpgroup row r is token tok[r] of the warpgroup's problem prob[r]
  // (r / nq, r % nq, set once: the epilogue's rows without a division)
  unsigned char prob[64];
  unsigned char tok[64];
};

template <int D>
constexpr int smem_bytes() {
  return 1024 + PCfg<D>::kStages * PCfg<D>::kStageBytes + (int)sizeof(PackedControl);
}

struct PackedParams {
  void* out;     // bf16 (B, H, nq, D) through osb, osh, osn
  float* lse;    // (B, H, nq) f32, or null
  const unsigned char* q_mask;   // (B, nq) 0/1, or null
  const unsigned char* kv_mask;  // (B, nk) 0/1, or null
  long long osb, osh, osn;
  int batch, heads, nq, nk;
  int half;   // Gh: problems of one warpgroup's 64 query rows
  int group;  // G: problems a tile
  int tiles;  // heads * ceil(B / G)
  float scale_log2;  // sm_scale * log2(e)
};

// The producer warp: each of the block's tiles as one stage (q as two
// boxes of Gh problems, one a warpgroup's 64-row half, K and V as one box
// of G problems each, per CW-wide chunk), with its keys' validity; then the
// end of the stream.
template <int D>
__device__ __forceinline__ void producer(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, const PackedParams& p,
                                         unsigned char* ring, PackedControl& ctl) {
  using C = Cfg<D>;
  using P = PCfg<D>;
  const int lane = threadIdx.x & 31;
  // the bytes the boxes land: TMA counts a box's zero fill past B too
  const uint32_t bytes = 2u * D * (kConsumers * p.half * p.nq + 2 * p.group * p.nk);
  const long long keys = (long long)p.batch * p.nk;
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
    const int set = tile / p.heads, h = tile % p.heads;
    const int b0 = set * p.group;  // the tile's first problem
    const long long k0 = (long long)b0 * p.nk;
    uint32_t words[kMaskWords];
#pragma unroll
    for (int w = 0; w < kMaskWords; ++w) {
      const int c = 32 * w + lane;  // key c of the tile: problem c / nk
      words[w] = __ballot_sync(0xffffffffu, c < p.group * p.nk && k0 + c < keys &&
                                                (p.kv_mask == nullptr || p.kv_mask[k0 + c] != 0));
    }
    const int st = it % P::kStages;
    mbar_wait(&ctl.empty[st], ((it / P::kStages) & 1) ^ 1);
#pragma unroll
    for (int w = 0; w < kMaskWords; ++w)
      if (lane == w) ctl.mask[st][w] = words[w];
    if (lane == 0) {
      ctl.tile[st] = tile;
      unsigned char* qs = ring + st * P::kStageBytes;
      unsigned char* ks = qs + kConsumers * C::kQBytes;
      unsigned char* vs = ks + C::kKVBytes;
      mbar_arrive_expect_tx(&ctl.full[st], bytes);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
#pragma unroll
        for (int w = 0; w < kConsumers; ++w)
          tma_load_4d(qs + w * C::kQBytes + c * 64 * C::SWB, tq, &ctl.full[st], c * C::CW, 0, h,
                      b0 + w * p.half);
        tma_load_4d(ks + c * kRows * C::SWB, tk, &ctl.full[st], c * C::CW, 0, h, b0);
        tma_load_4d(vs + c * kRows * C::SWB, tv, &ctl.full[st], c * C::CW, 0, h, b0);
      }
    } else {
      mbar_arrive(&ctl.full[st]);
    }
  }
  const int st = it % P::kStages;  // the end of the stream
  mbar_wait(&ctl.empty[st], ((it / P::kStages) & 1) ^ 1);
  if (lane == 0) ctl.tile[st] = -1;
  mbar_arrive(&ctl.full[st]);
}

// One consumer warpgroup: problems wg Gh .. wg Gh + Gh - 1 of each tile, in
// its 64 query rows.
template <int D>
__device__ __forceinline__ void consumer(const PackedParams& p, unsigned char* ring,
                                         PackedControl& ctl, int wg) {
  using C = Cfg<D>;
  using P = PCfg<D>;
  const int wt = threadIdx.x % 128;
  const int lane = wt & 31, t = lane & 3;
  const int lrow = 16 * (wt / 32) + (lane >> 2);  // this thread's rows: lrow, lrow + 8

  // the warpgroup's problems of a tile, and each of the thread's rows' key
  // window, the same in every tile: row r sees the tile's keys [lo, lo +
  // len); the window is kept shifted by 2t, so a thread's key 8j + 2t + e
  // is in it when 8j + e - lo is below len
  const int p0 = wg * p.half, mine = min(p.half, p.group - p0);
  int lo[2], len[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pr = (lrow + 8 * r) / p.nq;
    live[r] = pr < mine;
    lo[r] = (p0 + pr) * p.nk - 2 * t;
    len[r] = live[r] ? p.nk : 0;
  }
  // store_rows's view of the output (the lse is written below)
  Params sp{};
  sp.out = p.out;
  sp.q_mask = p.q_mask;
  sp.osb = p.osb;
  sp.osh = p.osh;
  sp.osn = p.osn;
  sp.nq = p.nq;
  const bool neg = p.scale_log2 < 0.f;

  for (int it = 0;; ++it) {
    const int st = it % P::kStages;
    mbar_wait(&ctl.full[st], (it / P::kStages) & 1);
    const int tile = __shfl_sync(0xffffffffu, ctl.tile[st], 0);  // uniform, as `role`
    if (tile < 0) break;
    const int set = tile / p.heads, h = tile % p.heads;
    const int b0 = set * p.group + p0;  // the warpgroup's first problem
    unsigned char* qw = ring + st * P::kStageBytes + wg * C::kQBytes;
    const uint32_t kaddr = smem_u32(ring + st * P::kStageBytes + kConsumers * C::kQBytes);
    const uint32_t vaddr = kaddr + C::kKVBytes;

    float s[kRows / 2];  // [4j + 2r + e]: row lrow + 8r, key 8j + 2t + e of the tile
    wgmma_fence();
    qk_tile<D, kRows>(s, smem_u32(qw), kaddr);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);

    uint32_t mw[kMaskWords];
#pragma unroll
    for (int w = 0; w < kMaskWords; ++w) mw[w] = ctl.mask[st][w] >> (2 * t);
    const auto valid = [&](int r, int j, int e) {
      return (unsigned)(8 * j + e - lo[r]) < (unsigned)len[r] &&
             ((mw[j / 4] >> (8 * (j % 4) + e)) & 1u) != 0;
    };
    float o[C::NCH][C::CW / 2];
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
#pragma unroll
      for (int i = 0; i < C::CW / 2; ++i) o[c][i] = 0.f;
    float m_run[2] = {-FLT_MAX, -FLT_MAX}, l_run[2] = {0.f, 0.f};
    if (neg) softmax_rows<true, true>(s, valid, p.scale_log2, m_run, l_run, o);
    else softmax_rows<true, false>(s, valid, p.scale_log2, m_run, l_run, o);

    wgmma_fence();
    pv_tile<D, kRows>(o, s, vaddr);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) fence_operands(o[c]);

    // warpgroup row lr is token lr % nq of problem b0 + lr / nq
    const auto row = [&](int lr, int& b, int& n) {
      const int pr = ctl.prob[lr];
      b = b0 + pr;
      n = ctl.tok[lr];
      return pr < mine && b < p.batch;
    };
    if (p.lse != nullptr && t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int b, n;
        if (row(lrow + 8 * r, b, n))
          p.lse[((long long)b * p.heads + h) * p.nq + n] =
              l_run[r] == 0.f ? CUDART_INF_F : m_run[r] * kLn2 + logf(l_run[r]);
      }
    }
    store_rows<D>(sp, qw, m_run, l_run, o, h, 0, 1 + wg, row);
    fence_proxy_async();
    mbar_arrive(&ctl.empty[st]);
  }
}

// A persistent grid of at most kSMs blocks (one an SM); see the file's
// header for the walk.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attention_packed_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv, const PackedParams p) {
  using P = PCfg<D>;
  extern __shared__ unsigned char packed_smem[];
  unsigned char* ring = align1024(packed_smem);
  PackedControl& ctl = *reinterpret_cast<PackedControl*>(ring + P::kStages * P::kStageBytes);

  // rows no box lands in stay 0 for the block's life
  for (int i = threadIdx.x; i < P::kStages * P::kStageBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  if (threadIdx.x < 64) {
    ctl.prob[threadIdx.x] = (unsigned char)(threadIdx.x / p.nq);
    ctl.tok[threadIdx.x] = (unsigned char)(threadIdx.x % p.nq);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&ctl.full[s], 32);                  // the producer warp
      mbar_init(&ctl.empty[s], kConsumers * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, broadcast from lane 0 so that ptxas sees the role
  // branch as warp-uniform
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == kConsumers)
    producer<D>(&tq, &tk, &tv, p, ring, ctl);
  else
    consumer<D>(p, ring, ctl, role);
}

// ---------------------------------------------------------------- host

// Problems of one warpgroup's 64 query rows, and of a tile: Gh = 64 / nq,
// G = min(2 Gh, 128 / nk).
__host__ inline int half(int nq) { return 64 / nq; }

__host__ inline int group(int nq, int nk) {
  const int gq = 2 * half(nq), gk = kRows / nk;
  return gq < gk ? gq : gk;
}

// Does the packed kernel take this shape (bf16 and operands TMA can
// describe are the caller's test)? Head dim 32, 64 or 128; fewer than 64
// queries and keys.
__host__ inline bool takes_shape(int features, int nq, int nk) {
  return (features == 32 || features == 64 || features == 128) && nq >= 1 && nk >= 1 &&
         nq <= kMaxN && nk <= kMaxN;
}

template <int D>
__host__ inline Af2LaunchPlan plan_packed(int batch, int heads, int nq, int nk) {
  const int g = group(nq, nk);
  const long long tiles = (long long)heads * ((batch + g - 1) / g);
  Af2LaunchPlan plan{};
  plan.blocks = tiles < kSMs ? tiles : kSMs;
  plan.threads = kThreads;
  plan.dynamic_smem = smem_bytes<D>();
  name_kernel(plan, "attention_packed_kernel_sm90<%d>", D);
  return plan;
}

template <int D>
__host__ inline cudaError_t launch_packed(const Problem& a, cudaStream_t stream) {
  const Af2LaunchPlan plan = plan_packed<D>(a.batch, a.heads, a.nq, a.nk);
  const int g = group(a.nq, a.nk), gh = half(a.nq);
  const long long tiles = (long long)a.heads * ((a.batch + g - 1) / g);
  if (!grid_fits(plan) || tiles > 2147483647LL || !takes_shape(D, a.nq, a.nk))
    return cudaErrorInvalidConfiguration;
  CUtensorMap tq, tk, tv;
  if (!encode_bf16(&tq, a.q, a.qs, a.batch, a.heads, a.nq, D, a.nq, gh) ||
      !encode_bf16(&tk, a.k, a.ks, a.batch, a.heads, a.nk, D, a.nk, g) ||
      !encode_bf16(&tv, a.v, a.vs, a.batch, a.heads, a.nk, D, a.nk, g))
    return cudaErrorInvalidValue;
  PackedParams p;
  p.out = a.o;
  p.lse = a.lse;
  p.q_mask = a.q_mask;
  p.kv_mask = a.kv_mask;
  p.osb = a.os.sb;
  p.osh = a.os.sh;
  p.osn = a.os.sn;
  p.batch = a.batch;
  p.heads = a.heads;
  p.nq = a.nq;
  p.nk = a.nk;
  p.half = gh;
  p.group = g;
  p.tiles = (int)tiles;
  p.scale_log2 = a.sm_scale * 1.4426950408889634f;
  const cudaError_t err = cudaFuncSetAttribute(
      attention_packed_kernel_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      plan.dynamic_smem);
  if (err != cudaSuccess) return err;
  attention_packed_kernel_sm90<D><<<(unsigned)plan.blocks, plan.threads, plan.dynamic_smem,
                                    stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace packed
}  // namespace sm90
}  // namespace af2
