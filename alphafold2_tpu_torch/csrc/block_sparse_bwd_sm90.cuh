// K5a/K5b's bf16 backward for Hopper (sm_90a): K3's Hopper kernels
// (fused_attention_bwd_sm90.cuh) on another source of tiles. Included by
// block_sparse_attention_bwd.cu, whose plan routes every bf16 problem at
// head dim 32, 64 or 128 with operands TMA can describe here, at every
// block size (16, 32, 64, 128).
//
// A block owns 64 consecutive rows of one (batch, head): queries in K5a
// (sparse_dq_kernel_sm90), keys in K5b (sparse_dkv_kernel_sm90). Those rows
// are 64 / bs resident blocks of the layout at bs = 16 or 32, one at 64, half
// of one at 128. The block streams the ascending union of its resident
// blocks' lists (row lists in K5a, column lists in K5b), built on the host
// (ops/cuda/block_sparse.py union_stages) as stages:
//
// * A stage holds 64 streamed rows: `slots` = 64 / min(bs, 64) listed blocks,
//   each its own TMA box of min(bs, 64) rows, written at row offset
//   slot * min(bs, 64) of the stage's tiles. The swizzle (128 bytes at head
//   dim 64 and 128, 64 at 32) repeats every 8 rows, so the boxes compose
//   into the 64-row swizzled tile the wgmma descriptors read. At block 128 a
//   listed block fills two ring stages (its two halves). All boxes of a
//   stage complete on the stage's one full barrier.
// * Each stage carries layout bits: bit slot * slots + r is set when
//   resident block r lists the slot's block. In the wgmma m64 accumulator
//   warp w holds rows 16w .. 16w + 15, that is resident block 16w / min(bs,
//   64). The producer turns the bits into one mask word set per warp (the
//   streamed rows that warp's rows may pair with) and the consumers of K3
//   read the set of their own warp (ControlT<4>): K5a ANDs it with the keys'
//   validity into K3a's key mask, K5b applies it as a column mask beside
//   K3b's query liveness (+inf lse). A pair outside the layout gets p = 0 by
//   select, never by a product, so its ds is 0 and it adds exactly 0.
// * A stage with fewer listed blocks than slots repeats its last listed
//   block in the empty slots with their bits 0: every slot holds finite
//   rows (an unwritten slot of shared memory could hold a NaN, and NaN * 0
//   is NaN in ds K or p^T dO), and each adds exactly 0.
// * Rows past N (a resident tile of the flat route's padded axis ends in
//   them) are zero-filled by TMA, masked, and never written.
//
// The rest is K3's: the producer warp's 3-stage mbarrier ring, dead stages
// skipped by ballot (no valid listed key in K5a, no live listed query in
// K5b), a block whose own rows are all dead writing zeros, S / dP by wgmma
// m64n64k16, p and ds rounded to bf16 into A fragments, K, Q and dO read
// MN-major through their descriptors, the spin-limit trap and the lane-0
// role broadcast.

#pragma once

#include "fused_attention_bwd_sm90.cuh"

namespace af2 {
namespace sm90 {
namespace grad {

constexpr int kConsumerWarps = 4;
using ListControl = ControlT<kConsumerWarps>;

// The union lists of one direction (row lists for K5a, column lists for
// K5b), on the device, as ops/cuda/block_sparse.py union_stages builds them.
struct ListParams {
  const int* blocks;  // (tiles, max_stages, slots) the listed block of each slot
  const int* bits;    // (tiles, max_stages) bit s * slots + r: resident block r lists slot s
  const int* counts;  // (tiles,) the stages of each 64-row tile
  int max_stages;
  int block;          // the layout's block size: 16, 32, 64 or 128
};

// The producer warp of K5a (kDkv false: resident q and dO, streamed k and v)
// and K5b (kDkv true: resident k and v, streamed q and dO with their lse and
// dsum slices), and of K4 (block_sparse_fwd_sm90.cuh: kDkv false with
// kResident 1, resident q alone, tr1 unused). r0: the block's first
// resident row, tile = r0 / 64.
template <int D, bool kDkv, int kResident = 2>
__device__ __forceinline__ void producer_listed(const CUtensorMap* tr0, const CUtensorMap* tr1,
                                                const CUtensorMap* ts0, const CUtensorMap* ts1,
                                                const GradParams& p, const ListParams& lp,
                                                unsigned char* res, unsigned char* ring,
                                                ListControl& ctl, int b, int h, int bh, int r0,
                                                int tile) {
  static_assert(kResident == 1 || kResident == 2, "one or two resident tiles");
  using C = Cfg<D>;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_arrive_expect_tx(&ctl.resbar, kResident * C::kTile);
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) {
      tma_load_4d(res + c * C::kChunk, tr0, &ctl.resbar, c * C::CW, r0, h, b);
      if constexpr (kResident == 2)
        tma_load_4d(res + C::kTile + c * C::kChunk, tr1, &ctl.resbar, c * C::CW, r0, h, b);
    }
  }
  const int bs = lp.block;
  const int box = bs < kRows ? bs : kRows;         // rows of one slot's TMA box
  const int slots = kRows / box;                   // listed blocks a stage
  const int halves = bs > kRows ? bs / kRows : 1;  // ring stages a listed stage
  const uint32_t own = (1u << slots) - 1u;
  // this lane's two stage rows, lane and lane + 32: their slots and offsets
  const int s0 = lane / box, s1 = (lane + 32) / box;
  const int o0 = lane % box, o1 = (lane + 32) % box;
  const int count = lp.counts[tile];
  const int* blocks = lp.blocks + (long long)tile * lp.max_stages * slots;
  const int* bits = lp.bits + (long long)tile * lp.max_stages;
  int it = 0;
  for (int a = 0; a < count; ++a) {
    const uint32_t lb = (uint32_t)bits[a];
    // the resident blocks that list this lane's rows
    const uint32_t l0 = (lb >> (s0 * slots)) & own, l1 = (lb >> (s1 * slots)) & own;
    const int blk0 = blocks[a * slots + s0], blk1 = blocks[a * slots + s1];
    for (int half = 0; half < halves; ++half) {
      const int n0 = blk0 * bs + half * kRows + o0, n1 = blk1 * bs + half * kRows + o1;
      float lse0 = 0.f, lse1 = 0.f;
      bool live0, live1;
      if (kDkv) {
        lse0 = live_lse2(p, b, bh, n0);
        lse1 = live_lse2(p, b, bh, n1);
        live0 = lse0 < CUDART_INF_F;
        live1 = lse1 < CUDART_INF_F;
      } else {
        live0 = key_live(p, b, n0);
        live1 = key_live(p, b, n1);
      }
      // per consumer warp: K5a the valid listed keys; K5b the listed
      // queries (their liveness travels as +inf lse)
      uint32_t words[kConsumerWarps][kMaskWords];
      uint32_t any = 0;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) {
        const int rb = 16 * w / box;  // warp w's resident block
        const bool in0 = (l0 >> rb) & 1u, in1 = (l1 >> rb) & 1u;
        words[w][0] = __ballot_sync(0xffffffffu, in0 && (kDkv || live0));
        words[w][1] = __ballot_sync(0xffffffffu, in1 && (kDkv || live1));
        any |= kDkv ? __ballot_sync(0xffffffffu, (in0 && live0) || (in1 && live1))
                    : words[w][0] | words[w][1];
      }
      if (any == 0) continue;  // nothing listed is live: the stage adds nothing
      const int st = it % C::kStages;
      mbar_wait(&ctl.empty[st], ((it / C::kStages) & 1) ^ 1);
      if (kDkv) {
        const float* dsum = p.dsum + (long long)bh * p.nq;
        ctl.lse[st][lane] = lse0;
        ctl.lse[st][32 + lane] = lse1;
        ctl.dsum[st][lane] = live0 ? dsum[n0] : 0.f;
        ctl.dsum[st][32 + lane] = live1 ? dsum[n1] : 0.f;
      }
      unsigned char* stage = ring + st * 2 * C::kTile;
      if (lane == 0) {
#pragma unroll
        for (int w = 0; w < kConsumerWarps; ++w) {
          ctl.mask[st][w][0] = words[w][0];
          ctl.mask[st][w][1] = words[w][1];
        }
        ctl.tile[st] = a;
        mbar_arrive_expect_tx(&ctl.full[st], 2 * C::kTile);
        for (int s = 0; s < slots; ++s) {
          const int n = blocks[a * slots + s] * bs + half * kRows;
          const int off = s * box * C::SWB;
#pragma unroll
          for (int c = 0; c < C::NCH; ++c) {
            tma_load_4d(stage + c * C::kChunk + off, ts0, &ctl.full[st], c * C::CW, n, h, b);
            tma_load_4d(stage + C::kTile + c * C::kChunk + off, ts1, &ctl.full[st], c * C::CW,
                        n, h, b);
          }
        }
      } else {
        mbar_arrive(&ctl.full[st]);
      }
      ++it;
    }
  }
  const int st = it % C::kStages;  // the end of the stream
  mbar_wait(&ctl.empty[st], ((it / C::kStages) & 1) ^ 1);
  if (lane == 0) ctl.tile[st] = -1;
  mbar_arrive(&ctl.full[st]);
}

// K5a: one block per (batch * head, 64-query tile).
template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
    sparse_dq_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const GradParams p,
                          const ListParams lp) {
  using C = Cfg<D>;
  extern __shared__ unsigned char grad_smem[];
  unsigned char* res = align1024(grad_smem);  // Q, then dO
  unsigned char* ring = res + 2 * C::kTile;   // stages of gathered K, then V
  ListControl& ctl = *reinterpret_cast<ListControl*>(ring + 2 * C::kStages * C::kTile);

  const int qt = (int)(blockIdx.x % p.tiles);
  const int bh = (int)(blockIdx.x / p.tiles);
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = qt * kRows;

  const bool live = threadIdx.x < kRows && live_lse2(p, b, bh, q0 + (int)threadIdx.x) <
                                               CUDART_INF_F;
  if (!__syncthreads_or(live)) {  // every query row dead: dq = 0, no key read
    zero_rows<D>(p, 1, b, h, bh, q0, p.nq, 0);
    return;
  }
  init_ring<D>(ctl);
  // the role, broadcast from lane 0 so that ptxas sees the branch as
  // warp-uniform (a branch it cannot prove uniform serialises every wgmma)
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == 1)
    producer_listed<D, false>(&tq, &tdo, &tk, &tv, p, lp, res, ring, ctl, b, h, bh, q0, qt);
  else
    consumer_dq<D, kConsumerWarps>(p, res, ring, ctl, b, h, bh, q0, 0);
}

// K5b: one block per (batch * head, 64-key tile).
template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
    sparse_dkv_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const GradParams p,
                           const ListParams lp) {
  using C = Cfg<D>;
  extern __shared__ unsigned char grad_smem[];
  unsigned char* res = align1024(grad_smem);  // K, then V
  unsigned char* ring = res + 2 * C::kTile;   // stages of gathered Q, then dO
  ListControl& ctl = *reinterpret_cast<ListControl*>(ring + 2 * C::kStages * C::kTile);

  const int kt = (int)(blockIdx.x % p.tiles);
  const int bh = (int)(blockIdx.x / p.tiles);
  const int b = bh / p.heads, h = bh % p.heads;
  const int k0 = kt * kRows;

  const bool live = threadIdx.x < kRows && key_live(p, b, k0 + (int)threadIdx.x);
  if (!__syncthreads_or(live)) {  // every key masked: dk = dv = 0, no query read
    zero_rows<D>(p, 2, b, h, bh, k0, p.nk, 0);
    return;
  }
  init_ring<D>(ctl);
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == 1)
    producer_listed<D, true>(&tk, &tv, &tq, &tdo, p, lp, res, ring, ctl, b, h, bh, k0, kt);
  else
    consumer_dkv<D, kConsumerWarps>(p, res, ring, ctl, b, h, bh, k0, 0);
}

// ---------------------------------------------------------------- host

// The union lists of one direction as the kernels take them.
__host__ inline ListParams list_params(const int* blocks, const int* bits, const int* counts,
                                       int max_stages, int block) {
  ListParams lists;
  lists.blocks = blocks;
  lists.bits = bits;
  lists.counts = counts;
  lists.max_stages = max_stages;
  lists.block = block;
  return lists;
}

template <int D>
__host__ inline Af2LaunchPlan plan_listed(bool dkv, int batch, int heads, int n) {
  Af2LaunchPlan plan{};
  plan.blocks = (long long)batch * heads * ((n + kRows - 1) / kRows);
  plan.threads = kThreads;
  plan.dynamic_smem = smem_bytes<D, kConsumerWarps>();
  name_kernel(plan, dkv ? "sparse_dkv_kernel_sm90<%d>" : "sparse_dq_kernel_sm90<%d>", D);
  return plan;
}

// Launches sparse_dq_kernel_sm90 (K5a) or sparse_dkv_kernel_sm90 (K5b) on one
// self-attention problem (a.nq = a.nk = N); `lists` are the union lists of
// the direction (rows for K5a, columns for K5b).
template <int D>
__host__ inline cudaError_t launch_listed(bool dkv, const GradOperands& a, const ListParams& lists,
                                          cudaStream_t stream) {
  const Af2LaunchPlan plan = plan_listed<D>(dkv, a.batch, a.heads, a.nq);
  const int bs = lists.block;
  if (!grid_fits(plan) || a.nq != a.nk || lists.blocks == nullptr || lists.bits == nullptr ||
      lists.counts == nullptr || lists.max_stages < 1 ||
      (bs != 16 && bs != 32 && bs != 64 && bs != 128) || a.nq % bs != 0)
    return cudaErrorInvalidValue;
  const int box = bs < kRows ? bs : kRows;
  // resident operands in 64-row boxes, streamed ones in boxes of one slot
  CUtensorMap tq, tdo, tk, tv;
  const int q_rows = dkv ? box : kRows, k_rows = dkv ? kRows : box;
  if (!encode_bf16(&tq, a.q, a.qs, a.batch, a.heads, a.nq, D, q_rows) ||
      !encode_bf16(&tdo, a.dout, a.dos, a.batch, a.heads, a.nq, D, q_rows) ||
      !encode_bf16(&tk, a.k, a.ks, a.batch, a.heads, a.nk, D, k_rows) ||
      !encode_bf16(&tv, a.v, a.vs, a.batch, a.heads, a.nk, D, k_rows))
    return cudaErrorInvalidValue;
  GradParams p{};
  p.lse = a.lse;
  p.dsum = a.dsum;
  p.q_mask = nullptr;
  p.kv_mask = a.kv_mask;
  p.out0 = a.out0;
  p.out1 = a.out1;
  p.part = nullptr;
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
  p.tiles = (a.nq + kRows - 1) / kRows;
  p.long_tiles = 0;
  p.splits = 1;
  p.sm_scale = a.sm_scale;
  p.scale_log2 = a.sm_scale * kLog2e;
  const unsigned blocks = (unsigned)plan.blocks;
  const int smem = plan.dynamic_smem;
  cudaError_t err;
  if (dkv) {
    err = cudaFuncSetAttribute(sparse_dkv_kernel_sm90<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    sparse_dkv_kernel_sm90<D><<<blocks, kThreads, smem, stream>>>(tq, tdo, tk, tv, p, lists);
  } else {
    err = cudaFuncSetAttribute(sparse_dq_kernel_sm90<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    sparse_dq_kernel_sm90<D><<<blocks, kThreads, smem, stream>>>(tq, tdo, tk, tv, p, lists);
  }
  return cudaGetLastError();
}

}  // namespace grad
}  // namespace sm90
}  // namespace af2
