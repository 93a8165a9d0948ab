// K4's bf16 forward for Hopper (sm_90a): K1's Hopper consumer pieces
// (fused_attention_sm90.cuh) on K5a's source of tiles (block_sparse_bwd_sm90.cuh).
// Included by block_sparse_attention.cu, whose plan routes every bf16
// problem at head dim 32, 64 or 128 with operands TMA can describe here, at
// every block size (16, 32, 64, 128), with and without lse.
//
// A block owns 64 consecutive query rows of one (batch, head): 64 / bs
// query blocks of the layout at bs = 16 or 32, one at 64, half of one at
// 128. It streams the ascending union of their key lists, the row lists of
// ops/cuda/block_sparse.py union_stages (BlockLayout.row_union, the lists
// K5a streams), through K5a's producer warp (producer_listed with one
// resident tile, q):
//
// * A stage holds 64 keys, `slots` = 64 / min(bs, 64) listed blocks, each
//   its own TMA box; all boxes of a stage complete on its one full barrier.
//   At block 128 a listed block fills two stages.
// * Per-warp masks: warp w of the consumer warpgroup holds rows 16w .. 16w
//   + 15 in the wgmma m64 accumulator, that is resident block 16w / min(bs,
//   64). The producer ANDs each stage's layout bits for that block with the
//   keys' validity (kv_mask; keys past N invalid) into one mask word set a
//   warp. A pair outside the layout weighs exactly 0 by select.
// * A stage with no valid listed key for any warp is never staged; a
//   stage's empty slots repeat its last listed block with bits 0, so every
//   slot holds finite keys and adds exactly 0.
// * Rows past N (the flat route's padded last tile) are zero-filled by TMA
//   and never written.
//
// The consumer warpgroup runs K1's pieces on each 64-key stage: S = Q K^T
// by wgmma m64n64k16 from shared memory (qk_tile), the online softmax in
// log2 units with one FMA and one ex2 a logit and no mask arithmetic where
// a warp's 64 keys are all valid and listed (softmax_tile), P rounded to
// bf16 into A fragments against V read MN-major through its descriptor
// (pv_tile), and the lse and 16-byte store epilogue (store_out). Where
// this warp's rows have no valid key in a stage that another warp's rows
// need, its m may still be -inf, and softmax_tile would take 2^(-inf + inf)
// = NaN for alpha: such a warp sets p = 0 and keeps m, l and O as they are
// (alpha = 1), and still issues its share of the warpgroup's P V wgmma with
// those zero fragments. A row with no valid key at all writes 0 and lse
// +inf.
//
// Block: one consumer warpgroup and one producer warp (160 threads), the
// q tile and a ring of kStages (3 at head dim <= 64, 2 at 128) K and V
// stages: 60,080 bytes of shared memory at head dim 64, so three blocks
// share an SM (the register bound asks ptxas for three).

#pragma once

#include "block_sparse_bwd_sm90.cuh"
#include "fused_attention_sm90.cuh"

namespace af2 {
namespace sm90 {

constexpr int kSparseRows = grad::kRows;  // query rows a block, keys a stage

template <int D>
constexpr int sparse_fwd_smem_bytes() {
  return 1024 + (1 + 2 * grad::Cfg<D>::kStages) * grad::Cfg<D>::kTile +
         (int)sizeof(grad::ListControl);
}

// blocks an SM: three at head dim <= 64 (shared memory allows three), two at 128
constexpr int sparse_fwd_min_blocks(int d) { return d <= 64 ? 3 : 2; }

// The consumer warpgroup of K4: rows q0 .. q0 + 63 of (b, h), the q tile at
// qs, the stages of K, then V, in the ring.
template <int D>
__device__ __forceinline__ void sparse_fwd_consumer(const Params& p, unsigned char* qs,
                                                    unsigned char* ring, grad::ListControl& ctl,
                                                    int b, int h, int bh, int q0) {
  using C = Cfg<D>;
  using G = grad::Cfg<D>;
  constexpr int N = kSparseRows;  // keys a stage
  const int warp = (int)threadIdx.x >> 5, t = threadIdx.x & 3;

  float o[C::NCH][C::CW / 2];
#pragma unroll
  for (int c = 0; c < C::NCH; ++c)
#pragma unroll
    for (int i = 0; i < C::CW / 2; ++i) o[c][i] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};
  const bool neg = p.scale_log2 < 0.f;

  const uint32_t qaddr = smem_u32(qs);
  mbar_wait(&ctl.resbar, 0);
  for (int it = 0;; ++it) {
    const int st = it % G::kStages;
    mbar_wait(&ctl.full[st], (it / G::kStages) & 1);
    if (__shfl_sync(0xffffffffu, ctl.tile[st], 0) < 0) break;  // uniform, as `role`
    const uint32_t kaddr = smem_u32(ring + st * 2 * G::kTile), vaddr = kaddr + G::kTile;

    float s[N / 2];  // [4j + 2r + e]: row lrow + 8r, key 8j + 2t + e of the stage
    wgmma_fence();
    qk_tile<D, N>(s, qaddr, kaddr);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);

    // this warp's keys: listed by its rows' block and valid
    const uint32_t m0 = ctl.mask[st][warp][0], m1 = ctl.mask[st][warp][1];
    const uint32_t mw[N / 32] = {m0 >> (2 * t), m1 >> (2 * t)};
    // 0: no key for this warp's rows, 1: some, 2: all 64 (broadcast from
    // lane 0, so that ptxas sees the branches as warp-uniform)
    const int kind = __shfl_sync(0xffffffffu, (m0 | m1) == 0u ? 0 : (m0 & m1) == ~0u ? 2 : 1, 0);
    if (kind == 0) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) s[i] = 0.f;  // p = 0; m, l and O unchanged
    } else if (kind == 2) {
      if (neg) softmax_tile<false, true>(s, mw, p.scale_log2, m_run, l_run, o);
      else softmax_tile<false, false>(s, mw, p.scale_log2, m_run, l_run, o);
    } else {
      if (neg) softmax_tile<true, true>(s, mw, p.scale_log2, m_run, l_run, o);
      else softmax_tile<true, false>(s, mw, p.scale_log2, m_run, l_run, o);
    }

    wgmma_fence();
    pv_tile<D, N>(o, s, vaddr);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) fence_operands(o[c]);
    mbar_arrive(&ctl.empty[st]);
  }
  store_out<D>(p, qs, m_run, l_run, o, b, h, bh, q0, 1);
}

// K4: one block per (batch * head, 64-query tile).
template <int D>
__global__ void __launch_bounds__(grad::kThreads, sparse_fwd_min_blocks(D))
    sparse_fwd_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Params p,
                           const grad::GradParams gp, const grad::ListParams lp) {
  using G = grad::Cfg<D>;
  extern __shared__ unsigned char sparse_fwd_smem[];
  unsigned char* res = align1024(sparse_fwd_smem);  // q
  unsigned char* ring = res + G::kTile;              // stages of gathered K, then V
  grad::ListControl& ctl =
      *reinterpret_cast<grad::ListControl*>(ring + 2 * G::kStages * G::kTile);

  const int qt = (int)(blockIdx.x % p.q_tiles);
  const int bh = (int)(blockIdx.x / p.q_tiles);
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = qt * kSparseRows;

  grad::init_ring<D>(ctl);
  // the role, broadcast from lane 0 so that ptxas sees the branch as
  // warp-uniform (a branch it cannot prove uniform serialises every wgmma)
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == 1)
    grad::producer_listed<D, false, 1>(&tq, nullptr, &tk, &tv, gp, lp, res, ring, ctl, b, h, bh,
                                       q0, qt);
  else
    sparse_fwd_consumer<D>(p, res, ring, ctl, b, h, bh, q0);
}

// ---------------------------------------------------------------- host

template <int D>
__host__ inline Af2LaunchPlan plan_sparse_fwd(int batch, int heads, int n) {
  Af2LaunchPlan plan{};
  plan.blocks = (long long)batch * heads * ((n + kSparseRows - 1) / kSparseRows);
  plan.threads = grad::kThreads;
  plan.dynamic_smem = sparse_fwd_smem_bytes<D>();
  name_kernel(plan, "sparse_fwd_kernel_sm90<%d>", D);
  return plan;
}

// Launches sparse_fwd_kernel_sm90 on one self-attention problem (a.nq =
// a.nk = N, a.lse set for the training forward); `lists` are the union of
// the row lists per 64-query tile.
template <int D>
__host__ inline cudaError_t launch_sparse_fwd(const Problem& a, const grad::ListParams& lists,
                                              cudaStream_t stream) {
  const Af2LaunchPlan plan = plan_sparse_fwd<D>(a.batch, a.heads, a.nq);
  const int bs = lists.block;
  if (!grid_fits(plan) || a.nq != a.nk || lists.blocks == nullptr || lists.bits == nullptr ||
      lists.counts == nullptr || lists.max_stages < 1 ||
      (bs != 16 && bs != 32 && bs != 64 && bs != 128) || a.nq % bs != 0)
    return cudaErrorInvalidValue;
  const int box = bs < kSparseRows ? bs : kSparseRows;
  // q in 64-row boxes, the streamed k and v in boxes of one slot
  CUtensorMap tq, tk, tv;
  if (!encode_bf16(&tq, a.q, a.qs, a.batch, a.heads, a.nq, D, kSparseRows) ||
      !encode_bf16(&tk, a.k, a.ks, a.batch, a.heads, a.nk, D, box) ||
      !encode_bf16(&tv, a.v, a.vs, a.batch, a.heads, a.nk, D, box))
    return cudaErrorInvalidValue;
  Params p{};
  p.out = a.o;
  p.lse = a.lse;
  p.part = nullptr;
  p.with_lse = a.lse != nullptr;
  p.q_mask = nullptr;  // query rows are not masked
  p.kv_mask = a.kv_mask;
  p.osb = a.os.sb;
  p.osh = a.os.sh;
  p.osn = a.os.sn;
  p.batch = a.batch;
  p.heads = a.heads;
  p.nq = a.nq;
  p.nk = a.nk;
  p.q_tiles = (a.nq + kSparseRows - 1) / kSparseRows;
  p.k_tiles = 0;
  p.splits = 1;
  p.scale_log2 = a.sm_scale * grad::kLog2e;
  grad::GradParams g{};  // what the producer reads: the keys' validity
  g.kv_mask = a.kv_mask;
  g.nq = a.nq;
  g.nk = a.nk;
  const cudaError_t err = cudaFuncSetAttribute(
      sparse_fwd_kernel_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.dynamic_smem);
  if (err != cudaSuccess) return err;
  sparse_fwd_kernel_sm90<D><<<(unsigned)plan.blocks, plan.threads, plan.dynamic_smem, stream>>>(
      tq, tk, tv, p, g, lists);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace af2
