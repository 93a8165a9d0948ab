// K3's one-pass backward for Hopper (sm_90a): dq, dk and dv of K1 in one
// kernel, one pass over each (query tile, key tile) pair; and the dsum pass,
// rowsum(dO * O) in one read. Included by fused_attention_bwd.cu;
// ops/cuda/axial.py grad_route() sends a bf16 problem here where
// cluster_of() below takes it and the H100's times favour it (head dim 32
// or 64, up to 256 keys, at most 15 / 4 query tiles of 64 with two
// blocks), and to K3a/K3b (fused_attention_bwd_sm90.cuh) otherwise. Head
// dim 128 stays there: at 384 threads a block gets 168 registers a thread
// at launch, and its dk, dv, S and dP alone would take 192.
//
// Replaces the TPU kernels alphafold2_tpu/ops/pallas/axial.py `_run_dq`
// (:268, pallas_call :275) and `_run_dkv` (:306, pallas_call :313) on its
// route. With the forward's lse and dsum = rowsum(dO * O) (attention_dsum_
// kernel below; the JAX backward computes it outside its Pallas calls,
// axial.py:417):
//
//     p^T  = exp(sm_scale * k.q - lse)      (0: masked key, dead query row)
//     ds^T = p^T * (v.dO - dsum)            (p and ds rounded to bf16, as K3)
//     dv  += p^T dO,   dk += ds^T Q         (f32 registers, per key block)
//     dq   = sum over the key blocks, in rank order, of ds K
//
// What bounds it: 10 B·H·Nq·Nk·D operations against Q, K, V and dO read
// and dq, dk and dv written once, 2 (3 Nq + 4 Nk) D bytes a (b, h): the
// bytes at crop 256's pair pass (470 MB, 0.14 ms at 3.35 TB/s, against
// 85.9 GFLOP, 0.087 ms at 989 TFLOP/s). K3a and K3b recompute S and dP
// each (14 units) and read Q, K, V and dO twice (about 745 MB there); this
// kernel computes each once (10 units) and reads them once. Measured on the
// H100, a non-persistent block paid about 3 times a query tile's time in
// set-up (barriers, the cluster, K and V), so the grid is persistent.
//
// The design:
//
// * Persistent clusters: at most 132 blocks, one an SM (384 threads, two
//   consumer warpgroups and a producer warpgroup that gives its registers
//   away: setmaxnreg 24 and 240). The key blocks of one (b, h) form a
//   cluster of C = ceil(Nk / 128) blocks, 1 or 2 (clusters of 4 and 8
//   lost to K3a/K3b by 2-2.6x on the H100 and are not taken), and each
//   cluster walks the problems (b, h) c, c + clusters, ...; block rank r owns
//   keys [128 r, 128 r + 128), consumer warpgroup w the keys 64w .. 64w + 63.
// * The producer's first warp loads each problem's K and V (one TMA box of
//   128 rows each) into one of two buffers while the consumers finish the
//   problem before, then streams the problem's 64-query tiles of Q and dO,
//   with their lse and dsum, through an mbarrier ring of 3 stages, and a
//   stage that ends the problem.
//   A tile with no live query is never staged (it adds exactly 0), as in K3b.
// * Each tile pair: S^T = K_w Q^T and dP^T = V_w dO^T by wgmma from shared
//   memory, p^T and ds^T in registers (K3b's dkv_cols), dv += p^T dO and
//   dk += ds^T Q by wgmma with A from registers. ds^T also goes, as bf16, to
//   a shared 128-key x 64-query buffer (double-buffered by tile parity), and
//   after a barrier of the two consumer warpgroups the warpgroup of the
//   tile's parity computes the tile's dq (64 x D, f32) = ds K over all 128
//   keys: A is the buffer read transposed (MN-major), B the resident K read
//   transposed. The other warpgroup meanwhile starts the next tile.
// * dq across the key blocks of one (b, h), deterministically: with one
//   block the warpgroup scales, rounds and writes its dq tile. With a
//   cluster each block keeps its f32 dq partial of every query tile resident
//   in shared memory (zeroed when the problem starts; so at most
//   resident_tiles() query tiles); after the problem's last tile every rank
//   arrives on every rank's `ready` mbarrier (release at cluster scope),
//   waits on its own (acquire), sums its share of the rows from every rank's
//   partial in rank order through distributed shared memory (mapa,
//   ld.shared::cluster), scales, rounds and writes bf16 dq, then arrives on
//   every rank's `free` mbarrier and waits on its own before it clears its
//   partial for the next problem or leaves. No atomics and no partials in
//   device memory: two runs give the same bits. A summation per tile instead
//   (two slots a block) was twice as slow as K3a/K3b at 512 queries, and
//   is gone.
// * Dead rows and blocks, K3's rules: a masked key gives p = 0; a query tile
//   with no live query is never staged, nor is any for a block whose 128
//   keys are all masked (dk = dv = 0; it still takes part in its cluster's
//   sum, in rank order, with zeros). A tile never staged leaves zeros in the
//   resident partial, or (one block) is written as 0 after the problem by
//   the consumers.
// * Every mbarrier wait traps after kSpinLimit polls (sm90_ptx.cuh): a
//   broken handshake fails the launch, it does not hang the card.

#pragma once

#include "fused_attention_bwd_sm90.cuh"

namespace af2 {
namespace sm90 {
namespace onepass {

using grad::Cfg;
using grad::kLog2e;
using grad::kMaskWords;
using grad::kRows;  // 64: a consumer warpgroup's keys, a streamed query tile

constexpr int kKeys = 128;           // keys a block owns
constexpr int kThreads = 384;        // two consumer warpgroups, one producer warpgroup
constexpr int kConsumerThreads = 256;
constexpr int kMaxCluster = 2;       // the clusters taken: 1 or 2 blocks
// setmaxnreg only moves registers within the block's launch allocation,
// 168 x 384 = 64,512: 128 x 24 + 256 x 240 is that again
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kDsBytes = kKeys * 128;  // ds^T, 128 keys x 64 queries bf16, 128-byte rows

template <int D>
struct Layout {
  using C = Cfg<D>;
  static constexpr int kResChunk = kKeys * C::SWB;  // a 128-row chunk of K or V
  static constexpr int kRes = C::NCH * kResChunk;    // K (or V), 128 x D bf16
  static_assert(D == 32 || D == 64, "head dim 32 or 64");
  static constexpr int kBufs = 2;  // K/V buffers: the next problem's load overlaps
                                   // this one's tail
  static constexpr int kStage = 2 * C::kTile;        // Q and dO, 64 x D each
  static constexpr int kSlotLd = D + 4;              // f32 row stride of the resident dq
  static constexpr int kSlot = kRows * kSlotLd * 4;  // one query tile of it
};

struct Control {
  uint64_t full[grad::kMaxStages];
  uint64_t empty[grad::kMaxStages];
  uint64_t kv_full[2];   // a K/V buffer holds its problem's keys
  uint64_t kv_empty[2];  // the consumers are done with a K/V buffer
  uint64_t ready;        // every rank's resident dq holds the problem's partial
  uint64_t free_;        // every rank has read this rank's resident dq
  alignas(16) float lse[grad::kMaxStages][kRows];   // lse * log2(e), +inf: dead query
  alignas(16) float dsum[grad::kMaxStages][kRows];  // 0 on a dead query
  int tile[grad::kMaxStages];  // the stage's first query; -1 ends the problem
};

// Dynamic shared memory without the resident dq: K and V (in kBufs
// buffers), the ring, two ds^T buffers and the control block.
template <int D>
constexpr int base_smem_bytes() {
  using L = Layout<D>;
  return 1024 + 2 * L::kBufs * L::kRes + Cfg<D>::kStages * L::kStage + 2 * kDsBytes +
         (int)((sizeof(Control) + 1023) / 1024 * 1024);
}

constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100
constexpr int kSMs = 132;         // streaming multiprocessors of the H100

// Query tiles whose f32 dq a block holds beside the rest: a cluster's
// problem takes at most this many (4 at head dim 64, 15 at 32).
template <int D>
constexpr int resident_tiles() {
  return (kMaxSmem - base_smem_bytes<D>()) / Layout<D>::kSlot;
}

// Dynamic shared memory: the base and, with a cluster, the resident dq of
// q_tiles query tiles.
template <int D>
constexpr int smem_bytes(int cluster, int q_tiles) {
  return base_smem_bytes<D>() + (cluster > 1 ? q_tiles * Layout<D>::kSlot : 0);
}

struct Params {
  const float* lse;              // (B, H, Nq) f32 from the forward; +inf: no valid key
  const float* dsum;             // (B, H, Nq) f32, rowsum(dO * O) - dlse
  const unsigned char* q_mask;   // (B, Nq) 0/1, or null
  const unsigned char* kv_mask;  // (B, Nk) 0/1, or null
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long dqs[3], dks[3], dvs[3];  // (batch, head, token) element strides
  int batch, heads, nq, nk;
  int cluster;     // blocks a (b, h): 1 or 2
  int clusters;    // clusters in the grid, each walking every clusters-th problem
  int q_tiles;     // 64-query tiles
  float sm_scale;
  float scale_log2;  // sm_scale * log2(e)
  int drop_rank;     // the negative control: every rank leaves this rank out
                     // of its dq sums (-1: none)
};

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster: arrive (release), then wait (acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of this block's shared address `addr` in rank r.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void fence_cluster() {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
}

// Arrive, with release at cluster scope, on the mbarrier at shared::cluster
// address `remote` (any rank's, this one's too).
__device__ __forceinline__ void arrive_remote(uint32_t remote) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

// mbar_wait with acquire at cluster scope: what the arriving ranks wrote
// before their release is visible after it.
__device__ __forceinline__ void wait_cluster(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == kSpinLimit) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// wgmma m64nNk16, f32 += bf16 * bf16, A and B from shared memory, both
// transposed (MN-major): dq = ds K with ds^T and K stored key-major.
template <int N>
__device__ __forceinline__ void wgmma_tt(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tt<64>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tt<32>(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// ---------------------------------------------------------------- pieces

__device__ __forceinline__ bool key_live(const Params& p, int b, int n) {
  return n < p.nk && (p.kv_mask == nullptr || p.kv_mask[(long long)b * p.nk + n] != 0);
}

// Query row n's lse in log2 units, +inf where the row takes no part.
__device__ __forceinline__ float live_lse2(const Params& p, int b, int bh, int n) {
  if (n >= p.nq) return CUDART_INF_F;
  if (p.q_mask != nullptr && p.q_mask[(long long)b * p.nq + n] == 0) return CUDART_INF_F;
  const float l = p.lse[(long long)bh * p.nq + n];
  return l < CUDART_INF_F ? l * kLog2e : CUDART_INF_F;
}

__device__ __forceinline__ __nv_bfloat16* row_ptr(__nv_bfloat16* base, const long long (&s)[3],
                                                  int b, int h, int n) {
  return base + (long long)b * s[0] + (long long)h * s[1] + (long long)n * s[2];
}

// Rows [r0, r1) of 64-query tile q0 of dq (rows past Nq skipped) as 0, by
// `threads` threads from index `tid`.
template <int D>
__device__ __forceinline__ void zero_dq_rows(const Params& p, int b, int h, int q0, int r0, int r1,
                                             int tid, int threads) {
  for (int e = tid; e < (r1 - r0) * (D / 8); e += threads) {
    const int n = q0 + r0 + e / (D / 8);
    if (n < p.nq)
      reinterpret_cast<uint4*>(row_ptr(p.dq, p.dqs, b, h, n))[e % (D / 8)] = make_uint4(0, 0, 0, 0);
  }
}

// One thread's rows (lrow, lrow + 8 from r0) of one CW-column chunk of a
// 64 x D accumulator (from column col0), times `scale`, as bf16 through the
// strides; rows at or past n_rows skipped.
template <int D>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* base, const long long (&s)[3],
                                            const float (&acc)[Cfg<D>::CW / 2], float scale,
                                            int b, int h, int r0, int lrow, int t, int n_rows,
                                            int col0) {
  using C = Cfg<D>;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = r0 + lrow + 8 * r;
    if (n >= n_rows) continue;
    __nv_bfloat16* dst = row_ptr(base, s, b, h, n) + col0;
#pragma unroll
    for (int j = 0; j < C::CW / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t) =
          pack_bf16(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* base, const long long (&s)[3],
                                          const float (&acc)[Cfg<D>::NCH][Cfg<D>::CW / 2],
                                          float scale, int b, int h, int r0, int lrow, int t,
                                          int n_rows) {
#pragma unroll
  for (int c = 0; c < Cfg<D>::NCH; ++c)
    store_chunk<D>(base, s, acc[c], scale, b, h, r0, lrow, t, n_rows, c * Cfg<D>::CW);
}

// x = a b^T over the head dim for one 64 x 64 tile pair, a 64-row slice of
// a resident 128-row tile (chunks kResChunk apart), b a streamed 64-row tile.
template <int D>
__device__ __forceinline__ void pair_product(float (&x)[32], uint32_t a_addr, uint32_t b_addr) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 / C::CW, off = (kk * 16 % C::CW) * 2;
    wgmma_ss<64>(x, kmajor_desc<C::SWB>(a_addr + c * Layout<D>::kResChunk + off),
                 kmajor_desc<C::SWB>(b_addr + c * C::kChunk + off), kk > 0);
  }
}

// Chunk c (CW columns) of dq (64 queries x D) = ds K over the block's 128
// keys: ds^T at ds_addr (128 key rows of 64 queries, swizzled at 128
// bytes) and the resident K at k_addr, both read transposed. A chunk at a
// time keeps dq's accumulator at CW / 2 registers beside dk's and dv's.
template <int D>
__device__ __forceinline__ void dq_chunk(float (&dq)[Cfg<D>::CW / 2], uint32_t ds_addr,
                                         uint32_t k_addr, int c) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    wgmma_tt<C::CW>(dq, mnmajor_desc<128>(ds_addr + kk * 16 * 128),
                    mnmajor_desc<C::SWB>(k_addr + c * Layout<D>::kResChunk + kk * 16 * C::SWB),
                    kk > 0);
}

// This thread's ds^T (rows lrow, lrow + 8 of warpgroup w's 64 keys; query
// columns 8j + 2t + e) into the ds buffer as bf16, the 16-byte chunks of
// each 128-byte row swizzled as TMA's 128-byte swizzle lays them.
__device__ __forceinline__ void store_ds(unsigned char* buf, const float (&ds)[32], int w,
                                         int lrow, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 64 * w + lrow + 8 * r;
    unsigned char* dst = buf + row * 128 + 4 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + ((j ^ (row & 7)) << 4)) =
          pack_bf16(ds[4 * j + 2 * r], ds[4 * j + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------- roles

// The problem (batch * head) a cluster's j-th turn takes.
__device__ __forceinline__ int problem_of(const Params& p, int j) {
  return (int)(blockIdx.x / p.cluster) + j * p.clusters;
}

__device__ __forceinline__ int turns_of(const Params& p) {
  const int first = (int)(blockIdx.x / p.cluster);
  const int problems = p.batch * p.heads;
  return first < problems ? (problems - 1 - first) / p.clusters + 1 : 0;
}

// The producer warp: each turn's K and V (this rank's 128 keys) into their
// buffer, then the problem's live query tiles of Q and dO with their lse
// and dsum through the ring, then a stage that ends the problem.
template <int D>
__device__ __forceinline__ void producer(const CUtensorMap* tq, const CUtensorMap* tdo,
                                         const CUtensorMap* tk, const CUtensorMap* tv,
                                         const Params& p, unsigned char* kv,
                                         unsigned char* ring, Control& ctl, int k0) {
  using C = Cfg<D>;
  using L = Layout<D>;
  const int lane = threadIdx.x & 31;
  const int turns = turns_of(p);
  int it = 0;
  for (int j = 0; j < turns; ++j) {
    const int bh = problem_of(p, j);
    const int b = bh / p.heads, h = bh % p.heads;
    const int buf = j % L::kBufs;
    if (j >= L::kBufs) mbar_wait(&ctl.kv_empty[buf], (j / L::kBufs - 1) & 1);
    if (lane == 0) {
      unsigned char* dst = kv + buf * 2 * L::kRes;
      mbar_arrive_expect_tx(&ctl.kv_full[buf], 2 * L::kRes);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
        tma_load_4d(dst + c * L::kResChunk, tk, &ctl.kv_full[buf], c * C::CW, k0, h, b);
        tma_load_4d(dst + L::kRes + c * L::kResChunk, tv, &ctl.kv_full[buf], c * C::CW, k0, h,
                    b);
      }
    }
    // a block whose 128 keys are all masked stages no
    // query tile: its dk and dv are 0 and it adds 0 to dq
    bool any_key = false;
#pragma unroll
    for (int i = 0; i < kKeys / 32; ++i)
      any_key |= __any_sync(0xffffffffu, key_live(p, b, k0 + 32 * i + lane));
    for (int t = any_key ? 0 : p.q_tiles; t <= p.q_tiles; ++t) {
      const int q0 = t * kRows;
      float l0 = CUDART_INF_F, l1 = CUDART_INF_F;
      if (t < p.q_tiles) {
        l0 = live_lse2(p, b, bh, q0 + lane);
        l1 = live_lse2(p, b, bh, q0 + 32 + lane);
        const uint32_t w0 = __ballot_sync(0xffffffffu, l0 < CUDART_INF_F);
        const uint32_t w1 = __ballot_sync(0xffffffffu, l1 < CUDART_INF_F);
        if ((w0 | w1) == 0) continue;  // no live query: the tile adds nothing
      }
      const int st = it % C::kStages;
      mbar_wait(&ctl.empty[st], ((it / C::kStages) & 1) ^ 1);
      ++it;
      if (t == p.q_tiles) {  // the end of the problem
        if (lane == 0) ctl.tile[st] = -1;
        mbar_arrive(&ctl.full[st]);
        break;
      }
      const float* dsum = p.dsum + (long long)bh * p.nq + q0;
      ctl.lse[st][lane] = l0;
      ctl.lse[st][32 + lane] = l1;
      ctl.dsum[st][lane] = l0 < CUDART_INF_F ? dsum[lane] : 0.f;
      ctl.dsum[st][32 + lane] = l1 < CUDART_INF_F ? dsum[32 + lane] : 0.f;
      unsigned char* qs = ring + st * L::kStage;
      if (lane == 0) {
        ctl.tile[st] = q0;
        mbar_arrive_expect_tx(&ctl.full[st], L::kStage);
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          tma_load_4d(qs + c * C::kChunk, tq, &ctl.full[st], c * C::CW, q0, h, b);
          tma_load_4d(qs + C::kTile + c * C::kChunk, tdo, &ctl.full[st], c * C::CW, q0, h, b);
        }
      } else {
        mbar_arrive(&ctl.full[st]);
      }
    }
  }
}

// This thread's rows (lrow, lrow + 8) of chunk c of a 64 x D f32 dq tile
// into shared rows of kSlotLd floats.
template <int D>
__device__ __forceinline__ void store_slot(float* slot, const float (&dq)[Cfg<D>::CW / 2],
                                           int lrow, int t, int c) {
  using C = Cfg<D>;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = slot + (lrow + 8 * r) * Layout<D>::kSlotLd + c * C::CW;
#pragma unroll
    for (int jj = 0; jj < C::CW / 8; ++jj)
      *reinterpret_cast<float2*>(row + 8 * jj + 2 * t) =
          make_float2(dq[4 * jj + 2 * r], dq[4 * jj + 2 * r + 1]);
  }
}

// A cluster's sum of the resident dq, by both consumer warpgroups after a
// problem's last tile (its j-th turn): every rank's partial of every query
// tile, summed in rank order over this rank's share of the rows, scaled,
// written as bf16. Each rank waits until every rank has read its rows
// before it clears them for the next problem (or leaves).
template <int D>
__device__ __forceinline__ void sum_resident_dq(const Params& p, float* dq_all, Control& ctl,
                                                uint32_t rank, int b, int h, int j) {
  using L = Layout<D>;
  const int tid = threadIdx.x;  // 0 .. 255
  named_sync(1, kConsumerThreads);
  if (tid == 0) {
    fence_cluster();
    for (uint32_t r = 0; r < (uint32_t)p.cluster; ++r)
      arrive_remote(map_rank(smem_u32(&ctl.ready), r));
  }
  wait_cluster(&ctl.ready, j & 1);
  const int rows = p.q_tiles * kRows;
  const int r0 = (int)rank * rows / p.cluster, r1 = ((int)rank + 1) * rows / p.cluster;
  const uint32_t base = smem_u32(dq_all);
  for (int e = tid; e < (r1 - r0) * (D / 4); e += kConsumerThreads) {
    const int row = r0 + e / (D / 4), c4 = e % (D / 4);
    if (row >= p.nq) break;  // rows only grow with e
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (uint32_t r = 0; r < (uint32_t)p.cluster; ++r) {
      if ((int)r == p.drop_rank) continue;
      const float4 x = ld_cluster_f4(map_rank(base + (row * L::kSlotLd + 4 * c4) * 4, r));
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const float s = p.sm_scale;
    *reinterpret_cast<uint2*>(row_ptr(p.dq, p.dqs, b, h, row) + 4 * c4) =
        make_uint2(pack_bf16(acc.x * s, acc.y * s), pack_bf16(acc.z * s, acc.w * s));
  }
  named_sync(1, kConsumerThreads);
  if (tid == 0)
    for (uint32_t r = 0; r < (uint32_t)p.cluster; ++r)
      arrive_remote(map_rank(smem_u32(&ctl.free_), r));
  wait_cluster(&ctl.free_, j & 1);
}

template <int D>
__device__ __forceinline__ void consumer(const Params& p, unsigned char* kv, unsigned char* ring,
                                         unsigned char* dsbuf, float* dq_all, Control& ctl,
                                         uint32_t rank) {
  using C = Cfg<D>;
  using L = Layout<D>;
  const int w = threadIdx.x >> 7;  // consumer warpgroup: keys 64w .. 64w + 63
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int lrow = 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);  // rows lrow, lrow + 8
  const int k0 = (int)rank * kKeys;
  const int turns = turns_of(p);
  int it = 0;
  for (int j = 0; j < turns; ++j) {
    const int bh = problem_of(p, j);
    const int b = bh / p.heads, h = bh % p.heads;
    const int buf = j % L::kBufs;
    if (p.cluster > 1) {  // the resident dq starts each problem at 0
      float4* z = reinterpret_cast<float4*>(dq_all);
      for (int e = threadIdx.x; e < p.q_tiles * (L::kSlot / 16); e += kConsumerThreads)
        z[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // the last problem's ds^T buffers and dq products are done with
    named_sync(1, kConsumerThreads);
    const bool kv_ok[2] = {key_live(p, b, k0 + 64 * w + lrow),
                           key_live(p, b, k0 + 64 * w + lrow + 8)};
    float dk[C::NCH][C::CW / 2], dv[C::NCH][C::CW / 2];
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
#pragma unroll
      for (int i = 0; i < C::CW / 2; ++i) dk[c][i] = dv[c][i] = 0.f;
    const uint32_t kaddr = smem_u32(kv + buf * 2 * L::kRes), vaddr = kaddr + L::kRes;
    const uint32_t kw = kaddr + 64 * w * C::SWB, vw = vaddr + 64 * w * C::SWB;
    mbar_wait(&ctl.kv_full[buf], (j / L::kBufs) & 1);
    int staged = 0;  // the problem's query tiles the producer staged
    for (;; ++it, ++staged) {
      const int st = it % C::kStages;
      mbar_wait(&ctl.full[st], (it / C::kStages) & 1);
      const int q0 = __shfl_sync(0xffffffffu, ctl.tile[st], 0);
      if (q0 < 0) {  // the end of the problem (uniform, as the role)
        mbar_arrive(&ctl.empty[st]);
        ++it;
        break;
      }
      const uint32_t qaddr = smem_u32(ring + st * L::kStage), doaddr = qaddr + C::kTile;

      float s[32], dp[32];  // [4j + 2r + e]: key row lrow + 8r, query 8j + 2t + e
      wgmma_fence();
      pair_product<D>(s, kw, qaddr);
      pair_product<D>(dp, vw, doaddr);
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(s);
      fence_operands(dp);
      const uint32_t all[kMaskWords] = {~0u, ~0u};
      grad::dkv_cols<false>(s, dp, all, p.scale_log2, kv_ok, ctl.lse[st], ctl.dsum[st], t);

      unsigned char* ds = dsbuf + (it & 1) * kDsBytes;
      store_ds(ds, dp, w, lrow, t);
      fence_proxy_async();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        uint32_t ap[4], ad[4];
        grad::a_frag16(ap, s, kk);
        grad::a_frag16(ad, dp, kk);
        grad::accumulate<D>(dv, ap, doaddr, kk);
        grad::accumulate<D>(dk, ad, qaddr, kk);
      }
      wgmma_commit();
      // the A fragments of p and ds die here, before dq's accumulator lives
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
        fence_operands(dk[c]);
        fence_operands(dv[c]);
      }
      mbar_arrive(&ctl.empty[st]);
      named_sync(1, kConsumerThreads);  // both warpgroups' ds^T are in the buffer
      if ((it & 1) == w) {
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          float dq[C::CW / 2];
          wgmma_fence();
          dq_chunk<D>(dq, smem_u32(ds), kaddr, c);
          wgmma_commit();
          wgmma_wait_all();
          fence_operands(dq);
          if (p.cluster == 1)
            store_chunk<D>(p.dq, p.dqs, dq, p.sm_scale, b, h, q0, lrow, t, p.nq, c * C::CW);
          else
            store_slot<D>(dq_all + q0 * L::kSlotLd, dq, lrow, t, c);
        }
      }
    }
    store_acc<D>(p.dk, p.dks, dk, p.sm_scale, b, h, k0 + 64 * w, lrow, t, p.nk);
    store_acc<D>(p.dv, p.dvs, dv, 1.f, b, h, k0 + 64 * w, lrow, t, p.nk);
    mbar_arrive(&ctl.kv_empty[buf]);  // the producer may load the problem after next
    if (p.cluster > 1) {
      // the tiles never staged hold zeros in the resident dq, and sum to 0
      sum_resident_dq<D>(p, dq_all, ctl, rank, b, h, j);
    } else if (staged < p.q_tiles) {
      // the rows of query tiles never staged (no live query) are 0: each
      // warp of the two warpgroups takes every eighth tile
      for (int tq = threadIdx.x >> 5; tq < p.q_tiles; tq += kConsumerThreads / 32) {
        const int q0 = tq * kRows;
        const bool l0 = live_lse2(p, b, bh, q0 + lane) < CUDART_INF_F;
        const bool l1 = live_lse2(p, b, bh, q0 + 32 + lane) < CUDART_INF_F;
        if (__ballot_sync(0xffffffffu, l0 || l1) == 0)
          zero_dq_rows<D>(p, b, h, q0, 0, kRows, lane, 32);
      }
    }
  }
}

// A persistent grid: p.clusters clusters of p.cluster blocks, cluster c
// walking problems (batch * head) c, c + clusters, ...; block rank r of
// each owns keys [128 r, 128 r + 128).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<D>;
  using L = Layout<D>;
  extern __shared__ unsigned char onepass_smem[];
  unsigned char* kv = align1024(onepass_smem);               // K, V of each buffer
  unsigned char* ring = kv + 2 * L::kBufs * L::kRes;          // stages of Q, then dO
  unsigned char* dsbuf = ring + C::kStages * L::kStage;       // two ds^T buffers
  Control& ctl = *reinterpret_cast<Control*>(dsbuf + 2 * kDsBytes);
  float* dq_all = reinterpret_cast<float*>(dsbuf + 2 * kDsBytes +
                                           (sizeof(Control) + 1023) / 1024 * 1024);

  const uint32_t rank = p.cluster > 1 ? cluster_rank() : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&ctl.full[s], 32);                 // the producer warp
      mbar_init(&ctl.empty[s], kConsumerThreads);  // every consumer thread
    }
    for (int buf = 0; buf < 2; ++buf) {
      mbar_init(&ctl.kv_full[buf], 1);
      mbar_init(&ctl.kv_empty[buf], kConsumerThreads);
    }
    mbar_init(&ctl.ready, p.cluster);  // a thread of each rank
    mbar_init(&ctl.free_, p.cluster);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (p.cluster > 1) cluster_sync();  // no rank arrives on a barrier not yet initialised

  // the role, broadcast from lane 0 so that ptxas sees the branch as
  // warp-uniform (a branch it cannot prove uniform serialises every wgmma)
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (__shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0) == 8)
      producer<D>(&tq, &tdo, &tk, &tv, p, kv, ring, ctl, (int)rank * kKeys);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consumer<D>(p, kv, ring, dsbuf, dq_all, ctl, rank);
  }
}

// ---------------------------------------------------------------- dsum

struct DsumParams {
  const void* out;     // (B, H, Nq, D) through its strides
  const void* dout;
  const float* lse;    // (B, H, Nq) contiguous, or null
  const float* dlse;   // (B, H, Nq) contiguous, or null
  float* dsum;         // (B, H, Nq) contiguous
  long long os[3], gs[3];
  int batch, heads, nq, head_dim;
  int vec;  // bf16 rows readable as 16-byte vectors
};

constexpr int kDsumThreads = 256;
constexpr int kDsumLanes = 8;  // threads a row

// dsum = rowsum(dO * O) - dlse where lse is finite, 0 where it is +inf (a
// dead row); without lse, rowsum(dO * O). One pass over O and dO, 8 lanes a
// row (16-byte loads each where `vec`), summed by shuffles.
template <typename T>
__global__ void __launch_bounds__(kDsumThreads) attention_dsum_kernel(const DsumParams p) {
  const long long rows = (long long)p.batch * p.heads * p.nq;
  const long long row = (long long)blockIdx.x * (kDsumThreads / kDsumLanes) +
                        threadIdx.x / kDsumLanes;
  const int l = threadIdx.x % kDsumLanes;
  float acc = 0.f;
  if (row < rows) {
    const int n = (int)(row % p.nq);
    const long long bh = row / p.nq;
    const int b = (int)(bh / p.heads), h = (int)(bh % p.heads);
    const T* o = static_cast<const T*>(p.out) + b * p.os[0] + h * p.os[1] + n * p.os[2];
    const T* g = static_cast<const T*>(p.dout) + b * p.gs[0] + h * p.gs[1] + n * p.gs[2];
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (p.vec) {
        for (int f = 8 * l; f < p.head_dim; f += 8 * kDsumLanes) {
          const uint4 ov = *reinterpret_cast<const uint4*>(o + f);
          const uint4 gv = *reinterpret_cast<const uint4*>(g + f);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 a = __bfloat1622float2(o2[i]), c = __bfloat1622float2(g2[i]);
            acc = fmaf(a.x, c.x, acc);
            acc = fmaf(a.y, c.y, acc);
          }
        }
      } else {
        for (int f = l; f < p.head_dim; f += kDsumLanes)
          acc = fmaf(__bfloat162float(o[f]), __bfloat162float(g[f]), acc);
      }
    } else {
      for (int f = l; f < p.head_dim; f += kDsumLanes) acc = fmaf(o[f], g[f], acc);
    }
  }
#pragma unroll
  for (int m = kDsumLanes / 2; m > 0; m /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (row < rows && l == 0) {
    const bool live = p.lse == nullptr || p.lse[row] < CUDART_INF_F;
    p.dsum[row] = live ? acc - (p.dlse != nullptr ? p.dlse[row] : 0.f) : 0.f;
  }
}

// ---------------------------------------------------------------- host

// The cluster a problem takes: ceil(nk / 128) blocks, or 0 where the
// one-pass kernel does not take it (a head dim other than 32 or 64; more
// than kMaxCluster blocks; a cluster whose query tiles' f32 dq does not fit
// resident).
__host__ inline int cluster_of(int nq, int nk, int head_dim) {
  if (head_dim != 32 && head_dim != 64) return 0;
  const int c = (nk + kKeys - 1) / kKeys;
  const int q_tiles = (nq + kRows - 1) / kRows;
  const int resident = head_dim == 32 ? resident_tiles<32>() : resident_tiles<64>();
  if (c > kMaxCluster || (c > 1 && q_tiles > resident)) return 0;
  return c;
}

template <int D>
__host__ inline Af2LaunchPlan plan_onepass(int batch, int heads, int nq, int nk) {
  Af2LaunchPlan plan{};
  const int c = cluster_of(nq, nk, D);
  const long long problems = (long long)batch * heads;
  const long long clusters = c > 0 ? (problems < kSMs / c ? problems : kSMs / c) : 0;
  plan.blocks = clusters * c;
  plan.threads = kThreads;
  plan.dynamic_smem = smem_bytes<D>(c, (nq + kRows - 1) / kRows);
  plan.cluster = c;
  name_kernel(plan, "attention_bwd_kernel_sm90<%d>", D);
  return plan;
}

// Launches attention_bwd_kernel_sm90<D> with its cluster attribute.
template <int D>
__host__ inline cudaError_t launch_onepass(const grad::GradOperands& a, void* dq, void* dk,
                                           void* dv, const Operand& dqs, const Operand& dks,
                                           const Operand& dvs, int drop_rank,
                                           cudaStream_t stream) {
  const Af2LaunchPlan plan = plan_onepass<D>(a.batch, a.heads, a.nq, a.nk);
  if (plan.cluster == 0 || !grid_fits(plan)) return cudaErrorInvalidConfiguration;
  CUtensorMap tq, tdo, tk, tv;
  if (!encode_bf16(&tq, a.q, a.qs, a.batch, a.heads, a.nq, D, kRows) ||
      !encode_bf16(&tdo, a.dout, a.dos, a.batch, a.heads, a.nq, D, kRows) ||
      !encode_bf16(&tk, a.k, a.ks, a.batch, a.heads, a.nk, D, kKeys) ||
      !encode_bf16(&tv, a.v, a.vs, a.batch, a.heads, a.nk, D, kKeys))
    return cudaErrorInvalidValue;
  Params p;
  p.lse = a.lse;
  p.dsum = a.dsum;
  p.q_mask = a.q_mask;
  p.kv_mask = a.kv_mask;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  const Operand* outs[3] = {&dqs, &dks, &dvs};
  long long* dst[3] = {p.dqs, p.dks, p.dvs};
  for (int i = 0; i < 3; ++i) {
    dst[i][0] = outs[i]->sb;
    dst[i][1] = outs[i]->sh;
    dst[i][2] = outs[i]->sn;
  }
  p.batch = a.batch;
  p.heads = a.heads;
  p.nq = a.nq;
  p.nk = a.nk;
  p.cluster = plan.cluster;
  p.clusters = (int)(plan.blocks / plan.cluster);
  p.q_tiles = (a.nq + kRows - 1) / kRows;
  p.sm_scale = a.sm_scale;
  p.scale_log2 = a.sm_scale * kLog2e;
  p.drop_rank = drop_rank;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel_sm90<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         plan.dynamic_smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)plan.blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = plan.dynamic_smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[5] = {&tq, &tdo, &tk, &tv, &p};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(attention_bwd_kernel_sm90<D>),
                            args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

__host__ inline Af2LaunchPlan plan_dsum(int batch, int heads, int nq, int dtype) {
  Af2LaunchPlan plan{};
  const long long rows = (long long)batch * heads * nq;
  const int per_block = kDsumThreads / kDsumLanes;
  plan.blocks = (rows + per_block - 1) / per_block;
  plan.threads = kDsumThreads;
  plan.dynamic_smem = 0;
  name_kernel(plan, "attention_dsum_kernel<%s>", dtype == 1 ? "__nv_bfloat16" : "float");
  return plan;
}

}  // namespace onepass
}  // namespace sm90
}  // namespace af2
