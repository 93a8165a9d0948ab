// K1's bf16 forward redesigned for Hopper (sm_90a): TMA-fed tiles, wgmma,
// a split over long key loops with its combine pass, and skipped masked
// tiles. Included by fused_attention.cu, whose plan routes every bf16
// problem the kernel takes here (head dim 32, 64 or 128, operands TMA can
// describe); every other bf16 problem runs attention_kernel_mma
// (attention_tile.cuh) and f32 runs attention_kernel, as before.
//
// Replaces the TPU kernel alphafold2_tpu/ops/pallas/axial.py `_run`
// (pallas_call at :249, body `_fwd_core` :56), with the masking contract of
// ops/cuda/axial.py: a masked key weighs 0; a masked query, or a row with
// no valid key, gives exactly 0; the training forward's lse is the row's
// logsumexp over its valid keys, +inf for a row with none.
//
// What bounds it: at the main-path shapes (head dim 64) the logits and
// P @ V work, 4*D operations per (query, key) pair, against 2*D bytes of
// q and k per row read once, puts every pass above the card's ridge of
// about 295 operations a byte once a row meets more than a few hundred
// keys, so the tensor-core rate bounds it; short-key passes (the MSA
// column, 5 keys) are bound by the bytes of q and the output. The design:
//
// * Block: two consumer warpgroups (64 query rows each, 128 rows a block)
//   and one producer warp, 288 threads, one block an SM.
// * The producer warp keeps TMA loads of 128-key K and V tiles in flight
//   in a ring of kStages stages (3 at head dim <= 64, 2 at 128) with full
//   and empty mbarriers; q is loaded once per block. Tensor maps are
//   encoded on the host for each call (cuTensorMapEncodeTiled, reached
//   through the runtime's driver entry point) over the strided
//   (B, H, N, D) views as given: on the serving path the k and v maps are
//   the two halves of one (B, Nk, 2*H*D) projection. Tiles land 128-byte
//   swizzled (64-byte at head dim 32) in 64-column chunks.
// * Beside each K tile the producer stages the tile's key mask as 128
//   bits (four ballots over the mask bytes, keys past Nk invalid). A tile
//   with no valid key is not staged at all: skipping it equals processing
//   it (p = 0, alpha = 1). The stream ends with a sentinel stage.
// * S = Q K^T is one wgmma m64n128k16 per 16 features, both operands in
//   shared memory (K-major descriptors). The online softmax (f32 max, sum
//   and accumulator, in log2 units) stays in registers: one FMA and one
//   ex2.approx a logit, and no mask arithmetic on a tile whose 128 keys
//   are all valid. P goes to P @ V as bf16 A fragments in registers (the
//   accumulator layout of S is the A layout of the next product) and V is
//   the B operand read transposed (MN-major) through its descriptor: no
//   element is moved by hand. Each warpgroup runs its products and its
//   softmax in turn; the other warpgroup's products fill the tensor cores
//   meanwhile. (Overlapping a tile's softmax with the previous tile's
//   P @ V inside one warpgroup measured 4-6% faster at head dim 64 only
//   with O rescaled between the two issues, and ptxas serialises it at
//   head dim 128 for want of registers: not taken.)
// * Without lse (serving), a block whose 128 query rows are all masked
//   writes 0 and reads no key. With lse (training) such rows keep their
//   lse over the valid keys, as the plain version gives them.
// * Split: where b*h*ceil(nq/128) blocks leave the 132 SMs short of two
//   waves, ops/cuda/axial.py key_splits() cuts the key tiles into S
//   contiguous ranges (the plan takes S as given). Each block then writes
//   f32 partials (m in natural-log units, l, the unnormalised accumulator)
//   to scratch the wrapper allocates, and combine_kernel merges the S
//   partials in split order into the bf16 output (and the lse). No
//   atomics: two runs give the same bits, split or not.
// * Epilogue: each warpgroup stages its 64 x D bf16 rows in its own q
//   tile (swizzled by 16-byte chunk) and writes them with 16-byte stores.

#pragma once

#include "sm90_ptx.cuh"

namespace af2 {
namespace sm90 {

constexpr int kBlockM = 128;  // query rows per block
constexpr int kBlockN = 128;  // keys per staged tile (ops/cuda/axial.py KEY_TILE)
constexpr int kConsumers = 2;  // warpgroups of 64 query rows
constexpr int kThreads = kConsumers * 128 + 32;  // and one producer warp
constexpr int kMaskWords = kBlockN / 32;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
  static constexpr int CW = D < 64 ? D : 64;  // columns of one swizzled chunk
  static constexpr int NCH = D / CW;          // chunks per row
  static constexpr int SWB = CW * 2;          // bytes per chunk row = swizzle span
  static constexpr int kStages = D <= 64 ? 3 : 2;
  static constexpr int kQBytes = 64 * D * 2;        // one warpgroup's q tile
  static constexpr int kKVBytes = kBlockN * D * 2;  // one K (or V) tile
};

struct Control {
  uint64_t full[3];
  uint64_t empty[3];
  uint64_t qbar;
  uint32_t mask[3][kMaskWords];
  int tile[3];  // first key of the staged tile, -1 ends the stream
};

template <int D>
constexpr int smem_bytes() {
  return 1024 + kConsumers * Cfg<D>::kQBytes + Cfg<D>::kStages * 2 * Cfg<D>::kKVBytes +
         (int)sizeof(Control);
}

struct Params {
  void* out;            // bf16 (B, H, Nq, D) through os* strides (split: unused)
  float* lse;           // (B, H, Nq) f32, or null (split: combine_kernel writes it)
  float* part;          // split partials, or null: m (S, rows), l (S, rows), acc (S, rows, D)
  int with_lse;         // the training forward: masked query rows keep their lse
  const unsigned char* q_mask;
  const unsigned char* kv_mask;
  long long osb, osh, osn;
  int batch, heads, nq, nk, q_tiles, k_tiles, splits;
  float scale_log2;  // sm_scale * log2(e)
};

// ---------------------------------------------------------------- kernel

template <int D>
__device__ __forceinline__ void producer(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, const Params& p,
                                         unsigned char* qs, unsigned char* kv, Control& ctl,
                                         int b, int h, int q0, int t_begin, int t_end) {
  using C = Cfg<D>;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_arrive_expect_tx(&ctl.qbar, kConsumers * C::kQBytes);
#pragma unroll
    for (int w = 0; w < kConsumers; ++w)
#pragma unroll
      for (int c = 0; c < C::NCH; ++c)
        tma_load_4d(qs + w * C::kQBytes + c * 64 * C::SWB, tq, &ctl.qbar, c * C::CW,
                    q0 + 64 * w, h, b);
  }
  const unsigned char* km = p.kv_mask != nullptr ? p.kv_mask + (long long)b * p.nk : nullptr;
  int it = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBlockN;
    uint32_t words[kMaskWords];
    bool any = false;
#pragma unroll
    for (int w = 0; w < kMaskWords; ++w) {
      const int key = k0 + 32 * w + lane;
      const bool valid = key < p.nk && (km == nullptr || km[key] != 0);
      words[w] = __ballot_sync(0xffffffffu, valid);
      any = any || words[w] != 0;
    }
    if (!any) continue;  // no valid key: the tile changes nothing
    const int st = it % C::kStages;
    mbar_wait(&ctl.empty[st], ((it / C::kStages) & 1) ^ 1);
#pragma unroll
    for (int w = 0; w < kMaskWords; ++w)
      if (lane == w) ctl.mask[st][w] = words[w];
    unsigned char* ks = kv + st * 2 * C::kKVBytes;
    unsigned char* vs = ks + C::kKVBytes;
    if (lane == 0) {
      ctl.tile[st] = k0;
      mbar_arrive_expect_tx(&ctl.full[st], 2 * C::kKVBytes);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
        tma_load_4d(ks + c * kBlockN * C::SWB, tk, &ctl.full[st], c * C::CW, k0, h, b);
        tma_load_4d(vs + c * kBlockN * C::SWB, tv, &ctl.full[st], c * C::CW, k0, h, b);
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online-softmax update of one thread's two rows (lrow, lrow + 8) for
// one staged tile of raw logits s (s[4j + 2r + e]: row r, key 8j + 2t + e;
// mw: the tile's key-mask words shifted by 2t). The row's extreme raw logit
// (max, or min for a negative scale) times the scale is its largest scaled
// logit, so each probability is one FMA and one ex2: 2^(x * scale - m).
// Every row of a staged tile has a valid key (the mask is per key), so m is
// finite. kMasked: the tile holds masked keys (weight 0); a full tile
// skips the mask arithmetic. The probabilities replace s.
template <bool kMasked, bool kNeg, int NS, int NCH, int OC>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], const uint32_t (&mw)[kMaskWords],
                                             float scale, float (&m_run)[2], float (&l_run)[2],
                                             float (&o)[NCH][OC]) {
  constexpr int NJ = NS / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float ext = kNeg ? CUDART_INF_F : -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = s[4 * j + 2 * r + e];
        const bool valid = !kMasked || ((mw[j / 4] >> (8 * (j % 4) + e)) & 1u);
        if (valid) ext = kNeg ? fminf(ext, x) : fmaxf(ext, x);
      }
    if (kNeg) {
      ext = fminf(ext, __shfl_xor_sync(0xffffffffu, ext, 1));
      ext = fminf(ext, __shfl_xor_sync(0xffffffffu, ext, 2));
    } else {
      ext = fmaxf(ext, __shfl_xor_sync(0xffffffffu, ext, 1));
      ext = fmaxf(ext, __shfl_xor_sync(0xffffffffu, ext, 2));
    }
    const float m_new = fmaxf(m_run[r], ext * scale);
    const float alpha = ex2(m_run[r] - m_new);  // 0 on the first tile (m_run = -inf)
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * r + e];
        float pr = ex2(fmaf(x, scale, -m_new));
        if (kMasked && !((mw[j / 4] >> (8 * (j % 4) + e)) & 1u)) pr = 0.f;
        x = pr;
        rs += pr;
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_run[r] = l_run[r] * alpha + rs;
    m_run[r] = m_new;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < OC / 4; ++j) {
        o[c][4 * j + 2 * r] *= alpha;
        o[c][4 * j + 2 * r + 1] *= alpha;
      }
  }
}

template <int D>
__device__ __forceinline__ void consumer(const Params& p, unsigned char* qs, unsigned char* kv,
                                         Control& ctl, int wg, int b, int h, int bh, int q0,
                                         int split) {
  using C = Cfg<D>;
  const int wt = threadIdx.x % 128;
  const int w4 = wt / 32, lane = wt & 31, g = lane >> 2, t = lane & 3;
  const int lrow = 16 * w4 + g;  // this thread's rows in its warpgroup: lrow, lrow + 8
  const int row0 = q0 + 64 * wg + lrow;

  float o[C::NCH][C::CW / 2];
#pragma unroll
  for (int c = 0; c < C::NCH; ++c)
#pragma unroll
    for (int i = 0; i < C::CW / 2; ++i) o[c][i] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};

  unsigned char* qw = qs + wg * C::kQBytes;
  const uint32_t qaddr = smem_u32(qw);
  mbar_wait(&ctl.qbar, 0);

  for (int it = 0;; ++it) {
    const int st = it % C::kStages;
    mbar_wait(&ctl.full[st], (it / C::kStages) & 1);
    if (__shfl_sync(0xffffffffu, ctl.tile[st], 0) < 0) break;  // uniform, as `role`
    const uint32_t kaddr = smem_u32(kv + st * 2 * C::kKVBytes);
    const uint32_t vaddr = kaddr + C::kKVBytes;

    float s[kBlockN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / C::CW, off = (kk * 16 % C::CW) * 2;
      wgmma_ss<kBlockN>(s, kmajor_desc<C::SWB>(qaddr + c * 64 * C::SWB + off),
                        kmajor_desc<C::SWB>(kaddr + c * kBlockN * C::SWB + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);

    // s[4j + 2r + e] is (row lrow + 8r, key 8j + 2t + e) of the tile
    uint32_t mw[kMaskWords];
#pragma unroll
    for (int w = 0; w < kMaskWords; ++w) mw[w] = ctl.mask[st][w] >> (2 * t);
    const bool full = __shfl_sync(0xffffffffu, (ctl.mask[st][0] & ctl.mask[st][1] &
                                                 ctl.mask[st][2] & ctl.mask[st][3]) == ~0u, 0);
    const bool neg = p.scale_log2 < 0.f;
    if (full) {
      if (neg) softmax_tile<false, true>(s, mw, p.scale_log2, m_run, l_run, o);
      else softmax_tile<false, false>(s, mw, p.scale_log2, m_run, l_run, o);
    } else {
      if (neg) softmax_tile<true, true>(s, mw, p.scale_log2, m_run, l_run, o);
      else softmax_tile<true, false>(s, mw, p.scale_log2, m_run, l_run, o);
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[8 * kk + 0], s[8 * kk + 1]),
                             pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                             pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                             pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
#pragma unroll
      for (int c = 0; c < C::NCH; ++c)
        wgmma_rs<C::CW>(
            o[c], a, mnmajor_desc<C::SWB>(vaddr + c * kBlockN * C::SWB + kk * 16 * C::SWB), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) fence_operands(o[c]);
    mbar_arrive(&ctl.empty[st]);
  }

  if (p.part != nullptr) {  // split: f32 partials for combine_kernel
    const long long rows = (long long)p.batch * p.heads * p.nq;
    float* pm = p.part + split * rows;
    float* pl = p.part + (p.splits + split) * rows;
    float* pa = p.part + 2 * p.splits * rows + split * rows * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = row0 + 8 * r;
      if (n >= p.nq) continue;
      const long long idx = (long long)bh * p.nq + n;
      if (t == 0) {
        pm[idx] = m_run[r] == -CUDART_INF_F ? -CUDART_INF_F : m_run[r] * kLn2;
        pl[idx] = l_run[r];
      }
#pragma unroll
      for (int c = 0; c < C::NCH; ++c)
#pragma unroll
        for (int j = 0; j < C::CW / 8; ++j)
          *reinterpret_cast<float2*>(pa + idx * D + c * C::CW + 8 * j + 2 * t) =
              make_float2(o[c][4 * j + 2 * r], o[c][4 * j + 2 * r + 1]);
    }
    return;
  }

  // stage the warpgroup's 64 rows in its q tile (free: its last product has
  // completed), 16-byte chunks of a row XOR-swizzled by the row
  constexpr int CPR = D / 8;                   // 16-byte chunks per row
  constexpr int SWZ = (CPR < 8 ? CPR : 8) - 1;
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(qw);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = row0 + 8 * r, lr = lrow + 8 * r;
    const bool qv = n < p.nq && (p.q_mask == nullptr || p.q_mask[(long long)b * p.nq + n] != 0);
    if (p.lse != nullptr && t == 0 && n < p.nq)
      p.lse[(long long)bh * p.nq + n] =
          m_run[r] == -CUDART_INF_F ? CUDART_INF_F : m_run[r] * kLn2 + logf(l_run[r]);
    const float inv = qv ? 1.f / fmaxf(l_run[r], 1e-30f) : 0.f;
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
#pragma unroll
      for (int j = 0; j < C::CW / 8; ++j) {
        const int chunk = (c * C::CW) / 8 + j;
        *reinterpret_cast<uint32_t*>(stage + lr * D + ((chunk ^ (lr & SWZ)) * 8) + 2 * t) =
            pack_bf16(o[c][4 * j + 2 * r] * inv, o[c][4 * j + 2 * r + 1] * inv);
      }
  }
  named_sync(1 + wg, 128);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + (long long)b * p.osb +
                       (long long)h * p.osh;
  for (int e = wt; e < 64 * CPR; e += 128) {
    const int lr = e / CPR, chunk = e % CPR;
    const int n = q0 + 64 * wg + lr;
    if (n < p.nq)
      *reinterpret_cast<uint4*>(out + (long long)n * p.osn + chunk * 8) =
          *reinterpret_cast<const uint4*>(stage + lr * D + (chunk ^ (lr & SWZ)) * 8);
  }
}

// One block per (batch, head, 128-row query tile, key split); block order
// puts the splits of one query tile side by side.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attention_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<D>;
  extern __shared__ unsigned char sm90_smem[];
  unsigned char* qs = align1024(sm90_smem);
  unsigned char* kv = qs + kConsumers * C::kQBytes;
  Control& ctl = *reinterpret_cast<Control*>(kv + C::kStages * 2 * C::kKVBytes);

  long long blk = blockIdx.x;
  const int split = (int)(blk % p.splits);
  blk /= p.splits;
  const int qt = (int)(blk % p.q_tiles);
  const int bh = (int)(blk / p.q_tiles);
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = qt * kBlockM;

  if (!p.with_lse) {  // serving: a block of masked rows reads no key
    const int n = q0 + (int)threadIdx.x;
    const bool live = threadIdx.x < kBlockM && n < p.nq &&
                      (p.q_mask == nullptr || p.q_mask[(long long)b * p.nq + n] != 0);
    if (!__syncthreads_or(live)) {
      if (p.part != nullptr) return;  // combine_kernel writes masked rows' 0
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + (long long)b * p.osb +
                           (long long)h * p.osh;
      for (int e = threadIdx.x; e < kBlockM * (D / 8); e += kThreads) {
        const int m = q0 + e / (D / 8);
        if (m < p.nq)
          *reinterpret_cast<uint4*>(out + (long long)m * p.osn + (e % (D / 8)) * 8) =
              make_uint4(0, 0, 0, 0);
      }
      return;
    }
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&ctl.full[s], 32);                  // the producer warp
      mbar_init(&ctl.empty[s], kConsumers * 128);  // every consumer thread
    }
    mbar_init(&ctl.qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, broadcast from lane 0 so that ptxas sees the role
  // branch as warp-uniform (a branch it cannot prove uniform serialises
  // every wgmma behind it)
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == kConsumers) {
    const int t_begin = (int)((long long)split * p.k_tiles / p.splits);
    const int t_end = (int)((long long)(split + 1) * p.k_tiles / p.splits);
    producer<D>(&tq, &tk, &tv, p, qs, kv, ctl, b, h, q0, t_begin, t_end);
  } else {
    consumer<D>(p, qs, kv, ctl, role, b, h, bh, q0, split);
  }
}

struct CombineParams {
  const float* part;  // as Params::part
  void* out;          // bf16 (B, H, Nq, D) through os* strides
  float* lse;         // (B, H, Nq) f32, or null
  const unsigned char* q_mask;
  long long osb, osh, osn;
  int batch, heads, nq, splits;
};

// K1's combine pass: each row's S partials merged in split order. D / 8
// threads a row, 8 features (one 16-byte store) each.
template <int D>
__global__ void __launch_bounds__(128) combine_kernel(const CombineParams p) {
  constexpr int TPR = D / 8, RPB = 128 / TPR;
  const long long rows = (long long)p.batch * p.heads * p.nq;
  const long long row = (long long)blockIdx.x * RPB + threadIdx.x / TPR;
  if (row >= rows) return;
  const int c0 = (threadIdx.x % TPR) * 8;
  const int n = (int)(row % p.nq);
  const int bh = (int)(row / p.nq);
  const int b = bh / p.heads, h = bh % p.heads;
  const bool qv = p.q_mask == nullptr || p.q_mask[(long long)b * p.nq + n] != 0;
  const float* pm = p.part;
  const float* pl = p.part + p.splits * rows;
  const float* pa = p.part + 2 * p.splits * rows;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float M = -CUDART_INF_F, L = 0.f;
  if (qv || p.lse != nullptr) {  // a masked row of the serving forward reads nothing
    for (int s = 0; s < p.splits; ++s) M = fmaxf(M, pm[s * rows + row]);
    if (M != -CUDART_INF_F) {
      for (int s = 0; s < p.splits; ++s) {
        const float ms = pm[s * rows + row];
        if (ms == -CUDART_INF_F) continue;
        const float w = expf(ms - M);
        L += w * pl[s * rows + row];
        if (!qv) continue;
        const float4* x = reinterpret_cast<const float4*>(pa + (s * rows + row) * D + c0);
        const float4 lo = x[0], hi = x[1];
        acc[0] += w * lo.x; acc[1] += w * lo.y; acc[2] += w * lo.z; acc[3] += w * lo.w;
        acc[4] += w * hi.x; acc[5] += w * hi.y; acc[6] += w * hi.z; acc[7] += w * hi.w;
      }
    }
  }
  if (p.lse != nullptr && c0 == 0) p.lse[row] = M == -CUDART_INF_F ? CUDART_INF_F : M + logf(L);
  const float inv = qv ? 1.f / fmaxf(L, 1e-30f) : 0.f;
  uint4 v;
  v.x = pack_bf16(acc[0] * inv, acc[1] * inv);
  v.y = pack_bf16(acc[2] * inv, acc[3] * inv);
  v.z = pack_bf16(acc[4] * inv, acc[5] * inv);
  v.w = pack_bf16(acc[6] * inv, acc[7] * inv);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  *reinterpret_cast<uint4*>(out + (long long)b * p.osb + (long long)h * p.osh +
                            (long long)n * p.osn + c0) = v;
}

// ---------------------------------------------------------------- host

// Does the redesigned kernel take this problem? bf16 is the caller's test.
__host__ inline bool takes(const Problem& p) {
  return (p.features == 32 || p.features == 64 || p.features == 128) &&
         tma_operand(p.q, p.qs, p.batch, p.heads, p.nq) &&
         tma_operand(p.k, p.ks, p.batch, p.heads, p.nk) &&
         tma_operand(p.v, p.vs, p.batch, p.heads, p.nk) &&
         tma_operand(p.o, p.os, p.batch, p.heads, p.nq);
}

template <int D>
__host__ inline Af2LaunchPlan plan_attention(const Problem& p, int splits) {
  Af2LaunchPlan plan{};
  plan.blocks = (long long)p.batch * p.heads * ((p.nq + kBlockM - 1) / kBlockM) * splits;
  plan.threads = kThreads;
  plan.dynamic_smem = smem_bytes<D>();
  name_kernel(plan, "attention_kernel_sm90<%d>", D);
  return plan;
}

template <int D>
__host__ inline Af2LaunchPlan plan_combine(int batch, int heads, int nq) {
  constexpr int rows_per_block = 128 / (D / 8);
  Af2LaunchPlan plan{};
  plan.blocks = ((long long)batch * heads * nq + rows_per_block - 1) / rows_per_block;
  plan.threads = 128;
  plan.dynamic_smem = 0;
  name_kernel(plan, "combine_kernel<%d>", D);
  return plan;
}

// Launches attention_kernel_sm90; with splits > 1 it writes the partials
// into `part` (2 + D floats a row a split) and combine_kernel must follow.
template <int D>
__host__ inline cudaError_t launch_attention(const Problem& p, int splits, float* part,
                                             cudaStream_t stream) {
  const Af2LaunchPlan plan = plan_attention<D>(p, splits);
  if (!grid_fits(plan) || splits < 1 || (splits > 1 && part == nullptr))
    return cudaErrorInvalidConfiguration;
  CUtensorMap tq, tk, tv;
  if (!encode_bf16(&tq, p.q, p.qs, p.batch, p.heads, p.nq, D, 64) ||
      !encode_bf16(&tk, p.k, p.ks, p.batch, p.heads, p.nk, D, kBlockN) ||
      !encode_bf16(&tv, p.v, p.vs, p.batch, p.heads, p.nk, D, kBlockN))
    return cudaErrorInvalidValue;
  Params prm;
  prm.out = p.o;
  prm.lse = splits > 1 ? nullptr : p.lse;
  prm.part = splits > 1 ? part : nullptr;
  prm.with_lse = p.lse != nullptr;
  prm.q_mask = p.q_mask;
  prm.kv_mask = p.kv_mask;
  prm.osb = p.os.sb;
  prm.osh = p.os.sh;
  prm.osn = p.os.sn;
  prm.batch = p.batch;
  prm.heads = p.heads;
  prm.nq = p.nq;
  prm.nk = p.nk;
  prm.q_tiles = (p.nq + kBlockM - 1) / kBlockM;
  prm.k_tiles = (p.nk + kBlockN - 1) / kBlockN;
  prm.splits = splits;
  prm.scale_log2 = p.sm_scale * 1.4426950408889634f;
  const cudaError_t err = cudaFuncSetAttribute(
      attention_kernel_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.dynamic_smem);
  if (err != cudaSuccess) return err;
  attention_kernel_sm90<D><<<(unsigned)plan.blocks, plan.threads, plan.dynamic_smem, stream>>>(
      tq, tk, tv, prm);
  return cudaGetLastError();
}

template <int D>
__host__ inline cudaError_t launch_combine(const CombineParams& c, cudaStream_t stream) {
  const Af2LaunchPlan plan = plan_combine<D>(c.batch, c.heads, c.nq);
  if (!grid_fits(plan)) return cudaErrorInvalidConfiguration;
  combine_kernel<D><<<(unsigned)plan.blocks, plan.threads, 0, stream>>>(c);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace af2
