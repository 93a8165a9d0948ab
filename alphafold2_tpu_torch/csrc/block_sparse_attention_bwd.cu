// K5a/K5b: the backward of block-sparse attention (K4) for Hopper (sm_90a).
//
// Replaces the TPU kernels alphafold2_tpu/ops/pallas/block_sparse.py
// `_run_dq` (:306, pallas_call :339, body `_dq_kernel` :133) and `_run_dkv`
// (:348, pallas_call :388, body `_dkv_kernel` :182), the custom-VJP backward
// of `block_sparse_attention_pallas` (alphafold2_tpu/ops/sparse.py:167).
// With the forward's row logsumexp (lse) and dsum = rowsum(dO * O), both
// recompute the probabilities of the active blocks instead of reading any
// quadratic residual:
//
//     p  = exp(sm_scale * q.k - lse)    (0 for a masked key or lse = +inf)
//     ds = p * (dO.v - dsum)
//     K5a  dq = sm_scale * sum_j ds[:, j] k_j   over the query block's row list
//     K5b  dv = sum_i p[i, :] dO_i              over the key block's column list
//          dk = sm_scale * sum_i ds[i, :] q_i   (the layout transposed)
//
// What bounds it on the H100: per (query, active key) pair K5a does 3
// products of 2*D operations (q.k recompute, dO.v, ds.k) and K5b 4, against
// each operand read once: at the sparse training pass (128 x 128 at block
// 16, head dim 64, 68.8% of the pairs active) that is little work per byte,
// and the bytes give the larger bound (chip_smoke.py computes both from the
// run's inputs). What held the first design (the f32 and
// fallback kernels below) far from it: a group of one warp per 16-row block
// at block 16, mma.sync m16n8k16 on 32-bit shared loads, every tile staged
// synchronously between two barriers, the operands read across tokens
// staged a second time transposed, and every active block staged once for
// each block that lists it.
//
// bf16 at head dim 32, 64 or 128 with operands TMA can describe (and every
// block size) runs sparse_dq_kernel_sm90 / sparse_dkv_kernel_sm90
// (block_sparse_bwd_sm90.cuh): K3's Hopper consumers (wgmma on TMA-fed
// tiles, K, Q and dO read MN-major through their descriptors, a producer
// warp keeping a 3-stage ring in flight) on 64-row resident tiles that
// stream the union of their blocks' lists as gathered stages, with one mask
// word set per warp from the stage's layout bits. The union costs products
// the lists do not need: with BlockSparseConfig's defaults it is 7.5 of the
// 8 blocks a tile at the training pass (N 128, block 16) against a mean
// list of 5.5 (1.36x the listed work), 26.0 against 12.4 at N 512 (2.10x),
// 7.0 against 5.5 at block 32 (1.27x), and exactly the list at block 64 and
// 128 (one resident block a tile). Every streamed block is then staged once
// per 64 resident rows, not once per block that lists it.
//
// f32, head dim 16 and bf16 operands TMA cannot describe run dq_kernel /
// dkv_kernel below: the TPU's sequential slot axis becomes a loop inside a
// group of warps over that block's own list (row list in K5a, column list
// in K5b), so padding slots are never visited; all products on the tensor
// cores in bf16 with p and ds passed in registers (on the CUDA cores in
// f32), the operands read across tokens staged a second time transposed.
// Both routes sum each output element in one thread in a fixed order: no
// atomics, bitwise deterministic. bf16 rounds ds (for dq and dk) and p (for
// dv) to bf16 before their products, as `_dq_kernel` (:173) and
// `_dkv_kernel` (:221, :229) round them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (alphafold2_tpu_torch/ops/cuda/build.py). Bound with ctypes.

#include "block_sparse_bwd_sm90.cuh"
#include "block_sparse_tile.cuh"

namespace {

using namespace af2::sparse;
using af2::Operand;

struct Bwd {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;   // (batch, heads, n) from the forward; +inf: no valid key
  const float* dsum;  // (batch, heads, n) rowsum(dO * O)
  void* dq;
  void* dk;
  void* dv;
  const unsigned char* kv_mask;  // (batch, n) 0/1, or null
  const int* idx;  // K5a: row lists (nb, max_active); K5b: column lists
  const int* cnt;  // (nb,) their counts
  int max_active;
  Operand qs, ks, vs, dos, dqs, dks, dvs;
  int batch, heads, n, block;
  float sm_scale;
};

template <typename T, int R, int D>
struct BwdSmem {
  static constexpr int V = kVec<T>, LD = D + V, LT = R + V;
  static constexpr int kScratchWarps = Group<R>::kWarps * kScratch<T, R>;
  // K5a: q, dO, k, v (R x LD), k transposed (D x LT), scratch
  static constexpr int kDq = 4 * R * LD + D * LT + kScratchWarps;
  // K5b: k, v, q, dO (R x LD), q and dO transposed (D x LT), scratch; then
  // the query tile's lse and dsum (2 x R floats)
  static constexpr int kDkv = 4 * R * LD + 2 * D * LT + kScratchWarps;
  static constexpr int kDqBytes = Group<R>::kPerBlock * kDq * (int)sizeof(T);
  static constexpr int kDkvGroupBytes = kDkv * (int)sizeof(T) + 2 * R * (int)sizeof(float);
  static constexpr int kDkvBytes = Group<R>::kPerBlock * kDkvGroupBytes;
};

// This group's row tile; false if the group has none.
struct Tile {
  int bh, b, h, r0, blk;
};

template <int R>
__device__ __forceinline__ bool group_tile(const Bwd& p, int group, Tile& tl) {
  const int tiles = p.n / R;
  const long long tile = (long long)blockIdx.x * Group<R>::kPerBlock + group;
  if (tile >= (long long)p.batch * p.heads * tiles) return false;
  tl.bh = (int)(tile / tiles);
  tl.r0 = (int)(tile % tiles) * R;
  tl.b = tl.bh / p.heads;
  tl.h = tl.bh % p.heads;
  tl.blk = tl.r0 / p.block;
  return true;
}

template <typename T, int R, int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(Bwd p, int vec) {
  using G = Group<R>;
  using S = BwdSmem<T, R, D>;
  constexpr int NT = R / 8, ON = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp / G::kWarps, wg = warp % G::kWarps;
  const int gtid = threadIdx.x - group * G::kThreads;
  Tile tl;
  if (!group_tile<R>(p, group, tl)) return;
  const int b = tl.b, h = tl.h, nsub = p.block / R;
  const bool v16 = vec != 0;

  T* qs = reinterpret_cast<T*>(smem_raw) + group * S::kDq;
  T* dos = qs + R * S::LD;
  T* ks = dos + R * S::LD;
  T* vs = ks + R * S::LD;
  T* kT = vs + R * S::LD;  // D x LT
  T* scratch = kT + D * S::LT + wg * kScratch<T, R>;
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  stage<T, R, D>(qs, S::LD, false, static_cast<const T*>(p.q), p.qs, b, h, tl.r0, gtid,
                 G::kThreads, v16);
  stage<T, R, D>(dos, S::LD, false, static_cast<const T*>(p.dout), p.dos, b, h, tl.r0, gtid,
                 G::kThreads, v16);
  float lse[2], dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = (long long)tl.bh * p.n + tl.r0 + 16 * wg + g + 8 * r;
    lse[r] = p.lse[row];
    dsum[r] = lse[r] < CUDART_INF_F ? p.dsum[row] : 0.f;
  }
  float acc[ON][4];
#pragma unroll
  for (int j = 0; j < ON; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const T* q_warp = qs + 16 * wg * S::LD;
  const T* do_warp = dos + 16 * wg * S::LD;

  const int count = p.cnt[tl.blk];
  const int* list = p.idx + (long long)tl.blk * p.max_active;
  for (int a = 0; a < count; ++a) {
    const int kb = list[a];
    for (int sub = 0; sub < nsub; ++sub) {
      const int k0 = kb * p.block + sub * R;
      group_sync(group, G::kThreads);
      stage<T, R, D>(ks, S::LD, false, k, p.ks, b, h, k0, gtid, G::kThreads, v16);
      stage<T, R, D>(kT, S::LT, true, k, p.ks, b, h, k0, gtid, G::kThreads, v16);
      stage<T, R, D>(vs, S::LD, false, v, p.vs, b, h, k0, gtid, G::kThreads, v16);
      group_sync(group, G::kThreads);
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_smem<NT, D>(s, q_warp, S::LD, ks, S::LD, g, t);
      mma_smem<NT, D>(dp, do_warp, S::LD, vs, S::LD, g, t);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool valid = key_valid(p.kv_mask, b, p.n, k0 + 8 * j + 2 * t + c);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c;
            const float pr =
                (valid && lse[r] < CUDART_INF_F) ? expf(s[j][e] * p.sm_scale - lse[r]) : 0.f;
            s[j][e] = pr * (dp[j][e] - dsum[r]);  // ds
          }
        }
      mma_acc<ON, R>(acc, s, kT, S::LT, g, t, scratch);  // dq += ds K
    }
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    T* row = dq + at(p.dqs, b, h, tl.r0 + 16 * wg + g + 8 * r);
#pragma unroll
    for (int j = 0; j < ON; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) store(row + 8 * j + 2 * t + c, acc[j][2 * r + c] * p.sm_scale);
  }
}

template <typename T, int R, int D>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Bwd p, int vec) {
  using G = Group<R>;
  using S = BwdSmem<T, R, D>;
  constexpr int NT = R / 8, ON = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp / G::kWarps, wg = warp % G::kWarps;
  const int gtid = threadIdx.x - group * G::kThreads;
  Tile tl;
  if (!group_tile<R>(p, group, tl)) return;  // tl.r0: this group's first key
  const int b = tl.b, h = tl.h, nsub = p.block / R;
  const bool v16 = vec != 0;

  unsigned char* base = smem_raw + group * S::kDkvGroupBytes;
  T* ks = reinterpret_cast<T*>(base);
  T* vs = ks + R * S::LD;
  T* qs = vs + R * S::LD;
  T* dos = qs + R * S::LD;
  T* qT = dos + R * S::LD;  // D x LT
  T* doT = qT + D * S::LT;  // D x LT
  T* scratch = doT + D * S::LT + wg * kScratch<T, R>;
  float* lse_s = reinterpret_cast<float*>(base + S::kDkv * (int)sizeof(T));
  float* dsum_s = lse_s + R;
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);

  stage<T, R, D>(ks, S::LD, false, static_cast<const T*>(p.k), p.ks, b, h, tl.r0, gtid,
                 G::kThreads, v16);
  stage<T, R, D>(vs, S::LD, false, static_cast<const T*>(p.v), p.vs, b, h, tl.r0, gtid,
                 G::kThreads, v16);
  const int key0 = tl.r0 + 16 * wg + g;  // this lane's key rows: key0 and key0 + 8
  const bool kvalid[2] = {key_valid(p.kv_mask, b, p.n, key0),
                          key_valid(p.kv_mask, b, p.n, key0 + 8)};
  float dk[ON][4], dv[ON][4];
#pragma unroll
  for (int j = 0; j < ON; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const T* k_warp = ks + 16 * wg * S::LD;
  const T* v_warp = vs + 16 * wg * S::LD;

  const int count = p.cnt[tl.blk];
  const int* list = p.idx + (long long)tl.blk * p.max_active;
  for (int a = 0; a < count; ++a) {
    const int qb = list[a];
    for (int sub = 0; sub < nsub; ++sub) {
      const int q0 = qb * p.block + sub * R;
      group_sync(group, G::kThreads);
      stage<T, R, D>(qs, S::LD, false, q, p.qs, b, h, q0, gtid, G::kThreads, v16);
      stage<T, R, D>(qT, S::LT, true, q, p.qs, b, h, q0, gtid, G::kThreads, v16);
      stage<T, R, D>(dos, S::LD, false, dout, p.dos, b, h, q0, gtid, G::kThreads, v16);
      stage<T, R, D>(doT, S::LT, true, dout, p.dos, b, h, q0, gtid, G::kThreads, v16);
      for (int e = gtid; e < R; e += G::kThreads) {
        const long long row = (long long)tl.bh * p.n + q0 + e;
        const float l = p.lse[row];
        lse_s[e] = l;
        dsum_s[e] = l < CUDART_INF_F ? p.dsum[row] : 0.f;
      }
      group_sync(group, G::kThreads);
      float s[NT][4], dp[NT][4];  // rows: this warp's keys; columns: the tile's queries
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_smem<NT, D>(s, k_warp, S::LD, qs, S::LD, g, t);
      mma_smem<NT, D>(dp, v_warp, S::LD, dos, S::LD, g, t);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qj = 8 * j + 2 * t + c;
          const float l = lse_s[qj];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c;
            const float pr =
                (kvalid[r] && l < CUDART_INF_F) ? expf(s[j][e] * p.sm_scale - l) : 0.f;
            s[j][e] = pr;
            dp[j][e] = pr * (dp[j][e] - dsum_s[qj]);  // ds
          }
        }
      mma_acc<ON, R>(dv, s, doT, S::LT, g, t, scratch);  // dv += p dO
      mma_acc<ON, R>(dk, dp, qT, S::LT, g, t, scratch);  // dk += ds q
    }
  }

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    T* krow = dk_out + at(p.dks, b, h, key0 + 8 * r);
    T* vrow = dv_out + at(p.dvs, b, h, key0 + 8 * r);
#pragma unroll
    for (int j = 0; j < ON; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        store(krow + 8 * j + 2 * t + c, dk[j][2 * r + c] * p.sm_scale);
        store(vrow + 8 * j + 2 * t + c, dv[j][2 * r + c]);
      }
  }
}

enum class Which { kDq, kDkv };

// One block per G::kPerBlock row tiles of R queries (K5a) or keys (K5b).
template <typename T, int R, int D>
Af2LaunchPlan plan_launch(Which which, const Bwd& p) {
  using G = Group<R>;
  using S = BwdSmem<T, R, D>;
  Af2LaunchPlan plan{};
  const long long groups = (long long)p.batch * p.heads * (p.n / R);
  plan.blocks = (groups + G::kPerBlock - 1) / G::kPerBlock;
  plan.threads = kThreads;
  plan.dynamic_smem = which == Which::kDq ? S::kDqBytes : S::kDkvBytes;
  af2::name_kernel(plan, "%s<%s,%d,%d>", which == Which::kDq ? "dq_kernel" : "dkv_kernel",
                   af2::TypeName<T>::value, R, D);
  return plan;
}

// Launches the plan's kernel; with `plan_out` it only fills the plan.
template <typename T, int R, int D>
cudaError_t launch(Which which, const Bwd& p, cudaStream_t stream, Af2LaunchPlan* plan_out) {
  const Af2LaunchPlan plan = plan_launch<T, R, D>(which, p);
  if (plan_out != nullptr) {
    *plan_out = plan;
    return cudaSuccess;
  }
  if (!af2::grid_fits(plan)) return cudaErrorInvalidConfiguration;
  const bool vec = vec_ok<T>({p.q, p.k, p.v, p.dout}, {&p.qs, &p.ks, &p.vs, &p.dos});
  const unsigned blocks = (unsigned)plan.blocks;
  const int smem = plan.dynamic_smem;
  cudaError_t err;
  if (which == Which::kDq) {
    err = cudaFuncSetAttribute(dq_kernel<T, R, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    dq_kernel<T, R, D><<<blocks, plan.threads, smem, stream>>>(p, vec ? 1 : 0);
  } else {
    err = cudaFuncSetAttribute(dkv_kernel<T, R, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    dkv_kernel<T, R, D><<<blocks, plan.threads, smem, stream>>>(p, vec ? 1 : 0);
  }
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t dispatch_dim(Which which, const Bwd& p, int head_dim, cudaStream_t s,
                         Af2LaunchPlan* plan_out) {
  switch (head_dim) {
    case 16: return launch<T, R, 16>(which, p, s, plan_out);
    case 32: return launch<T, R, 32>(which, p, s, plan_out);
    case 64: return launch<T, R, 64>(which, p, s, plan_out);
    case 128: return launch<T, R, 128>(which, p, s, plan_out);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_rows(Which which, const Bwd& p, int head_dim, cudaStream_t s,
                          Af2LaunchPlan* plan_out) {
  switch (p.block) {
    case 16: return dispatch_dim<T, 16>(which, p, head_dim, s, plan_out);
    case 32: return dispatch_dim<T, 32>(which, p, head_dim, s, plan_out);
    case 64:
    case 128: return dispatch_dim<T, 64>(which, p, head_dim, s, plan_out);
    default: return cudaErrorInvalidValue;
  }
}

namespace grad = af2::sm90::grad;

// The head dims the Hopper kernels are built for (bf16, TMA-aligned
// operands).
bool sm90_head_dim(int head_dim) {
  return head_dim == 32 || head_dim == 64 || head_dim == 128;
}

template <int D>
cudaError_t dispatch_sm90(Which which, const grad::GradOperands& a, const grad::ListParams& lists,
                          cudaStream_t stream, Af2LaunchPlan* plan_out) {
  const bool dkv = which == Which::kDkv;
  if (plan_out != nullptr) {
    *plan_out = grad::plan_listed<D>(dkv, a.batch, a.heads, a.nq);
    return cudaSuccess;
  }
  return grad::launch_listed<D>(dkv, a, lists, stream);
}

// strides: 21 element strides, (batch, head, token) of q, k, v, dout, dq, dk
// and dv in that order (those of an absent output are ignored); the
// head-dim stride of each must be 1. idx/cnt/max_active: the layout's lists
// the older kernels walk; lists: the union lists the Hopper kernels stream
// (ops/cuda/block_sparse.py union_stages). `info`, when given, receives the
// kernel taken (1: sparse_dq_kernel_sm90 / sparse_dkv_kernel_sm90, 0:
// another). With `plan_out` it only fills the plan (strides may then be
// null, no pointer is read, and `aligned` stands for the operands'
// alignment; a launch finds it from the pointers and strides).
int run(Which which, int dtype, const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* dsum, void* dq, void* dk, void* dv,
        const unsigned char* kv_mask, const int* idx, const int* cnt, int max_active,
        const grad::ListParams& lists, const long long* strides, int batch, int heads, int n,
        int head_dim, int block, float sm_scale, int* info, void* stream,
        Af2LaunchPlan* plan_out = nullptr, int aligned = 0) {
  if (block <= 0 || n % block != 0) return cudaErrorInvalidValue;
  Bwd p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.dsum = dsum;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.kv_mask = kv_mask;
  p.idx = idx;
  p.cnt = cnt;
  p.max_active = max_active;
  Operand* ops[7] = {&p.qs, &p.ks, &p.vs, &p.dos, &p.dqs, &p.dks, &p.dvs};
  for (int i = 0; i < 7; ++i) {
    ops[i]->sb = strides != nullptr ? strides[3 * i] : 0;
    ops[i]->sh = strides != nullptr ? strides[3 * i + 1] : 0;
    ops[i]->sn = strides != nullptr ? strides[3 * i + 2] : 0;
    ops[i]->sr = 0;
  }
  p.batch = batch;
  p.heads = heads;
  p.n = n;
  p.block = block;
  p.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dkv = which == Which::kDkv;
  grad::GradOperands a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.dsum = dsum;
  a.q_mask = nullptr;
  a.kv_mask = kv_mask;
  a.out0 = dkv ? dk : dq;
  a.out1 = dkv ? dv : nullptr;
  a.qs = p.qs;
  a.ks = p.ks;
  a.vs = p.vs;
  a.dos = p.dos;
  a.o0s = dkv ? p.dks : p.dqs;
  a.o1s = p.dvs;
  a.batch = batch;
  a.heads = heads;
  a.nq = n;
  a.nk = n;
  a.sm_scale = sm_scale;
  const bool sm90 = dtype == 1 && sm90_head_dim(head_dim) &&
                    (block == 16 || block == 32 || block == 64 || block == 128) &&
                    (plan_out != nullptr ? aligned != 0 : grad::takes(a, dkv));
  if (info != nullptr) info[0] = sm90 ? 1 : 0;
  if (sm90) {
    switch (head_dim) {
      case 32: return dispatch_sm90<32>(which, a, lists, s, plan_out);
      case 64: return dispatch_sm90<64>(which, a, lists, s, plan_out);
      default: return dispatch_sm90<128>(which, a, lists, s, plan_out);
    }
  }
  if (dtype == 0) return dispatch_rows<float>(which, p, head_dim, s, plan_out);
  if (dtype == 1) return dispatch_rows<__nv_bfloat16>(which, p, head_dim, s, plan_out);
  return cudaErrorInvalidValue;
}

}  // namespace

// K5a. q, k, v, dout, dq: (batch, heads, n, head_dim) through `strides`; lse
// and dsum contiguous (batch, heads, n) f32; idx/cnt the layout's row lists
// (active key blocks per query block) as K4 takes them; u_blocks, u_bits,
// u_counts, u_max_stages: the union of the row lists per 64-query tile
// (union_stages). dtype: 0 = float32, 1 = bfloat16. info (1 int out): 1 if
// sparse_dq_kernel_sm90 ran. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int af2_block_sparse_attention_bwd_dq(
    int dtype, const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* dsum, void* dq, const unsigned char* kv_mask, const int* idx, const int* cnt,
    int max_active, const int* u_blocks, const int* u_bits, const int* u_counts,
    int u_max_stages, const long long* strides, int batch, int heads, int n, int head_dim,
    int block, float sm_scale, int* info, void* stream) {
  return run(Which::kDq, dtype, q, k, v, dout, lse, dsum, dq, nullptr, nullptr, kv_mask, idx,
             cnt, max_active, grad::list_params(u_blocks, u_bits, u_counts, u_max_stages, block),
             strides, batch, heads, n, head_dim, block, sm_scale, info, stream);
}

// K5b. As K5a, writing dk and dv; idx/cnt are the column lists (the query
// blocks that attend each key block: the layout transposed) and the u_*
// lists their union per 64-key tile. info: 1 if sparse_dkv_kernel_sm90 ran.
extern "C" int af2_block_sparse_attention_bwd_dkv(
    int dtype, const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* dsum, void* dk, void* dv, const unsigned char* kv_mask, const int* idx,
    const int* cnt, int max_active, const int* u_blocks, const int* u_bits, const int* u_counts,
    int u_max_stages, const long long* strides, int batch, int heads, int n, int head_dim,
    int block, float sm_scale, int* info, void* stream) {
  return run(Which::kDkv, dtype, q, k, v, dout, lse, dsum, nullptr, dk, dv, kv_mask, idx, cnt,
             max_active, grad::list_params(u_blocks, u_bits, u_counts, u_max_stages, block),
             strides, batch, heads, n, head_dim, block, sm_scale, info, stream);
}

// The launch plan of K5a (which = 0) or K5b (which = 1) at one shape, given
// whether the operands are TMA-aligned; touches no device. Returns 0, or
// cudaErrorInvalidValue for a dtype, head dim, block, length or `which` the
// kernels do not take.
extern "C" int af2_block_sparse_attention_bwd_plan(int which, int dtype, int batch, int heads,
                                                   int n, int head_dim, int block, int aligned,
                                                   Af2LaunchPlan* plan) {
  if (which != 0 && which != 1) return cudaErrorInvalidValue;
  return run(which == 0 ? Which::kDq : Which::kDkv, dtype, nullptr, nullptr, nullptr, nullptr,
             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0,
             grad::list_params(nullptr, nullptr, nullptr, 0, block), nullptr, batch, heads, n,
             head_dim, block, 1.f, nullptr, nullptr, plan, aligned);
}
