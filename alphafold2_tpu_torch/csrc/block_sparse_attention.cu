// K4: block-sparse flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel alphafold2_tpu/ops/pallas/block_sparse.py `_run`
// (:242, pallas_call :296, body `_fwd_core` :59), entered by
// `pallas_block_sparse_attention` (:415). On the training path with
// model.sparse_self_attn it carries both pair axial passes of every trunk
// layer.
//
// Computes, for every query row of query block i,
//     out = softmax_j(sm_scale * q . k_j | j in the active key blocks of i,
//                     kv_mask[j]) v_j
// with an online softmax (f32 running max, sum and accumulator), and with an
// lse buffer each row's logsumexp for the backward (K5a/K5b,
// block_sparse_attention_bwd.cu). Masked keys are excluded exactly. A row
// whose active blocks hold no valid key writes 0 and lse +inf (the TPU kernel
// gave such a row a finite average of its padded slots; every caller masks
// it). Query rows are not masked, as on the TPU.
//
// The TPU grid (batch*heads, q blocks, A) walks A = max_active slots for
// every query block and masks the padding slots; the global row makes A the
// block count, so a TPU query block visits every slot. Here a group of warps
// (block_sparse_tile.cuh) loops over its own query block's count of active
// blocks only, read from a compact (nb, A) list and an (nb,) count.
//
// What bounds it on the H100: per (query, active key) pair 4*D operations
// against each operand read once, far above the card's ops-per-byte ridge in
// bf16 at head dim 64, so the bound is the arithmetic rate over the active
// pairs. What the design does about it: probabilities never leave the SM,
// the q tile is staged once and reused across the row's active blocks, bf16
// products run on the tensor cores with mma.sync, and at block 16 four query
// blocks share a 128-thread block so the card has enough warps in flight.
// Each key block is staged per query block that needs it (no reuse across
// query blocks), and there is no cp.async/TMA pipelining or wgmma: later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (alphafold2_tpu_torch/ops/cuda/build.py). Bound with ctypes.

#include "block_sparse_tile.cuh"

namespace {

using namespace af2::sparse;
using af2::Operand;

struct Fwd {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                     // (batch, heads, n) f32, or null
  const unsigned char* kv_mask;   // (batch, n) 0/1, or null
  const int* idx;                 // (nb, max_active) active key blocks per query block
  const int* cnt;                 // (nb,) their count
  int max_active;
  Operand qs, ks, vs, os;
  int batch, heads, n, block;
  float sm_scale;
};

template <typename T, int R, int D>
struct FwdSmem {
  static constexpr int V = kVec<T>, LD = D + V, LT = R + V;
  // q and k tiles (R x LD), v transposed (D x LT), f32 scratch per warp
  static constexpr int kGroup = 2 * R * LD + D * LT + Group<R>::kWarps * kScratch<T, R>;
  static constexpr int kBytes = Group<R>::kPerBlock * kGroup * (int)sizeof(T);
};

template <typename T, int R, int D>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Fwd p, int vec) {
  using G = Group<R>;
  using S = FwdSmem<T, R, D>;
  constexpr int NT = R / 8, ON = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp / G::kWarps, wg = warp % G::kWarps;
  const int gtid = threadIdx.x - group * G::kThreads;

  const int tiles = p.n / R;  // row tiles per (batch, head)
  const long long tile = (long long)blockIdx.x * G::kPerBlock + group;
  if (tile >= (long long)p.batch * p.heads * tiles) return;  // the whole group leaves
  const int bh = (int)(tile / tiles);
  const int r0 = (int)(tile % tiles) * R;
  const int b = bh / p.heads, h = bh % p.heads;
  const int qb = r0 / p.block, nsub = p.block / R;
  const bool v16 = vec != 0;

  T* qs = reinterpret_cast<T*>(smem_raw) + group * S::kGroup;
  T* ks = qs + R * S::LD;
  T* vt = ks + R * S::LD;  // D x LT
  T* scratch = vt + D * S::LT + wg * kScratch<T, R>;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  stage<T, R, D>(qs, S::LD, false, q, p.qs, b, h, r0, gtid, G::kThreads, v16);
  float acc[ON][4];
#pragma unroll
  for (int j = 0; j < ON; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};
  const T* q_warp = qs + 16 * wg * S::LD;

  const int count = p.cnt[qb];
  const int* list = p.idx + (long long)qb * p.max_active;
  for (int a = 0; a < count; ++a) {
    const int kb = list[a];
    for (int sub = 0; sub < nsub; ++sub) {
      const int k0 = kb * p.block + sub * R;
      group_sync(group, G::kThreads);  // the group is done with the last tile
      stage<T, R, D>(ks, S::LD, false, k, p.ks, b, h, k0, gtid, G::kThreads, v16);
      stage<T, R, D>(vt, S::LT, true, v, p.vs, b, h, k0, gtid, G::kThreads, v16);
      group_sync(group, G::kThreads);

      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      mma_smem<NT, D>(s, q_warp, S::LD, ks, S::LD, g, t);

      bool valid[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) valid[j][e] = key_valid(p.kv_mask, b, p.n, k0 + 8 * j + 2 * t + e);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][2 * r + e];
            x = valid[j][e] ? x * p.sm_scale : -CUDART_INF_F;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[r], mx);
        float alpha = 1.f, rs = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][2 * r + e];
            x = (m_new == -CUDART_INF_F || !valid[j][e]) ? 0.f : expf(x - m_new);
            rs += x;
          }
        if (m_new != -CUDART_INF_F) alpha = expf(m_run[r] - m_new);
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l_run[r] = l_run[r] * alpha + rs;
        m_run[r] = m_new;
#pragma unroll
        for (int j = 0; j < ON; ++j) {
          acc[j][2 * r] *= alpha;
          acc[j][2 * r + 1] *= alpha;
        }
      }
      mma_acc<ON, R>(acc, s, vt, S::LT, g, t, scratch);  // O += P V
    }
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = r0 + 16 * wg + g + 8 * r;
    if (p.lse != nullptr && t == 0) p.lse[(long long)bh * p.n + n] = af2::row_lse(m_run[r], l_run[r]);
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
    T* orow = o + at(p.os, b, h, n);
#pragma unroll
    for (int j = 0; j < ON; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) store(orow + 8 * j + 2 * t + e, acc[j][2 * r + e] * inv);
  }
}

// One block per G::kPerBlock row tiles of R queries (groups of R / 16 warps).
template <typename T, int R, int D>
Af2LaunchPlan plan_launch(const Fwd& p) {
  using G = Group<R>;
  Af2LaunchPlan plan{};
  const long long groups = (long long)p.batch * p.heads * (p.n / R);
  plan.blocks = (groups + G::kPerBlock - 1) / G::kPerBlock;
  plan.threads = kThreads;
  plan.dynamic_smem = FwdSmem<T, R, D>::kBytes;
  af2::name_kernel(plan, "fwd_kernel<%s,%d,%d>", af2::TypeName<T>::value, R, D);
  return plan;
}

// Launches the plan's kernel; with `plan_out` it only fills the plan.
template <typename T, int R, int D>
cudaError_t launch(const Fwd& p, cudaStream_t stream, Af2LaunchPlan* plan_out) {
  const Af2LaunchPlan plan = plan_launch<T, R, D>(p);
  if (plan_out != nullptr) {
    *plan_out = plan;
    return cudaSuccess;
  }
  if (!af2::grid_fits(plan)) return cudaErrorInvalidConfiguration;
  const bool vec = vec_ok<T>({p.q, p.k, p.v}, {&p.qs, &p.ks, &p.vs});
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<T, R, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         plan.dynamic_smem);
  if (err != cudaSuccess) return err;
  fwd_kernel<T, R, D><<<(unsigned)plan.blocks, plan.threads, plan.dynamic_smem, stream>>>(
      p, vec ? 1 : 0);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t dispatch_dim(const Fwd& p, int head_dim, cudaStream_t s, Af2LaunchPlan* plan_out) {
  switch (head_dim) {
    case 16: return launch<T, R, 16>(p, s, plan_out);
    case 32: return launch<T, R, 32>(p, s, plan_out);
    case 64: return launch<T, R, 64>(p, s, plan_out);
    case 128: return launch<T, R, 128>(p, s, plan_out);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_rows(const Fwd& p, int head_dim, cudaStream_t s, Af2LaunchPlan* plan_out) {
  switch (p.block) {
    case 16: return dispatch_dim<T, 16>(p, head_dim, s, plan_out);
    case 32: return dispatch_dim<T, 32>(p, head_dim, s, plan_out);
    case 64:
    case 128: return dispatch_dim<T, 64>(p, head_dim, s, plan_out);
    default: return cudaErrorInvalidValue;
  }
}

// Launches K4, or with `plan_out` only fills its plan (strides may then be
// null and no pointer is read).
int run(int dtype, const void* q, const void* k, const void* v, void* out, float* lse,
        const unsigned char* kv_mask, const int* idx, const int* cnt, int max_active,
        const long long* strides, int batch, int heads, int n, int head_dim, int block,
        float sm_scale, void* stream, Af2LaunchPlan* plan_out = nullptr) {
  if (block <= 0 || n % block != 0) return cudaErrorInvalidValue;
  Fwd p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.lse = lse;
  p.kv_mask = kv_mask;
  p.idx = idx;
  p.cnt = cnt;
  p.max_active = max_active;
  Operand* ops[4] = {&p.qs, &p.ks, &p.vs, &p.os};
  for (int i = 0; i < 4; ++i) {
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
  if (dtype == 0) return dispatch_rows<float>(p, head_dim, s, plan_out);
  if (dtype == 1) return dispatch_rows<__nv_bfloat16>(p, head_dim, s, plan_out);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, out: (batch, heads, n, head_dim) read and written through
// `strides` (12 element strides: batch, head, token of q, k, v and out; the
// head-dim stride must be 1). idx/cnt: the layout's active key blocks per
// query block, (n / block, max_active) and (n / block,) int32 on the device.
// lse: a contiguous (batch, heads, n) f32 buffer, or null for the forward
// without it. dtype: 0 = float32, 1 = bfloat16. n must be a multiple of
// block (16, 32, 64 or 128). Returns the cudaError_t of the launch.
extern "C" int af2_block_sparse_attention(int dtype, const void* q, const void* k,
                                          const void* v, void* out, float* lse,
                                          const unsigned char* kv_mask, const int* idx,
                                          const int* cnt, int max_active,
                                          const long long* strides, int batch, int heads,
                                          int n, int head_dim, int block, float sm_scale,
                                          void* stream) {
  return run(dtype, q, k, v, out, lse, kv_mask, idx, cnt, max_active, strides, batch, heads, n,
             head_dim, block, sm_scale, stream);
}

// K4's launch plan at one shape (with or without lse: the same kernel);
// touches no device. Returns 0, or cudaErrorInvalidValue for a dtype, head
// dim, block or length the kernel does not take.
extern "C" int af2_block_sparse_attention_plan(int dtype, int batch, int heads, int n,
                                               int head_dim, int block, Af2LaunchPlan* plan) {
  return run(dtype, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0,
             nullptr, batch, heads, n, head_dim, block, 1.f, nullptr, plan);
}
