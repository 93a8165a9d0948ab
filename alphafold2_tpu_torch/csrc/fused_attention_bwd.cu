// K3a/K3b: the backward of fused attention (K1) for Hopper (sm_90a).
//
// Replaces the TPU kernels alphafold2_tpu/ops/pallas/axial.py `_run_dq`
// (:268, pallas_call :275, body `_dq_kernel` :123) and `_run_dkv` (:306,
// pallas_call :313, body `_dkv_kernel` :166), the custom-VJP backward of
// `fused_attention` (:356). With the forward's row logsumexp (lse, written by
// af2_fused_attention_lse) and dsum = rowsum(dO * O), both kernels recompute
// the probabilities instead of reading any quadratic residual:
//
//     p  = exp(sm_scale * q.k - lse)      (0 for a masked key, a masked query
//                                          row, or a row with lse = +inf)
//     ds = p * (dO.v - dsum)
//     K3a  dq = sm_scale * sum_j ds[:, j] k_j          one block per 64 queries
//     K3b  dv = sum_i p[i, :] dO_i                     one block per 64 keys
//          dk = sm_scale * sum_i ds[i, :] q_i
//
// The TPU schedule is kept: two kernels, each looping in-block over the other
// side's tiles (the TPU's sequential grid axis), each with its own recompute
// of q.k. No atomics: every output element is summed in a fixed order, so the
// backward is bitwise deterministic. Masked queries give dq = 0 and add
// nothing to dk/dv (the JAX path zeroes their cotangent with jnp.where at
// :433); masked keys get dk = dv = 0.
//
// What bounds it on the H100: per (query, key) pair K3a does three products
// of 2*D operations (the q.k recompute, dO.v, ds.k) and K3b four (q.k, dO.v,
// p^T dO, ds^T q), against O((Nq + Nk) * D) bytes, so at the training shapes
// (head dim 64) the tensor-core rate bounds every pass; the per-pair exp and
// the short loops of the small passes (5 to 128 keys a row) make latency the
// practical limit there. Three things kept the first design far from that
// bound, and the plan addresses each (it picks a kernel from dtype, head dim
// and alignment alone, never by retrying a failed launch):
//
// * Occupancy. The cross passes (320 x 16384) gave one kernel 40 blocks for
//   132 SMs, each looping over 256 tiles. ops/cuda/axial.py grad_splits()
//   cuts the long loop into contiguous ranges wherever a kernel's grid is
//   short of two waves (7 ranges there); each block writes f32 partials and
//   grad_merge_kernel adds them in split order, so the result keeps its bits
//   from run to run.
// * Synchronous staging. bf16 at head dim 32, 64 or 128 with operands TMA can
//   describe runs dq_kernel_sm90 / dkv_kernel_sm90
//   (fused_attention_bwd_sm90.cuh): a producer warp keeps TMA loads of the
//   streamed operand pair in flight in an mbarrier ring while the consumer
//   warpgroup computes, and tiles with no valid key (K3a) or no live query
//   (K3b) are never staged.
// * Transposed copies and narrow products. The Hopper kernels run all four
//   products as wgmma and read the operands crossed by the second products
//   (k in K3a; q and dO in K3b) transposed through their shared-memory
//   descriptors, where the first design staged a transposed copy of each
//   and ran mma.sync on 32-bit shared loads.
//
// Where ops/cuda/axial.py grad_route() says "onepass", the autograd
// Functions run neither: af2_fused_attention_bwd launches the one-pass
// backward of fused_attention_bwd_onepass_sm90.cuh (dq, dk and dv from one
// pass over each tile pair, dq summed across a thread-block cluster), and
// af2_attention_dsum the pass both routes read, rowsum(dO * O), in one read
// of O and dO.
//
// Every other bf16 problem runs dq_kernel_mma / dkv_kernel_mma below
// (mma.sync m16n8k16, the probabilities and ds passed in registers, rounded
// to bf16 first as `_dkv_kernel` rounds them at :199, :207); f32 operands run
// dq_kernel / dkv_kernel on the CUDA cores, the exactness path of the
// small-model checks. Head dims past 128 take the D-chunked kernels of
// tied_row_attention_bwd.cu (ops/cuda/axial.py routes them).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (alphafold2_tpu_torch/ops/cuda/build.py). Bound with ctypes.

#include "attention_tile.cuh"
#include "fused_attention_bwd_onepass_sm90.cuh"

namespace {

using af2::kBlockM;
using af2::kBlockN;
using af2::kThreads;
using af2::Operand;

struct Grad {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;   // (batch, heads, nq) from the forward; +inf: no valid key
  const float* dsum;  // (batch, heads, nq) rowsum(dO * O)
  const unsigned char* q_mask;   // (batch, nq) 0/1, or null
  const unsigned char* kv_mask;  // (batch, nk) 0/1, or null
  void* dq;
  void* dk;
  void* dv;
  Operand qs, ks, vs, dos, dqs, dks, dvs;
  af2::Problem geom;  // features = fd = head dim, for the shared tile loaders
  int batch, heads, nq, nk;
  float sm_scale;
};

__device__ __forceinline__ bool key_valid(const Grad& g, int b, int j) {
  return j < g.nk && (g.kv_mask == nullptr || g.kv_mask[(long long)b * g.nk + j] != 0);
}

// The lse of query row n, or +inf where the row takes no part in the
// backward (past the tail, masked, or with no valid key).
__device__ __forceinline__ float live_lse(const Grad& g, int b, long long bh, int n) {
  if (n >= g.nq) return CUDART_INF_F;
  if (g.q_mask != nullptr && g.q_mask[(long long)b * g.nq + n] == 0) return CUDART_INF_F;
  return g.lse[bh * g.nq + n];
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores. Thread (ty, tx) = (tid / 8, tid % 8) owns tile
// rows ty*4 .. ty*4+3 and columns tx + 8j, as attention_kernel does; tiles
// are staged in shared memory as f32 with rows of D + 1.

template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(Grad g) {
  constexpr int L = D + 1, OC = D / 8;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kBlockM * L;
  float* ks = dos + kBlockM * L;
  float* vs = ks + kBlockN * L;
  float* dss = vs + kBlockN * L;  // kBlockM x (kBlockN + 1)

  const int q_tiles = (g.nq + kBlockM - 1) / kBlockM;
  const int qt = (int)(blockIdx.x % q_tiles);
  const long long bh = blockIdx.x / q_tiles;
  const int b = (int)(bh / g.heads), h = (int)(bh % g.heads);
  const int q0 = qt * kBlockM;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const float scale = g.sm_scale;
  const float* k = static_cast<const float*>(g.k);
  const float* v = static_cast<const float*>(g.v);

  af2::load_tile<D>(qs, static_cast<const float*>(g.q), g.qs, b, h, q0, g.nq, 0, g.geom);
  af2::load_tile<D>(dos, static_cast<const float*>(g.dout), g.dos, b, h, q0, g.nq, 0, g.geom);
  float lse[4], dsum[4], acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    lse[i] = live_lse(g, b, bh, n);
    dsum[i] = lse[i] < CUDART_INF_F ? g.dsum[bh * g.nq + n] : 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < g.nk; k0 += kBlockN) {
    af2::load_tile<D>(ks, k, g.ks, b, h, k0, g.nk, 0, g.geom);
    af2::load_tile<D>(vs, v, g.vs, b, h, k0, g.nk, 0, g.geom);
    __syncthreads();
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int f = 0; f < D; ++f) {
      float a[4], o[4], kk[8], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty * 4 + i) * L + f];
        o[i] = dos[(ty * 4 + i) * L + f];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kk[j] = ks[(tx + 8 * j) * L + f];
        vv[j] = vs[(tx + 8 * j) * L + f];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(o[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool valid = key_valid(g, b, k0 + tx + 8 * j);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = (valid && lse[i] < CUDART_INF_F) ? expf(s[i][j] * scale - lse[i]) : 0.f;
        dss[(ty * 4 + i) * (kBlockN + 1) + tx + 8 * j] = p * (dp[i][j] - dsum[i]);
      }
    }
    __syncthreads();
    const int kn = min(kBlockN, g.nk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(ty * 4 + i) * (kBlockN + 1) + kk];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float kv = ks[kk * L + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], kv, acc[i][c]);
      }
    }
    __syncthreads();
  }

  float* dq = static_cast<float*>(g.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    if (n >= g.nq) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c)
      dq[af2::offset(g.dqs, b, h, n, tx + 8 * c, D)] = acc[i][c] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Grad g) {
  constexpr int L = D + 1, OC = D / 8;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kBlockN * L;
  float* qs = vs + kBlockN * L;
  float* dos = qs + kBlockM * L;
  float* ps = dos + kBlockM * L;          // kBlockN x (kBlockM + 1): p, key-major
  float* dss = ps + kBlockN * (kBlockM + 1);  // ds, key-major
  float* lse_s = dss + kBlockN * (kBlockM + 1);
  float* dsum_s = lse_s + kBlockM;

  const int k_tiles = (g.nk + kBlockN - 1) / kBlockN;
  const int kt = (int)(blockIdx.x % k_tiles);
  const long long bh = blockIdx.x / k_tiles;
  const int b = (int)(bh / g.heads), h = (int)(bh % g.heads);
  const int k0 = kt * kBlockN;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const float scale = g.sm_scale;
  const float* q = static_cast<const float*>(g.q);
  const float* dout = static_cast<const float*>(g.dout);

  af2::load_tile<D>(ks, static_cast<const float*>(g.k), g.ks, b, h, k0, g.nk, 0, g.geom);
  af2::load_tile<D>(vs, static_cast<const float*>(g.v), g.vs, b, h, k0, g.nk, 0, g.geom);
  bool kvalid[4];
  float dk[4][OC], dv[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    kvalid[i] = key_valid(g, b, k0 + ty * 4 + i);
#pragma unroll
    for (int c = 0; c < OC; ++c) dk[i][c] = dv[i][c] = 0.f;
  }

  for (int q0 = 0; q0 < g.nq; q0 += kBlockM) {
    af2::load_tile<D>(qs, q, g.qs, b, h, q0, g.nq, 0, g.geom);
    af2::load_tile<D>(dos, dout, g.dos, b, h, q0, g.nq, 0, g.geom);
    for (int e = threadIdx.x; e < kBlockM; e += kThreads) {
      const float l = live_lse(g, b, bh, q0 + e);
      lse_s[e] = l;
      dsum_s[e] = l < CUDART_INF_F ? g.dsum[bh * g.nq + q0 + e] : 0.f;
    }
    __syncthreads();
    float s[4][8], dp[4][8];  // rows: keys ty*4+i; columns: queries tx+8j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int f = 0; f < D; ++f) {
      float a[4], av[4], bq[8], bo[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ks[(ty * 4 + i) * L + f];
        av[i] = vs[(ty * 4 + i) * L + f];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bq[j] = qs[(tx + 8 * j) * L + f];
        bo[j] = dos[(tx + 8 * j) * L + f];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(a[i], bq[j], s[i][j]);
          dp[i][j] = fmaf(av[i], bo[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qj = tx + 8 * j;
      const float l = lse_s[qj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = (kvalid[i] && l < CUDART_INF_F) ? expf(s[i][j] * scale - l) : 0.f;
        ps[(ty * 4 + i) * (kBlockM + 1) + qj] = p;
        dss[(ty * 4 + i) * (kBlockM + 1) + qj] = p * (dp[i][j] - dsum_s[qj]);
      }
    }
    __syncthreads();
    const int qn = min(kBlockM, g.nq - q0);
    for (int qq = 0; qq < qn; ++qq) {
      float pp[4], dd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pp[i] = ps[(ty * 4 + i) * (kBlockM + 1) + qq];
        dd[i] = dss[(ty * 4 + i) * (kBlockM + 1) + qq];
      }
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float o = dos[qq * L + tx + 8 * c];
        const float x = qs[qq * L + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][c] = fmaf(pp[i], o, dv[i][c]);
          dk[i][c] = fmaf(dd[i], x, dk[i][c]);
        }
      }
    }
    __syncthreads();
  }

  float* dk_out = static_cast<float*>(g.dk);
  float* dv_out = static_cast<float*>(g.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = k0 + ty * 4 + i;
    if (n >= g.nk) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int f = tx + 8 * c;
      dk_out[af2::offset(g.dks, b, h, n, f, D)] = dk[i][c] * scale;
      dv_out[af2::offset(g.dvs, b, h, n, f, D)] = dv[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: mma.sync.m16n8k16, the fragment layouts of
// attention_kernel_mma. Each warp owns 16 rows of the block's 64-row tile
// (queries in K3a, keys in K3b); lane (g, t) holds, per 8-column n-tile, the
// accumulator entries (row g, cols 2t, 2t+1) and (row g+8, cols 2t, 2t+1),
// which is also the A-operand layout of the next product, so p and ds pass
// to it in registers. Token-major tiles have rows of D + 8; the operands read
// across tokens (k in K3a; q and dO in K3b) are also staged transposed, rows
// of 64 + 8 tokens, so every fragment is one 32-bit load.

using af2::a_frag;
using af2::acc_frag;
using af2::lds32;
using af2::mma_bf16;

template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel_mma(Grad g, int vec) {
  constexpr int LQ = D + 8, LT = kBlockN + 8, ON = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kBlockM * LQ;
  __nv_bfloat16* ks = dos + kBlockM * LQ;
  __nv_bfloat16* vs = ks + kBlockN * LQ;
  __nv_bfloat16* kT = vs + kBlockN * LQ;  // D x LT: k transposed

  const int q_tiles = (g.nq + kBlockM - 1) / kBlockM;
  const int qt = (int)(blockIdx.x % q_tiles);
  const long long bh = blockIdx.x / q_tiles;
  const int b = (int)(bh / g.heads), h = (int)(bh % g.heads);
  const int q0 = qt * kBlockM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + gr;  // this lane's query rows: r0 and r0 + 8
  const float scale = g.sm_scale;
  const bool v16 = vec != 0;
  const auto* k = static_cast<const __nv_bfloat16*>(g.k);
  const auto* v = static_cast<const __nv_bfloat16*>(g.v);

  af2::load_tile_bf16<D>(qs, LQ, false, static_cast<const __nv_bfloat16*>(g.q), g.qs, b, h,
                         q0, g.nq, 0, g.geom, v16);
  af2::load_tile_bf16<D>(dos, LQ, false, static_cast<const __nv_bfloat16*>(g.dout), g.dos, b,
                         h, q0, g.nq, 0, g.geom, v16);
  float lse[2], dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + r0 + 8 * r;
    lse[r] = live_lse(g, b, bh, n);
    dsum[r] = lse[r] < CUDART_INF_F ? g.dsum[bh * g.nq + n] : 0.f;
  }
  float acc[ON][4];
#pragma unroll
  for (int j = 0; j < ON; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int k0 = 0; k0 < g.nk; k0 += kBlockN) {
    af2::load_tile_bf16<D>(ks, LQ, false, k, g.ks, b, h, k0, g.nk, 0, g.geom, v16);
    af2::load_tile_bf16<D>(kT, LT, true, k, g.ks, b, h, k0, g.nk, 0, g.geom, v16);
    af2::load_tile_bf16<D>(vs, LQ, false, v, g.vs, b, h, k0, g.nk, 0, g.geom, v16);
    __syncthreads();
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int kc = kk * 16 + 2 * t;
      uint32_t aq[4], ao[4];
      a_frag(aq, qs, LQ, r0, kc);
      a_frag(ao, dos, LQ, r0, kc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* kr = ks + (8 * j + gr) * LQ + kc;
        const __nv_bfloat16* vr = vs + (8 * j + gr) * LQ + kc;
        mma_bf16(s[j], aq, lds32(kr), lds32(kr + 8));
        mma_bf16(dp[j], ao, lds32(vr), lds32(vr + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool valid = key_valid(g, b, k0 + 8 * j + 2 * t + c);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          const float p =
              (valid && lse[r] < CUDART_INF_F) ? expf(s[j][e] * scale - lse[r]) : 0.f;
          s[j][e] = p * (dp[j][e] - dsum[r]);  // ds
        }
      }
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      acc_frag(a, s, kk);
#pragma unroll
      for (int j = 0; j < ON; ++j) {
        const __nv_bfloat16* kr = kT + (8 * j + gr) * LT + kk * 16 + 2 * t;
        mma_bf16(acc[j], a, lds32(kr), lds32(kr + 8));
      }
    }
    __syncthreads();
  }

  auto* dq = static_cast<__nv_bfloat16*>(g.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + r0 + 8 * r;
    if (n >= g.nq) continue;
#pragma unroll
    for (int j = 0; j < ON; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        dq[af2::offset(g.dqs, b, h, n, 8 * j + 2 * t + c, D)] =
            __float2bfloat16(acc[j][2 * r + c] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dkv_kernel_mma(Grad g, int vec) {
  constexpr int LQ = D + 8, LT = kBlockM + 8, ON = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kBlockN * LQ;
  __nv_bfloat16* qs = vs + kBlockN * LQ;
  __nv_bfloat16* dos = qs + kBlockM * LQ;
  __nv_bfloat16* qT = dos + kBlockM * LQ;  // D x LT: q transposed
  __nv_bfloat16* doT = qT + D * LT;        // D x LT: dO transposed
  float* lse_s = reinterpret_cast<float*>(doT + D * LT);
  float* dsum_s = lse_s + kBlockM;

  const int k_tiles = (g.nk + kBlockN - 1) / kBlockN;
  const int kt = (int)(blockIdx.x % k_tiles);
  const long long bh = blockIdx.x / k_tiles;
  const int b = (int)(bh / g.heads), h = (int)(bh % g.heads);
  const int k0 = kt * kBlockN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + gr;  // this lane's key rows: r0 and r0 + 8
  const float scale = g.sm_scale;
  const bool v16 = vec != 0;
  const auto* q = static_cast<const __nv_bfloat16*>(g.q);
  const auto* dout = static_cast<const __nv_bfloat16*>(g.dout);

  af2::load_tile_bf16<D>(ks, LQ, false, static_cast<const __nv_bfloat16*>(g.k), g.ks, b, h,
                         k0, g.nk, 0, g.geom, v16);
  af2::load_tile_bf16<D>(vs, LQ, false, static_cast<const __nv_bfloat16*>(g.v), g.vs, b, h,
                         k0, g.nk, 0, g.geom, v16);
  const bool kvalid[2] = {key_valid(g, b, k0 + r0), key_valid(g, b, k0 + r0 + 8)};
  float dk[ON][4], dv[ON][4];
#pragma unroll
  for (int j = 0; j < ON; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int q0 = 0; q0 < g.nq; q0 += kBlockM) {
    af2::load_tile_bf16<D>(qs, LQ, false, q, g.qs, b, h, q0, g.nq, 0, g.geom, v16);
    af2::load_tile_bf16<D>(qT, LT, true, q, g.qs, b, h, q0, g.nq, 0, g.geom, v16);
    af2::load_tile_bf16<D>(dos, LQ, false, dout, g.dos, b, h, q0, g.nq, 0, g.geom, v16);
    af2::load_tile_bf16<D>(doT, LT, true, dout, g.dos, b, h, q0, g.nq, 0, g.geom, v16);
    for (int e = threadIdx.x; e < kBlockM; e += kThreads) {
      const float l = live_lse(g, b, bh, q0 + e);
      lse_s[e] = l;
      dsum_s[e] = l < CUDART_INF_F ? g.dsum[bh * g.nq + q0 + e] : 0.f;
    }
    __syncthreads();
    float s[8][4], dp[8][4];  // rows: this warp's keys; n-tiles: 8 queries each
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int kc = kk * 16 + 2 * t;
      uint32_t ak[4], av[4];
      a_frag(ak, ks, LQ, r0, kc);
      a_frag(av, vs, LQ, r0, kc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* qr = qs + (8 * j + gr) * LQ + kc;
        const __nv_bfloat16* orow = dos + (8 * j + gr) * LQ + kc;
        mma_bf16(s[j], ak, lds32(qr), lds32(qr + 8));
        mma_bf16(dp[j], av, lds32(orow), lds32(orow + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qj = 8 * j + 2 * t + c;
        const float l = lse_s[qj];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          const float p = (kvalid[r] && l < CUDART_INF_F) ? expf(s[j][e] * scale - l) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dsum_s[qj]);  // ds
        }
      }
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      uint32_t ap[4], ads[4];
      acc_frag(ap, s, kk);
      acc_frag(ads, dp, kk);
#pragma unroll
      for (int j = 0; j < ON; ++j) {
        const __nv_bfloat16* orow = doT + (8 * j + gr) * LT + kk * 16 + 2 * t;
        const __nv_bfloat16* qr = qT + (8 * j + gr) * LT + kk * 16 + 2 * t;
        mma_bf16(dv[j], ap, lds32(orow), lds32(orow + 8));
        mma_bf16(dk[j], ads, lds32(qr), lds32(qr + 8));
      }
    }
    __syncthreads();
  }

  auto* dk_out = static_cast<__nv_bfloat16*>(g.dk);
  auto* dv_out = static_cast<__nv_bfloat16*>(g.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = k0 + r0 + 8 * r;
    if (n >= g.nk) continue;
#pragma unroll
    for (int j = 0; j < ON; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int f = 8 * j + 2 * t + c;
        dk_out[af2::offset(g.dks, b, h, n, f, D)] = __float2bfloat16(dk[j][2 * r + c] * scale);
        dv_out[af2::offset(g.dvs, b, h, n, f, D)] = __float2bfloat16(dv[j][2 * r + c]);
      }
  }
}

// ---------------------------------------------------------------------------
// Launch: grid of one block per (batch * head, 64-row tile); dynamic shared
// memory set per instantiation.

enum class Which { kDq, kDkv };

template <typename T, int D>
Af2LaunchPlan plan_launch(Which which, const Grad& g) {
  Af2LaunchPlan plan{};
  const int rows = which == Which::kDq ? g.nq : g.nk;
  plan.blocks = (long long)g.batch * g.heads * ((rows + kBlockM - 1) / kBlockM);
  plan.threads = kThreads;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int bf = (int)sizeof(__nv_bfloat16);
    if (which == Which::kDq) {
      plan.dynamic_smem = (4 * kBlockM * (D + 8) + D * (kBlockN + 8)) * bf;
      af2::name_kernel(plan, "dq_kernel_mma<%d>", D);
    } else {
      plan.dynamic_smem =
          (4 * kBlockM * (D + 8) + 2 * D * (kBlockM + 8)) * bf + 2 * kBlockM * (int)sizeof(float);
      af2::name_kernel(plan, "dkv_kernel_mma<%d>", D);
    }
  } else {
    const int fl = (int)sizeof(float);
    if (which == Which::kDq) {
      plan.dynamic_smem = (4 * kBlockM * (D + 1) + kBlockM * (kBlockN + 1)) * fl;
      af2::name_kernel(plan, "dq_kernel<%d>", D);
    } else {
      plan.dynamic_smem = (4 * kBlockM * (D + 1) + 2 * kBlockN * (kBlockM + 1) + 2 * kBlockM) * fl;
      af2::name_kernel(plan, "dkv_kernel<%d>", D);
    }
  }
  return plan;
}

// Launches the plan's kernel; with `plan_out` it only fills the plan.
template <typename T, int D>
cudaError_t launch(Which which, const Grad& g, cudaStream_t stream, Af2LaunchPlan* plan_out) {
  const Af2LaunchPlan pl = plan_launch<T, D>(which, g);
  if (plan_out != nullptr) {
    *plan_out = pl;
    return cudaSuccess;
  }
  if (!af2::grid_fits(pl)) return cudaErrorInvalidConfiguration;
  const unsigned blocks = (unsigned)pl.blocks;
  const int smem = pl.dynamic_smem;
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    bool vec = af2::aligned16(g.q) && af2::aligned16(g.k) && af2::aligned16(g.v) &&
               af2::aligned16(g.dout);
    for (const Operand* op : {&g.qs, &g.ks, &g.vs, &g.dos})
      vec = vec && op->sb % 8 == 0 && op->sh % 8 == 0 && op->sn % 8 == 0;
    if (which == Which::kDq) {
      err = cudaFuncSetAttribute(dq_kernel_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      dq_kernel_mma<D><<<blocks, pl.threads, smem, stream>>>(g, vec ? 1 : 0);
    } else {
      err = cudaFuncSetAttribute(dkv_kernel_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      dkv_kernel_mma<D><<<blocks, pl.threads, smem, stream>>>(g, vec ? 1 : 0);
    }
  } else {
    if (which == Which::kDq) {
      err = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      dq_kernel<D><<<blocks, pl.threads, smem, stream>>>(g);
    } else {
      err = cudaFuncSetAttribute(dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      dkv_kernel<D><<<blocks, pl.threads, smem, stream>>>(g);
    }
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_dtype(int dtype, Which which, const Grad& g, cudaStream_t stream,
                           Af2LaunchPlan* plan_out) {
  if (dtype == 0) return launch<float, D>(which, g, stream, plan_out);
  if (dtype == 1) return launch<__nv_bfloat16, D>(which, g, stream, plan_out);
  return cudaErrorInvalidValue;
}

namespace grad = af2::sm90::grad;

// The head dims the Hopper kernels are built for (bf16, TMA-aligned
// operands); every one of them compiles without a spill for both kernels.
bool sm90_head_dim(int head_dim) {
  return head_dim == 32 || head_dim == 64 || head_dim == 128;
}

template <int D>
cudaError_t dispatch_sm90(Which which, const grad::GradOperands& a, int splits, float* partials,
                          cudaStream_t stream, Af2LaunchPlan* plan_out) {
  const bool dkv = which == Which::kDkv;
  if (plan_out != nullptr) {
    *plan_out = grad::plan_grad<D>(dkv, a.batch, a.heads, a.nq, a.nk, splits);
    return cudaSuccess;
  }
  return grad::launch_grad<D>(dkv, a, splits, partials, stream);
}

// strides: 21 element strides, (batch, head, token) of q, k, v, dout, dq,
// dk and dv in that order (those of an absent output are ignored); the
// head-dim stride of each must be 1. `splits` is ops/cuda/axial.py
// grad_splits() of the shape: the Hopper kernels take it as given, the
// others run whole. `info`, when given, receives the kernel taken (1:
// dq_kernel_sm90 / dkv_kernel_sm90, 0: another) and the splits run; with
// more than one, the partials are in `partials` and the caller launches
// af2_fused_attention_bwd_merge next. With `plan_out` it only fills the plan
// (strides may then be null, no pointer is read, and `aligned` stands for
// the operands' alignment; a launch finds it from the pointers and strides).
int run(Which which, int dtype, const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* dsum, void* dq, void* dk, void* dv,
        const unsigned char* q_mask, const unsigned char* kv_mask, const long long* strides,
        int batch, int heads, int nq, int nk, int head_dim, float sm_scale, int splits,
        float* partials, int* info, void* stream, Af2LaunchPlan* plan_out = nullptr,
        int aligned = 0) {
  Grad g;
  g.q = q;
  g.k = k;
  g.v = v;
  g.dout = dout;
  g.lse = lse;
  g.dsum = dsum;
  g.q_mask = q_mask;
  g.kv_mask = kv_mask;
  g.dq = dq;
  g.dk = dk;
  g.dv = dv;
  Operand* ops[7] = {&g.qs, &g.ks, &g.vs, &g.dos, &g.dqs, &g.dks, &g.dvs};
  for (int t = 0; t < 7; ++t) {
    ops[t]->sb = strides != nullptr ? strides[3 * t] : 0;
    ops[t]->sh = strides != nullptr ? strides[3 * t + 1] : 0;
    ops[t]->sn = strides != nullptr ? strides[3 * t + 2] : 0;
    ops[t]->sr = 0;
  }
  g.geom.features = head_dim;
  g.geom.fd = head_dim;
  g.batch = batch;
  g.heads = heads;
  g.nq = nq;
  g.nk = nk;
  g.sm_scale = sm_scale;
  if (splits < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dkv = which == Which::kDkv;
  grad::GradOperands a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.dsum = dsum;
  a.q_mask = q_mask;
  a.kv_mask = kv_mask;
  a.out0 = dkv ? dk : dq;
  a.out1 = dkv ? dv : nullptr;
  a.qs = g.qs;
  a.ks = g.ks;
  a.vs = g.vs;
  a.dos = g.dos;
  a.o0s = dkv ? g.dks : g.dqs;
  a.o1s = g.dvs;
  a.batch = batch;
  a.heads = heads;
  a.nq = nq;
  a.nk = nk;
  a.sm_scale = sm_scale;
  const bool sm90 = dtype == 1 && sm90_head_dim(head_dim) &&
                    (plan_out != nullptr ? aligned != 0 : grad::takes(a, dkv));
  if (info != nullptr) {
    info[0] = sm90 ? 1 : 0;
    info[1] = sm90 ? splits : 1;
  }
  if (sm90) {
    switch (head_dim) {
      case 32: return dispatch_sm90<32>(which, a, splits, partials, s, plan_out);
      case 64: return dispatch_sm90<64>(which, a, splits, partials, s, plan_out);
      default: return dispatch_sm90<128>(which, a, splits, partials, s, plan_out);
    }
  }
  switch (head_dim) {
    case 16: return dispatch_dtype<16>(dtype, which, g, s, plan_out);
    case 32: return dispatch_dtype<32>(dtype, which, g, s, plan_out);
    case 64: return dispatch_dtype<64>(dtype, which, g, s, plan_out);
    case 128: return dispatch_dtype<128>(dtype, which, g, s, plan_out);
    default: return cudaErrorInvalidValue;
  }
}

// The merge pass, or with `plan_out` only its plan.
int merge(const float* partials, void* out0, void* out1, const long long* out_strides,
          float scale0, float scale1, int outs, int batch, int heads, int n, int head_dim,
          int splits, void* stream, Af2LaunchPlan* plan_out = nullptr) {
  if (outs != 1 && outs != 2) return cudaErrorInvalidValue;
  if (plan_out != nullptr) {
    switch (head_dim) {
      case 32: *plan_out = grad::plan_merge<32>(outs, batch, heads, n); return cudaSuccess;
      case 64: *plan_out = grad::plan_merge<64>(outs, batch, heads, n); return cudaSuccess;
      case 128: *plan_out = grad::plan_merge<128>(outs, batch, heads, n); return cudaSuccess;
      default: return cudaErrorInvalidValue;
    }
  }
  grad::MergeParams m;
  m.part = partials;
  m.out0 = out0;
  m.out1 = outs == 2 ? out1 : nullptr;
  for (int i = 0; i < 3; ++i) {
    m.os0[i] = out_strides[i];
    m.os1[i] = outs == 2 ? out_strides[3 + i] : 0;
  }
  m.scale0 = scale0;
  m.scale1 = scale1;
  m.outs = outs;
  m.batch = batch;
  m.heads = heads;
  m.n = n;
  m.splits = splits;
  const Operand o0{m.os0[0], m.os0[1], m.os0[2], 0}, o1{m.os1[0], m.os1[1], m.os1[2], 0};
  if (splits < 1 || partials == nullptr ||
      !af2::sm90::tma_operand(out0, o0, batch, heads, n) ||
      (outs == 2 && !af2::sm90::tma_operand(out1, o1, batch, heads, n)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return grad::launch_merge<32>(m, s);
    case 64: return grad::launch_merge<64>(m, s);
    case 128: return grad::launch_merge<128>(m, s);
    default: return cudaErrorInvalidValue;
  }
}

namespace onepass = af2::sm90::onepass;

// The one-pass backward (fused_attention_bwd_onepass_sm90.cuh), or with
// `plan_out` only its plan (`aligned` then stands for the operands'
// alignment). strides: 21 element strides, (batch, head, token) of q, k,
// v, dout, dq, dk, dv. bf16 operands TMA can describe and a shape
// onepass::cluster_of takes (head dim 32 or 64); anything else is
// cudaErrorInvalidValue.
int run_onepass(int dtype, const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* dsum, void* dq, void* dk, void* dv,
                const unsigned char* q_mask, const unsigned char* kv_mask,
                const long long* strides, int batch, int heads, int nq, int nk, int head_dim,
                float sm_scale, int drop_rank, void* stream, Af2LaunchPlan* plan_out = nullptr,
                int aligned = 0) {
  if (dtype != 1 || onepass::cluster_of(nq, nk, head_dim) == 0) return cudaErrorInvalidValue;
  if (plan_out != nullptr) {
    if (aligned == 0) return cudaErrorInvalidValue;
    *plan_out = head_dim == 32 ? onepass::plan_onepass<32>(batch, heads, nq, nk)
                               : onepass::plan_onepass<64>(batch, heads, nq, nk);
    return cudaSuccess;
  }
  Operand ops[7];
  for (int t = 0; t < 7; ++t) ops[t] = Operand{strides[3 * t], strides[3 * t + 1],
                                               strides[3 * t + 2], 0};
  grad::GradOperands a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.dsum = dsum;
  a.q_mask = q_mask;
  a.kv_mask = kv_mask;
  a.out0 = dq;
  a.out1 = nullptr;
  a.qs = ops[0];
  a.ks = ops[1];
  a.vs = ops[2];
  a.dos = ops[3];
  a.o0s = ops[4];
  a.batch = batch;
  a.heads = heads;
  a.nq = nq;
  a.nk = nk;
  a.sm_scale = sm_scale;
  if (!grad::takes(a, false) || !af2::sm90::tma_operand(dk, ops[5], batch, heads, nk) ||
      !af2::sm90::tma_operand(dv, ops[6], batch, heads, nk))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head_dim == 32
             ? onepass::launch_onepass<32>(a, dq, dk, dv, ops[4], ops[5], ops[6], drop_rank, s)
             : onepass::launch_onepass<64>(a, dq, dk, dv, ops[4], ops[5], ops[6], drop_rank, s);
}

// rowsum(dO * O), or with `plan_out` only its plan. strides: 6 element
// strides, (batch, head, token) of out, then dout; the head dim of each
// contiguous.
int run_dsum(int dtype, const void* out, const void* dout, const float* lse, const float* dlse,
             float* dsum, const long long* strides, int batch, int heads, int nq, int head_dim,
             void* stream, Af2LaunchPlan* plan_out = nullptr) {
  if ((dtype != 0 && dtype != 1) || head_dim < 1) return cudaErrorInvalidValue;
  const Af2LaunchPlan plan = onepass::plan_dsum(batch, heads, nq, dtype);
  if (plan_out != nullptr) {
    *plan_out = plan;
    return cudaSuccess;
  }
  if (!af2::grid_fits(plan)) return cudaErrorInvalidConfiguration;
  onepass::DsumParams p;
  p.out = out;
  p.dout = dout;
  p.lse = lse;
  p.dlse = dlse;
  p.dsum = dsum;
  for (int i = 0; i < 3; ++i) {
    p.os[i] = strides[i];
    p.gs[i] = strides[3 + i];
  }
  p.batch = batch;
  p.heads = heads;
  p.nq = nq;
  p.head_dim = head_dim;
  bool vec = dtype == 1 && head_dim % 8 == 0 && af2::aligned16(out) && af2::aligned16(dout);
  for (int i = 0; i < 6; ++i) vec = vec && strides[i] % 8 == 0;
  p.vec = vec ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)plan.blocks;
  if (dtype == 1)
    onepass::attention_dsum_kernel<__nv_bfloat16><<<blocks, plan.threads, 0, s>>>(p);
  else
    onepass::attention_dsum_kernel<float><<<blocks, plan.threads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// K3's one-pass backward: dq, dk and dv (bf16, through the strides) of one
// problem in one launch of attention_bwd_kernel_sm90, from the forward's lse
// and dsum. Arguments as K3a's, the three outputs in order; drop_rank: the
// negative control's rank left out of every dq sum (-1: none). Returns the
// cudaError_t of the launch.
extern "C" int af2_fused_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* dsum,
                                       void* dq, void* dk, void* dv,
                                       const unsigned char* q_mask,
                                       const unsigned char* kv_mask, const long long* strides,
                                       int batch, int heads, int nq, int nk, int head_dim,
                                       float sm_scale, int drop_rank, void* stream) {
  return run_onepass(dtype, q, k, v, dout, lse, dsum, dq, dk, dv, q_mask, kv_mask, strides,
                     batch, heads, nq, nk, head_dim, sm_scale, drop_rank, stream);
}

// The one-pass backward's launch plan (its cluster in plan->cluster); 0, or
// cudaErrorInvalidValue for a shape or dtype the kernel does not take.
extern "C" int af2_fused_attention_bwd_onepass_plan(int dtype, int batch, int heads, int nq,
                                                    int nk, int head_dim, int aligned,
                                                    Af2LaunchPlan* plan) {
  return run_onepass(dtype, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, nullptr, nullptr, nullptr, nullptr, batch, heads, nq, nk, head_dim,
                     1.f, -1, nullptr, plan, aligned);
}

// rowsum(dO * O) in f32 as (batch, heads, nq), less dlse where lse is
// finite and 0 where it is +inf (lse, dlse: contiguous (batch, heads, nq)
// f32, each or null). dtype: 0 = float32, 1 = bfloat16.
extern "C" int af2_attention_dsum(int dtype, const void* out, const void* dout,
                                  const float* lse, const float* dlse, float* dsum,
                                  const long long* strides, int batch, int heads, int nq,
                                  int head_dim, void* stream) {
  return run_dsum(dtype, out, dout, lse, dlse, dsum, strides, batch, heads, nq, head_dim,
                  stream);
}

extern "C" int af2_attention_dsum_plan(int dtype, int batch, int heads, int nq, int head_dim,
                                       Af2LaunchPlan* plan) {
  return run_dsum(dtype, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, batch, heads,
                  nq, head_dim, nullptr, plan);
}

// K3a. q (batch, heads, nq, head_dim), k/v (batch, heads, nk, head_dim), dout
// and dq like q, all read or written through `strides`; lse and dsum
// contiguous (batch, heads, nq) f32. dtype: 0 = float32, 1 = bfloat16.
// splits, partials, info: as `run` (partials: splits * batch*heads*nq *
// head_dim floats). Returns the cudaError_t of the launch (0 on success).
extern "C" int af2_fused_attention_bwd_dq(int dtype, const void* q, const void* k,
                                          const void* v, const void* dout, const float* lse,
                                          const float* dsum, void* dq,
                                          const unsigned char* q_mask,
                                          const unsigned char* kv_mask,
                                          const long long* strides, int batch, int heads,
                                          int nq, int nk, int head_dim, float sm_scale,
                                          int splits, float* partials, int* info,
                                          void* stream) {
  return run(Which::kDq, dtype, q, k, v, dout, lse, dsum, dq, nullptr, nullptr, q_mask, kv_mask,
             strides, batch, heads, nq, nk, head_dim, sm_scale, splits, partials, info, stream);
}

// K3b. As K3a, writing dk and dv (like k) instead of dq (partials: 2 *
// splits * batch*heads*nk * head_dim floats, dk's then dv's).
extern "C" int af2_fused_attention_bwd_dkv(int dtype, const void* q, const void* k,
                                           const void* v, const void* dout, const float* lse,
                                           const float* dsum, void* dk, void* dv,
                                           const unsigned char* q_mask,
                                           const unsigned char* kv_mask,
                                           const long long* strides, int batch, int heads,
                                           int nq, int nk, int head_dim, float sm_scale,
                                           int splits, float* partials, int* info,
                                           void* stream) {
  return run(Which::kDkv, dtype, q, k, v, dout, lse, dsum, nullptr, dk, dv, q_mask, kv_mask,
             strides, batch, heads, nq, nk, head_dim, sm_scale, splits, partials, info, stream);
}

// K3's merge pass: `outs` (1: dq; 2: dk then dv) outputs, each the sum of
// its `splits` f32 partials ((outs, splits, batch*heads*n, head_dim), as the
// Hopper kernels write them) in split order, times its scale (scale0,
// scale1), as bf16 through its 3 element strides (batch, head, token; out0's
// then out1's). Head dim 32, 64 or 128.
extern "C" int af2_fused_attention_bwd_merge(const float* partials, void* out0, void* out1,
                                             const long long* out_strides, float scale0,
                                             float scale1, int outs, int batch, int heads,
                                             int n, int head_dim, int splits, void* stream) {
  return merge(partials, out0, out1, out_strides, scale0, scale1, outs, batch, heads, n,
               head_dim, splits, stream);
}

// The launch plan of K3a (which = 0) or K3b (which = 1) at one shape, given
// the splits and whether the operands are TMA-aligned; touches no device.
// Returns 0, or cudaErrorInvalidValue for a dtype, head dim, split count or
// `which` the kernels do not take.
extern "C" int af2_fused_attention_bwd_plan(int which, int dtype, int batch, int heads, int nq,
                                            int nk, int head_dim, int splits, int aligned,
                                            Af2LaunchPlan* plan) {
  if (which != 0 && which != 1) return cudaErrorInvalidValue;
  return run(which == 0 ? Which::kDq : Which::kDkv, dtype, nullptr, nullptr, nullptr, nullptr,
             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, batch,
             heads, nq, nk, head_dim, 1.f, splits, nullptr, nullptr, nullptr, plan, aligned);
}

// The merge pass's launch plan for `outs` outputs of (batch, heads, n).
extern "C" int af2_fused_attention_bwd_merge_plan(int outs, int batch, int heads, int n,
                                                  int head_dim, Af2LaunchPlan* plan) {
  return merge(nullptr, nullptr, nullptr, nullptr, 1.f, 1.f, outs, batch, heads, n, head_dim, 2,
               nullptr, plan);
}
