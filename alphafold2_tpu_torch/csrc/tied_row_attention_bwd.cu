// K2's backward, and K3a/K3b at head dims past 128: the backward of
// attention over a row-grouped feature axis, for Hopper (sm_90a).
//
// Replaces, on the tied-row route, the TPU kernels alphafold2_tpu/ops/pallas/
// axial.py `_run_dq` (:268, pallas_call :275) and `_run_dkv` (:306,
// pallas_call :313) as ops/pallas/tied_row.py `tied_row_attention` (:53)
// reaches them under jax.grad: through fused_attention's custom VJP at head
// dim F = R*D on the folded (B, H, N, R*D) operands. Here the operands stay
// in place: element (b, h, n, f) of an operand lives at
//     b*sb + h*sh + n*sn + (f / fd)*sr + f % fd
// (attention_tile.cuh), so one kernel reads the (B, R, N, H, D) layout of
// tied rows (f = r*D + d, fd = D) and K1's (B, H, N, D) layout at a head
// dim past 128 (fd = 64, sr = 64: R = D/64 rows of 64 features; fd = F,
// sr = 0 where D is not a multiple of 64), with no fold copy. With s =
// sm_scale * tie[b] (tie null: 1), the forward's row logsumexp lse (K2 or
// K1 with lse) and dsum[b, h, i] = sum over the WHOLE fused axis of out * dO:
//
//     P  = exp(s * Q'K'^T - lse)     (0 for a masked key, a masked query,
//                                     a row with lse = +inf, a padded tile)
//     dS = P o (dO'V'^T - dsum)
//     dq = s * dS K'                 one block per 64 queries
//     dk = s * dS^T Q'               one block per 64 keys
//     dv = P^T dO'
//
// The tie scale is applied to the f32 logits, as K2's forward applies it
// (not to a rounded copy of q, as the TPU path does), so dq and dk both
// carry the factor s.
//
// What bounds it on the H100: at the tied training shape (1 x 8 heads,
// N 64, R*D 320) the work is small (about 8 * R*D operations per (query,
// key) pair against 2 * R*D bytes a row of each operand), so one block's
// latency is the floor: loading its resident tile pair, then each streamed
// pair, and the two chains of R*D / 16 products for S and dO'V'^T; at the
// PLM grid's R*D 8192 the bytes of the four operands do. The plan picks
// one of four routes by dtype, shape and alignment alone (never by
// retrying a failed launch):
//
// * bf16 at row width 32, 64 or 128 whose operands TMA can describe and
//   whose resident tile pair plus one streamed pair fit shared memory
//   (R*D <= 448 at row width 64): tied_dq_kernel_sm90<D, C> and
//   tied_dkv_kernel_sm90<D, 64> (tied_row_attention_bwd_sm90.cuh). Whole
//   (B, R, N, H, D) tiles land by 5-D TMA boxes of all R rows; S and
//   dO'V'^T are computed once per 64-row tile pair over the whole R*D axis
//   by wgmma, for each group of C output columns; the streamed tiles
//   overlap the products through a ring of mbarriers. The tied training
//   pass and K1's backward at head dim 192 or 256 take them.
// * any wider bf16 problem at those row widths whose operands TMA can
//   describe: the wide route (tied_row_wide_sm90.cuh): S and dO'V'^T once
//   over R*D in feature splits (tied_wide_logits_kernel<D, 4>), the splits
//   summed in a fixed order into bf16 dS, dS^T and P^T
//   (tied_wide_grad_kernel, in the caller's workspace), then dq, dk and dv
//   by column group (tied_wide_product_kernel<D, C>). JAX's gate shape
//   (R*D 512), config_4's R*D 1024 and the PLM grid's R*D 8192 and 12288
//   take it; af2_tied_row_attention_bwd_grads runs the first two passes
//   once for dq, dk and dv together.
// * any other bf16 problem: chunked_dq_kernel_mma / chunked_dkv_kernel_mma,
//   one block per 64-row tile and 64-wide output chunk, each recomputing S
//   and dO'V'^T over 64-wide feature chunks staged one at a time by
//   ordinary loads (F/64 times the work), on mma.sync.
// * f32: chunked_dq_kernel / chunked_dkv_kernel on the CUDA cores, chunked
//   likewise, the exactness path of the small-model checks.
//
// No atomics: every output element is summed by one thread in a fixed
// order, so the backward is bitwise deterministic. bf16 products run on the
// tensor cores with f32 accumulation, P and dS rounded to bf16 before their
// products, as K3 rounds them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (alphafold2_tpu_torch/ops/cuda/build.py). Bound with ctypes.

#include "attention_tile.cuh"
#include "tied_row_attention_bwd_sm90.cuh"
#include "tied_row_wide_sm90.cuh"

namespace {

using af2::a_frag;
using af2::acc_frag;
using af2::kBlockM;
using af2::kBlockN;
using af2::kThreads;
using af2::lds32;
using af2::mma_bf16;
using af2::Operand;

constexpr int kChunk = 64;  // feature chunk of the staged tiles and the outputs

struct Grad {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;   // (batch, heads, nq) from the forward; +inf: no valid key
  const float* dsum;  // (batch, heads, nq) out . dO over the fused axis
  const unsigned char* q_mask;   // (batch, nq) 0/1, or null
  const unsigned char* kv_mask;  // (batch, nk) 0/1, or null
  const float* tie_scale;        // (batch,) extra logit scale, or null
  void* dq;
  void* dk;
  void* dv;
  Operand qs, ks, vs, dos, dqs, dks, dvs;
  af2::Problem geom;  // features F and row width fd, for the shared tile loaders
  int batch, heads, nq, nk;
  int chunks;  // ceil(F / kChunk): one block per output chunk
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

// The block's (output chunk, 64-row tile, batch * head) from blockIdx.x.
struct Tile {
  int chunk, t0, b, h;
  long long bh;
};

__device__ __forceinline__ Tile block_tile(const Grad& g, int rows) {
  const int tiles = (rows + kBlockM - 1) / kBlockM;
  long long blk = blockIdx.x;
  Tile t;
  t.chunk = (int)(blk % g.chunks);
  blk /= g.chunks;
  t.t0 = (int)(blk % tiles) * kBlockM;
  t.bh = blk / tiles;
  t.b = (int)(t.bh / g.heads);
  t.h = (int)(t.bh % g.heads);
  return t;
}

__device__ __forceinline__ float tie_of(const Grad& g, int b) {
  return g.sm_scale * (g.tie_scale != nullptr ? g.tie_scale[b] : 1.f);
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores. Thread (ty, tx) = (tid / 8, tid % 8) owns tile
// rows ty*4 .. ty*4+3 and columns tx + 8j, as attention_kernel does; tiles
// are staged in shared memory as f32 with rows of FC + 1.

template <int FC>
__global__ void __launch_bounds__(kThreads) chunked_dq_kernel(Grad g) {
  constexpr int L = FC + 1, OC = FC / 8;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kBlockM * L;
  float* ks = dos + kBlockM * L;
  float* vs = ks + kBlockN * L;
  float* ko = vs + kBlockN * L;   // k at the block's output chunk
  float* dss = ko + kBlockN * L;  // kBlockM x (kBlockN + 1)

  const Tile t = block_tile(g, g.nq);
  const int b = t.b, h = t.h, q0 = t.t0, f_out = t.chunk * FC;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const float scale = tie_of(g, b);
  const auto* q = static_cast<const float*>(g.q);
  const auto* k = static_cast<const float*>(g.k);
  const auto* v = static_cast<const float*>(g.v);
  const auto* dout = static_cast<const float*>(g.dout);

  float lse[4], dsum[4], acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    lse[i] = live_lse(g, b, t.bh, n);
    dsum[i] = lse[i] < CUDART_INF_F ? g.dsum[t.bh * g.nq + n] : 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }
  if (g.chunks == 1) {
    af2::load_tile<FC>(qs, q, g.qs, b, h, q0, g.nq, 0, g.geom);
    af2::load_tile<FC>(dos, dout, g.dos, b, h, q0, g.nq, 0, g.geom);
  }

  for (int k0 = 0; k0 < g.nk; k0 += kBlockN) {
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < g.chunks; ++c) {
      if (g.chunks > 1) {
        af2::load_tile<FC>(qs, q, g.qs, b, h, q0, g.nq, c * FC, g.geom);
        af2::load_tile<FC>(dos, dout, g.dos, b, h, q0, g.nq, c * FC, g.geom);
      }
      af2::load_tile<FC>(ks, k, g.ks, b, h, k0, g.nk, c * FC, g.geom);
      af2::load_tile<FC>(vs, v, g.vs, b, h, k0, g.nk, c * FC, g.geom);
      __syncthreads();
#pragma unroll 4
      for (int f = 0; f < FC; ++f) {
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
      __syncthreads();
    }
    af2::load_tile<FC>(ko, k, g.ks, b, h, k0, g.nk, f_out, g.geom);
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
        const float kv = ko[kk * L + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], kv, acc[i][c]);
      }
    }
    __syncthreads();
  }

  auto* dq = static_cast<float*>(g.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    if (n >= g.nq) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int f = f_out + tx + 8 * c;
      if (f < g.geom.features) dq[af2::offset(g.dqs, b, h, n, f, g.geom.fd)] = acc[i][c] * scale;
    }
  }
}

template <int FC>
__global__ void __launch_bounds__(kThreads) chunked_dkv_kernel(Grad g) {
  constexpr int L = FC + 1, OC = FC / 8;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kBlockN * L;
  float* qs = vs + kBlockN * L;
  float* dos = qs + kBlockM * L;
  float* qo = dos + kBlockM * L;   // q at the block's output chunk
  float* doo = qo + kBlockM * L;   // dO at the block's output chunk
  float* ps = doo + kBlockM * L;   // kBlockN x (kBlockM + 1): p, key-major
  float* dss = ps + kBlockN * (kBlockM + 1);  // ds, key-major
  float* lse_s = dss + kBlockN * (kBlockM + 1);
  float* dsum_s = lse_s + kBlockM;

  const Tile t = block_tile(g, g.nk);
  const int b = t.b, h = t.h, k0 = t.t0, f_out = t.chunk * FC;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const float scale = tie_of(g, b);
  const auto* q = static_cast<const float*>(g.q);
  const auto* k = static_cast<const float*>(g.k);
  const auto* v = static_cast<const float*>(g.v);
  const auto* dout = static_cast<const float*>(g.dout);

  bool kvalid[4];
  float dk[4][OC], dv[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    kvalid[i] = key_valid(g, b, k0 + ty * 4 + i);
#pragma unroll
    for (int c = 0; c < OC; ++c) dk[i][c] = dv[i][c] = 0.f;
  }
  if (g.chunks == 1) {
    af2::load_tile<FC>(ks, k, g.ks, b, h, k0, g.nk, 0, g.geom);
    af2::load_tile<FC>(vs, v, g.vs, b, h, k0, g.nk, 0, g.geom);
  }

  for (int q0 = 0; q0 < g.nq; q0 += kBlockM) {
    for (int e = threadIdx.x; e < kBlockM; e += kThreads) {
      const float l = live_lse(g, b, t.bh, q0 + e);
      lse_s[e] = l;
      dsum_s[e] = l < CUDART_INF_F ? g.dsum[t.bh * g.nq + q0 + e] : 0.f;
    }
    float s[4][8], dp[4][8];  // rows: keys ty*4+i; columns: queries tx+8j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < g.chunks; ++c) {
      if (g.chunks > 1) {
        af2::load_tile<FC>(ks, k, g.ks, b, h, k0, g.nk, c * FC, g.geom);
        af2::load_tile<FC>(vs, v, g.vs, b, h, k0, g.nk, c * FC, g.geom);
      }
      af2::load_tile<FC>(qs, q, g.qs, b, h, q0, g.nq, c * FC, g.geom);
      af2::load_tile<FC>(dos, dout, g.dos, b, h, q0, g.nq, c * FC, g.geom);
      __syncthreads();
#pragma unroll 4
      for (int f = 0; f < FC; ++f) {
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
      __syncthreads();
    }
    af2::load_tile<FC>(qo, q, g.qs, b, h, q0, g.nq, f_out, g.geom);
    af2::load_tile<FC>(doo, dout, g.dos, b, h, q0, g.nq, f_out, g.geom);
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
        const float o = doo[qq * L + tx + 8 * c];
        const float x = qo[qq * L + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][c] = fmaf(pp[i], o, dv[i][c]);
          dk[i][c] = fmaf(dd[i], x, dk[i][c]);
        }
      }
    }
    __syncthreads();
  }

  auto* dk_out = static_cast<float*>(g.dk);
  auto* dv_out = static_cast<float*>(g.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = k0 + ty * 4 + i;
    if (n >= g.nk) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int f = f_out + tx + 8 * c;
      if (f >= g.geom.features) continue;
      dk_out[af2::offset(g.dks, b, h, n, f, g.geom.fd)] = dk[i][c] * scale;
      dv_out[af2::offset(g.dvs, b, h, n, f, g.geom.fd)] = dv[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: mma.sync.m16n8k16 with the fragment layouts
// of fused_attention_bwd.cu. Each warp owns 16 rows of the block's 64-row
// tile; the logits and dO'V'^T accumulate in registers over the feature
// chunks, and P and dS pass to the next product in registers. Chunks are
// staged token-major (rows of FC + 8); the operands read across tokens at
// the output chunk (k in dq; q and dO in dk/dv) are staged transposed
// (rows of 64 + 8 tokens), so every fragment is one 32-bit load.

template <int FC>
__global__ void __launch_bounds__(kThreads) chunked_dq_kernel_mma(Grad g, int vec) {
  constexpr int LQ = FC + 8, LT = kBlockN + 8, ON = FC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kBlockM * LQ;
  __nv_bfloat16* ks = dos + kBlockM * LQ;
  __nv_bfloat16* vs = ks + kBlockN * LQ;
  __nv_bfloat16* kT = vs + kBlockN * LQ;  // FC x LT: k at the output chunk, transposed

  const Tile t = block_tile(g, g.nq);
  const int b = t.b, h = t.h, q0 = t.t0, f_out = t.chunk * FC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16 + gr;  // this lane's query rows: r0 and r0 + 8
  const float scale = tie_of(g, b);
  const bool v16 = vec != 0;
  const auto* q = static_cast<const __nv_bfloat16*>(g.q);
  const auto* k = static_cast<const __nv_bfloat16*>(g.k);
  const auto* v = static_cast<const __nv_bfloat16*>(g.v);
  const auto* dout = static_cast<const __nv_bfloat16*>(g.dout);

  float lse[2], dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + r0 + 8 * r;
    lse[r] = live_lse(g, b, t.bh, n);
    dsum[r] = lse[r] < CUDART_INF_F ? g.dsum[t.bh * g.nq + n] : 0.f;
  }
  float acc[ON][4];
#pragma unroll
  for (int j = 0; j < ON; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  if (g.chunks == 1) {
    af2::load_tile_bf16<FC>(qs, LQ, false, q, g.qs, b, h, q0, g.nq, 0, g.geom, v16);
    af2::load_tile_bf16<FC>(dos, LQ, false, dout, g.dos, b, h, q0, g.nq, 0, g.geom, v16);
  }

  for (int k0 = 0; k0 < g.nk; k0 += kBlockN) {
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    for (int c = 0; c < g.chunks; ++c) {
      if (g.chunks > 1) {
        af2::load_tile_bf16<FC>(qs, LQ, false, q, g.qs, b, h, q0, g.nq, c * FC, g.geom, v16);
        af2::load_tile_bf16<FC>(dos, LQ, false, dout, g.dos, b, h, q0, g.nq, c * FC, g.geom,
                                v16);
      }
      af2::load_tile_bf16<FC>(ks, LQ, false, k, g.ks, b, h, k0, g.nk, c * FC, g.geom, v16);
      af2::load_tile_bf16<FC>(vs, LQ, false, v, g.vs, b, h, k0, g.nk, c * FC, g.geom, v16);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FC / 16; ++kk) {
        const int kc = kk * 16 + 2 * tq;
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
      __syncthreads();
    }
    af2::load_tile_bf16<FC>(kT, LT, true, k, g.ks, b, h, k0, g.nk, f_out, g.geom, v16);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool valid = key_valid(g, b, k0 + 8 * j + 2 * tq + c);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          const float p =
              (valid && lse[r] < CUDART_INF_F) ? expf(s[j][e] * scale - lse[r]) : 0.f;
          s[j][e] = p * (dp[j][e] - dsum[r]);  // ds
        }
      }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      acc_frag(a, s, kk);
#pragma unroll
      for (int j = 0; j < ON; ++j) {
        const __nv_bfloat16* kr = kT + (8 * j + gr) * LT + kk * 16 + 2 * tq;
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
      for (int c = 0; c < 2; ++c) {
        const int f = f_out + 8 * j + 2 * tq + c;
        if (f < g.geom.features)
          dq[af2::offset(g.dqs, b, h, n, f, g.geom.fd)] =
              __float2bfloat16(acc[j][2 * r + c] * scale);
      }
  }
}

template <int FC>
__global__ void __launch_bounds__(kThreads) chunked_dkv_kernel_mma(Grad g, int vec) {
  constexpr int LQ = FC + 8, LT = kBlockM + 8, ON = FC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kBlockN * LQ;
  __nv_bfloat16* qs = vs + kBlockN * LQ;
  __nv_bfloat16* dos = qs + kBlockM * LQ;
  __nv_bfloat16* qT = dos + kBlockM * LQ;  // FC x LT: q at the output chunk, transposed
  __nv_bfloat16* doT = qT + FC * LT;       // FC x LT: dO at the output chunk, transposed
  float* lse_s = reinterpret_cast<float*>(doT + FC * LT);
  float* dsum_s = lse_s + kBlockM;

  const Tile t = block_tile(g, g.nk);
  const int b = t.b, h = t.h, k0 = t.t0, f_out = t.chunk * FC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16 + gr;  // this lane's key rows: r0 and r0 + 8
  const float scale = tie_of(g, b);
  const bool v16 = vec != 0;
  const auto* q = static_cast<const __nv_bfloat16*>(g.q);
  const auto* k = static_cast<const __nv_bfloat16*>(g.k);
  const auto* v = static_cast<const __nv_bfloat16*>(g.v);
  const auto* dout = static_cast<const __nv_bfloat16*>(g.dout);

  const bool kvalid[2] = {key_valid(g, b, k0 + r0), key_valid(g, b, k0 + r0 + 8)};
  float dk[ON][4], dv[ON][4];
#pragma unroll
  for (int j = 0; j < ON; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  if (g.chunks == 1) {
    af2::load_tile_bf16<FC>(ks, LQ, false, k, g.ks, b, h, k0, g.nk, 0, g.geom, v16);
    af2::load_tile_bf16<FC>(vs, LQ, false, v, g.vs, b, h, k0, g.nk, 0, g.geom, v16);
  }

  for (int q0 = 0; q0 < g.nq; q0 += kBlockM) {
    for (int e = threadIdx.x; e < kBlockM; e += kThreads) {
      const float l = live_lse(g, b, t.bh, q0 + e);
      lse_s[e] = l;
      dsum_s[e] = l < CUDART_INF_F ? g.dsum[t.bh * g.nq + q0 + e] : 0.f;
    }
    float s[8][4], dp[8][4];  // rows: this warp's keys; n-tiles: 8 queries each
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    for (int c = 0; c < g.chunks; ++c) {
      if (g.chunks > 1) {
        af2::load_tile_bf16<FC>(ks, LQ, false, k, g.ks, b, h, k0, g.nk, c * FC, g.geom, v16);
        af2::load_tile_bf16<FC>(vs, LQ, false, v, g.vs, b, h, k0, g.nk, c * FC, g.geom, v16);
      }
      af2::load_tile_bf16<FC>(qs, LQ, false, q, g.qs, b, h, q0, g.nq, c * FC, g.geom, v16);
      af2::load_tile_bf16<FC>(dos, LQ, false, dout, g.dos, b, h, q0, g.nq, c * FC, g.geom, v16);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FC / 16; ++kk) {
        const int kc = kk * 16 + 2 * tq;
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
      __syncthreads();
    }
    af2::load_tile_bf16<FC>(qT, LT, true, q, g.qs, b, h, q0, g.nq, f_out, g.geom, v16);
    af2::load_tile_bf16<FC>(doT, LT, true, dout, g.dos, b, h, q0, g.nq, f_out, g.geom, v16);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qj = 8 * j + 2 * tq + c;
        const float l = lse_s[qj];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          const float p = (kvalid[r] && l < CUDART_INF_F) ? expf(s[j][e] * scale - l) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dsum_s[qj]);  // ds
        }
      }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      uint32_t ap[4], ads[4];
      acc_frag(ap, s, kk);
      acc_frag(ads, dp, kk);
#pragma unroll
      for (int j = 0; j < ON; ++j) {
        const __nv_bfloat16* orow = doT + (8 * j + gr) * LT + kk * 16 + 2 * tq;
        const __nv_bfloat16* qr = qT + (8 * j + gr) * LT + kk * 16 + 2 * tq;
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
        const int f = f_out + 8 * j + 2 * tq + c;
        if (f >= g.geom.features) continue;
        dk_out[af2::offset(g.dks, b, h, n, f, g.geom.fd)] =
            __float2bfloat16(dk[j][2 * r + c] * scale);
        dv_out[af2::offset(g.dvs, b, h, n, f, g.geom.fd)] = __float2bfloat16(dv[j][2 * r + c]);
      }
  }
}

// ---------------------------------------------------------------------------
// The chunked kernels' launch: one block per (batch * head, 64-row tile,
// 64-wide output chunk); dynamic shared memory set per instantiation.

enum class Which { kDq, kDkv };

template <typename T>
Af2LaunchPlan plan_launch(Which which, const Grad& g) {
  constexpr int FC = kChunk;
  Af2LaunchPlan plan{};
  const int rows = which == Which::kDq ? g.nq : g.nk;
  plan.blocks = (long long)g.batch * g.heads * ((rows + kBlockM - 1) / kBlockM) * g.chunks;
  plan.threads = kThreads;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int bf = (int)sizeof(__nv_bfloat16);
    if (which == Which::kDq) {
      plan.dynamic_smem = (4 * kBlockM * (FC + 8) + FC * (kBlockN + 8)) * bf;
      af2::name_kernel(plan, "chunked_dq_kernel_mma<%d>", FC);
    } else {
      plan.dynamic_smem =
          (4 * kBlockM * (FC + 8) + 2 * FC * (kBlockM + 8)) * bf + 2 * kBlockM * (int)sizeof(float);
      af2::name_kernel(plan, "chunked_dkv_kernel_mma<%d>", FC);
    }
  } else {
    const int fl = (int)sizeof(float);
    if (which == Which::kDq) {
      plan.dynamic_smem = (5 * kBlockM * (FC + 1) + kBlockM * (kBlockN + 1)) * fl;
      af2::name_kernel(plan, "chunked_dq_kernel<%d>", FC);
    } else {
      plan.dynamic_smem = (6 * kBlockM * (FC + 1) + 2 * kBlockN * (kBlockM + 1) + 2 * kBlockM) * fl;
      af2::name_kernel(plan, "chunked_dkv_kernel<%d>", FC);
    }
  }
  return plan;
}

template <typename K, typename... Args>
cudaError_t launch_kernel(K kernel, const Af2LaunchPlan& pl, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.dynamic_smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)pl.blocks, pl.threads, pl.dynamic_smem, stream>>>(args...);
  return cudaGetLastError();
}

// Launches the plan's chunked kernel; with `plan_out` it only fills the plan.
template <typename T>
cudaError_t launch(Which which, const Grad& g, cudaStream_t stream, Af2LaunchPlan* plan_out) {
  const Af2LaunchPlan pl = plan_launch<T>(which, g);
  if (plan_out != nullptr) {
    *plan_out = pl;
    return cudaSuccess;
  }
  if (!af2::grid_fits(pl)) return cudaErrorInvalidConfiguration;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // every 8 consecutive features in one 16-byte word: 16-byte loads
    bool vec = g.geom.fd % 8 == 0 && af2::aligned16(g.q) && af2::aligned16(g.k) &&
               af2::aligned16(g.v) && af2::aligned16(g.dout);
    for (const Operand* op : {&g.qs, &g.ks, &g.vs, &g.dos})
      vec = vec && op->sb % 8 == 0 && op->sh % 8 == 0 && op->sn % 8 == 0 && op->sr % 8 == 0;
    const int v = vec ? 1 : 0;
    if (which == Which::kDq) return launch_kernel(chunked_dq_kernel_mma<kChunk>, pl, stream, g, v);
    return launch_kernel(chunked_dkv_kernel_mma<kChunk>, pl, stream, g, v);
  } else {
    if (which == Which::kDq) return launch_kernel(chunked_dq_kernel<kChunk>, pl, stream, g);
    return launch_kernel(chunked_dkv_kernel<kChunk>, pl, stream, g);
  }
}

namespace tg = af2::sm90::tied_grad;

template <int D, int C, bool kDkv>
cudaError_t dispatch_sm90(const tg::TiedGradOperands& a, int stages, cudaStream_t stream,
                          Af2LaunchPlan* plan_out) {
  if (plan_out != nullptr) {
    *plan_out = tg::plan_tied_grad<D, C>(kDkv, a.batch, a.heads, a.nq, a.nk, a.features, stages);
    return cudaSuccess;
  }
  return tg::launch_tied_grad<D, C, kDkv>(a, stages, stream);
}

// The Hopper pair at row width D: dk/dv at 64 output columns a block, dq at
// the plan's 64 or 128.
template <int D>
cudaError_t dispatch_columns(Which which, const tg::TiedGradOperands& a, tg::TiedGradPlan hp,
                             cudaStream_t stream, Af2LaunchPlan* plan_out) {
  if (which == Which::kDkv) return dispatch_sm90<D, 64, true>(a, hp.stages, stream, plan_out);
  if (hp.columns == 128) return dispatch_sm90<D, 128, false>(a, hp.stages, stream, plan_out);
  return dispatch_sm90<D, 64, false>(a, hp.stages, stream, plan_out);
}

namespace wide = af2::sm90::wide;

// One backward problem as the entries receive it: the chunked kernels'
// Grad, the Hopper kernels' operands (for `which`) and the wide route's.
struct Built {
  Grad g;
  tg::TiedGradOperands a;
  wide::WideOperands w;
};

// strides: 28 element strides, (batch, head, token, row group) of q, k, v,
// dout, dq, dk and dv in that order (those of an absent output are ignored;
// the feature stride of each must be 1). features: F, the fused feature
// axis; row_width: fd, the features of one row group (F itself for plain
// attention, whose row-group strides are then never used).
Built build(Which which, const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* dsum, void* dq, void* dk, void* dv,
            const unsigned char* q_mask, const unsigned char* kv_mask, const float* tie_scale,
            const long long* strides, int batch, int heads, int nq, int nk, int features,
            int row_width, float sm_scale, void* work, long long work_bytes) {
  Built r;
  Grad& g = r.g;
  g.q = q;
  g.k = k;
  g.v = v;
  g.dout = dout;
  g.lse = lse;
  g.dsum = dsum;
  g.q_mask = q_mask;
  g.kv_mask = kv_mask;
  g.tie_scale = tie_scale;
  g.dq = dq;
  g.dk = dk;
  g.dv = dv;
  Operand* ops[7] = {&g.qs, &g.ks, &g.vs, &g.dos, &g.dqs, &g.dks, &g.dvs};
  for (int t = 0; t < 7; ++t) {
    ops[t]->sb = strides != nullptr ? strides[4 * t] : 0;
    ops[t]->sh = strides != nullptr ? strides[4 * t + 1] : 0;
    ops[t]->sn = strides != nullptr ? strides[4 * t + 2] : 0;
    ops[t]->sr = strides != nullptr ? strides[4 * t + 3] : 0;
  }
  g.geom.features = features;
  g.geom.fd = row_width;
  g.batch = batch;
  g.heads = heads;
  g.nq = nq;
  g.nk = nk;
  g.chunks = (features + kChunk - 1) / kChunk;
  g.sm_scale = sm_scale;
  const bool dkv = which == Which::kDkv;
  tg::TiedGradOperands& a = r.a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.dsum = dsum;
  a.q_mask = q_mask;
  a.kv_mask = kv_mask;
  a.tie_scale = tie_scale;
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
  a.features = features;
  a.row_width = row_width;
  a.sm_scale = sm_scale;
  wide::WideOperands& w = r.w;
  w = wide::WideOperands{};
  w.q = q;
  w.k = k;
  w.v = v;
  w.dout = dout;
  w.lse = lse;
  w.dsum = dsum;
  w.q_mask = q_mask;
  w.kv_mask = kv_mask;
  w.tie_scale = tie_scale;
  w.dq = dq;
  w.dk = dk;
  w.dv = dv;
  w.qs = g.qs;
  w.ks = g.ks;
  w.vs = g.vs;
  w.dos = g.dos;
  w.dqs = g.dqs;
  w.dks = g.dks;
  w.dvs = g.dvs;
  w.batch = batch;
  w.heads = heads;
  w.nq = nq;
  w.nk = nk;
  w.features = features;
  w.row_width = row_width;
  w.sm_scale = sm_scale;
  w.work = work;
  w.work_bytes = work_bytes;
  return r;
}

// The wide route's plan where a bf16 problem whose operands TMA can
// describe is too wide for the resident kernels, else splits 0.
wide::WidePlan wide_plan(int dtype, bool tma, int batch, int heads, int nq, int nk,
                         int features, int row_width) {
  if (dtype != 1 || !tma) return {0, 0, 0};
  if (tg::plan_shape(false, batch, heads, nq, nk, features, row_width).columns != 0)
    return {0, 0, 0};
  return wide::plan_wide(true, batch, heads, nq, nk, features, row_width);
}

cudaError_t launch_wide(const wide::WideOperands& w, const wide::WidePlan& wp, bool want_dq,
                        bool want_dkv, cudaStream_t stream) {
  switch (w.row_width) {
    case 32: return wide::launch_backward<32>(w, wp, want_dq, want_dkv, stream);
    case 64: return wide::launch_backward<64>(w, wp, want_dq, want_dkv, stream);
    default: return wide::launch_backward<128>(w, wp, want_dq, want_dkv, stream);
  }
}

// `info`, when given, receives {1 if a Hopper kernel (tied_dq_kernel_sm90 /
// tied_dkv_kernel_sm90 or the wide route) ran, else 0; 1 if the wide route
// ran}. With `plan_out` it only fills the plan (strides may then be null,
// no pointer is read, and `aligned` stands for whether TMA can describe the
// operands; a launch finds it from the pointers and strides).
int run(Which which, int dtype, const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* dsum, void* dq, void* dk, void* dv,
        const unsigned char* q_mask, const unsigned char* kv_mask, const float* tie_scale,
        const long long* strides, int batch, int heads, int nq, int nk, int features,
        int row_width, float sm_scale, int* info, void* stream, void* work = nullptr,
        long long work_bytes = 0, Af2LaunchPlan* plan_out = nullptr, int aligned = 0) {
  if (features < 1 || row_width < 1) return cudaErrorInvalidValue;
  const Built r = build(which, q, k, v, dout, lse, dsum, dq, dk, dv, q_mask, kv_mask, tie_scale,
                        strides, batch, heads, nq, nk, features, row_width, sm_scale, work,
                        work_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dkv = which == Which::kDkv;
  const bool tma = plan_out != nullptr ? aligned != 0 : tg::takes(r.a, dkv);
  const tg::TiedGradPlan hp =
      dtype == 1 && tma ? tg::plan_shape(dkv, batch, heads, nq, nk, features, row_width)
                        : tg::TiedGradPlan{0, 0};
  const wide::WidePlan wp =
      hp.columns == 0 ? wide_plan(dtype, tma, batch, heads, nq, nk, features, row_width)
                      : wide::WidePlan{0, 0, 0};
  if (info != nullptr) {
    info[0] = hp.columns != 0 || wp.splits != 0 ? 1 : 0;
    info[1] = wp.splits != 0 ? 1 : 0;
  }
  if (hp.columns != 0) {
    switch (row_width) {
      case 32: return dispatch_columns<32>(which, r.a, hp, s, plan_out);
      case 64: return dispatch_columns<64>(which, r.a, hp, s, plan_out);
      default: return dispatch_columns<128>(which, r.a, hp, s, plan_out);
    }
  }
  if (wp.splits != 0) {
    if (plan_out != nullptr) {
      *plan_out = wide::plan_pass(true, 0, wp, batch, heads, nq, nk, features, row_width);
      return cudaSuccess;
    }
    return launch_wide(r.w, wp, !dkv, dkv, s);
  }
  if (dtype == 0) return launch<float>(which, r.g, s, plan_out);
  if (dtype == 1) return launch<__nv_bfloat16>(which, r.g, s, plan_out);
  return cudaErrorInvalidValue;
}

}  // namespace

// dq (like q) from the forward's lse and dsum, both contiguous (batch,
// heads, nq) f32; tie_scale (batch,) f32 on the device, or null. dtype: 0 =
// float32, 1 = bfloat16. info: 2 ints as `run`, or null. work: a 256-byte
// aligned device buffer of work_bytes, which the wide route needs (at
// least wide::workspace_bytes of its plan) and the other routes ignore
// (null, 0). Returns the cudaError_t of the launch (0 on success).
extern "C" int af2_tied_row_attention_bwd_dq(int dtype, const void* q, const void* k,
                                             const void* v, const void* dout, const float* lse,
                                             const float* dsum, void* dq,
                                             const unsigned char* q_mask,
                                             const unsigned char* kv_mask,
                                             const float* tie_scale, const long long* strides,
                                             int batch, int heads, int nq, int nk, int features,
                                             int row_width, float sm_scale, void* work,
                                             long long work_bytes, int* info, void* stream) {
  return run(Which::kDq, dtype, q, k, v, dout, lse, dsum, dq, nullptr, nullptr, q_mask, kv_mask,
             tie_scale, strides, batch, heads, nq, nk, features, row_width, sm_scale, info,
             stream, work, work_bytes);
}

// dk and dv (like k) instead of dq.
extern "C" int af2_tied_row_attention_bwd_dkv(int dtype, const void* q, const void* k,
                                              const void* v, const void* dout, const float* lse,
                                              const float* dsum, void* dk, void* dv,
                                              const unsigned char* q_mask,
                                              const unsigned char* kv_mask,
                                              const float* tie_scale, const long long* strides,
                                              int batch, int heads, int nq, int nk, int features,
                                              int row_width, float sm_scale, void* work,
                                              long long work_bytes, int* info, void* stream) {
  return run(Which::kDkv, dtype, q, k, v, dout, lse, dsum, nullptr, dk, dv, q_mask, kv_mask,
             tie_scale, strides, batch, heads, nq, nk, features, row_width, sm_scale, info,
             stream, work, work_bytes);
}

// dq, dk and dv together, as af2_tied_row_attention_bwd_dq and _dkv give
// them: on the wide route the logits and p, ds passes run once for the
// three products; on every other route the two entries' launches in turn.
// info: 3 ints, {dq on a Hopper kernel, dk/dv on a Hopper kernel, the wide
// route ran}, or null.
extern "C" int af2_tied_row_attention_bwd_grads(int dtype, const void* q, const void* k,
                                                const void* v, const void* dout,
                                                const float* lse, const float* dsum, void* dq,
                                                void* dk, void* dv,
                                                const unsigned char* q_mask,
                                                const unsigned char* kv_mask,
                                                const float* tie_scale, const long long* strides,
                                                int batch, int heads, int nq, int nk,
                                                int features, int row_width, float sm_scale,
                                                void* work, long long work_bytes, int* info,
                                                void* stream) {
  if (features < 1 || row_width < 1) return cudaErrorInvalidValue;
  const Built r = build(Which::kDq, q, k, v, dout, lse, dsum, dq, dk, dv, q_mask, kv_mask,
                        tie_scale, strides, batch, heads, nq, nk, features, row_width, sm_scale,
                        work, work_bytes);
  tg::TiedGradOperands both = r.a;  // dk/dv's outputs too: TMA must describe all three
  both.out0 = dk;
  both.out1 = dv;
  both.o0s = r.g.dks;
  const bool tma = tg::takes(r.a, false) && tg::takes(both, true);
  const wide::WidePlan wp = wide_plan(dtype, tma, batch, heads, nq, nk, features, row_width);
  if (wp.splits != 0) {
    if (info != nullptr) info[0] = info[1] = info[2] = 1;
    return launch_wide(r.w, wp, true, true, static_cast<cudaStream_t>(stream));
  }
  int parts[2][2] = {{0, 0}, {0, 0}};
  int err = run(Which::kDq, dtype, q, k, v, dout, lse, dsum, dq, nullptr, nullptr, q_mask,
                kv_mask, tie_scale, strides, batch, heads, nq, nk, features, row_width, sm_scale,
                parts[0], stream);
  if (err == cudaSuccess)
    err = run(Which::kDkv, dtype, q, k, v, dout, lse, dsum, nullptr, dk, dv, q_mask, kv_mask,
              tie_scale, strides, batch, heads, nq, nk, features, row_width, sm_scale, parts[1],
              stream);
  if (info != nullptr) {
    info[0] = parts[0][0];
    info[1] = parts[1][0];
    info[2] = 0;
  }
  return err;
}

// The launch plan of the dq (which = 0) or dk/dv (which = 1) kernel at one
// shape (R = features / row_width rows), given whether TMA can describe the
// operands; touches no device. Names the instantiation a launch at that
// shape takes. Returns 0, or cudaErrorInvalidValue for a dtype, `which`,
// feature count or row width the kernels do not take.
extern "C" int af2_tied_row_attention_bwd_plan(int which, int dtype, int batch, int heads,
                                               int nq, int nk, int features, int row_width,
                                               int aligned, Af2LaunchPlan* plan) {
  if (which != 0 && which != 1) return cudaErrorInvalidValue;
  return run(which == 0 ? Which::kDq : Which::kDkv, dtype, nullptr, nullptr, nullptr, nullptr,
             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             batch, heads, nq, nk, features, row_width, 1.f, nullptr, nullptr, nullptr, 0, plan,
             aligned);
}

// The backward's wide route at one shape, given whether TMA can describe
// the operands (cudaErrorInvalidValue where the shape does not take it):
// `wide_route` fills the logits pass's feature splits and the workspace a
// launch needs; `wide_pass` the plan of pass `pass` (0 the logits, S and
// dP; 1 p and ds; 2 the dq product; 3 a dk or dv product, launched twice).
extern "C" int af2_tied_row_attention_bwd_wide_route(int dtype, int batch, int heads, int nq,
                                                     int nk, int features, int row_width,
                                                     int aligned, int* splits,
                                                     long long* work_bytes) {
  const wide::WidePlan wp =
      wide_plan(dtype, aligned != 0, batch, heads, nq, nk, features, row_width);
  if (wp.splits == 0) return cudaErrorInvalidValue;
  *splits = wp.splits;
  *work_bytes = wide::workspace_bytes(true, wp, batch, heads, nq, nk);
  return cudaSuccess;
}

extern "C" int af2_tied_row_attention_bwd_wide_pass(int pass, int dtype, int batch, int heads,
                                                    int nq, int nk, int features,
                                                    int row_width, int aligned,
                                                    Af2LaunchPlan* plan) {
  const wide::WidePlan wp =
      wide_plan(dtype, aligned != 0, batch, heads, nq, nk, features, row_width);
  if (wp.splits == 0 || pass < 0 || pass > 3) return cudaErrorInvalidValue;
  *plan = wide::plan_pass(true, pass, wp, batch, heads, nq, nk, features, row_width);
  return cudaSuccess;
}
