// K2 split across a collective: the tied-row attention of MSA rows sharded
// over a mesh axis, as passes on caller-owned buffers with an all-reduce
// between them. Included by tied_row_attention.cu, whose af2_tied_split_*
// entries launch these passes.
//
// Replaces the TPU path alphafold2_tpu/parallel/seq_parallel.py `_tied_core`
// under a row-sharding axis (its logits psum) with the kernels of
// alphafold2_tpu/ops/pallas/tied_row.py `tied_row_attention` (:53, which
// reaches ops/pallas/axial.py `_run`, pallas_call :249) and, under jax.grad,
// `_run_dq` (:275) and `_run_dkv` (:313). Each rank holds R_local rows of
// (B, R, N, H, D); the logits are a sum over all rows, so:
//
//   forward   S_local = Q'K'^T over the local rows' R_local * D features
//             (logits pass) -> all-reduce S over the row axis (the caller)
//             -> P = softmax(s S | kv_mask) and the lse (softmax pass)
//             -> out = P V' for the local rows (product pass)
//   backward  dP_local = dO'V'^T (logits pass on dO and V), dsum_local
//             -> all-reduce both (the caller) -> p from the saved S and lse,
//             dS = p (dP - dsum), dS^T and P^T (grad pass) -> dq = s dS K',
//             dk = s dS^T Q', dv = P^T dO' for the local rows (product pass)
//
// with s = sm_scale * tie[b] on the f32 logits and the masking contract of
// attention_tile.cuh. Every plane is (B*H, Nq', Nk') with Nq' and Nk' the
// token counts rounded up to 64, zero past them.
//
// Two routes, chosen by dtype, row width and alignment alone:
// * bf16 at row width 32, 64 or 128 with operands TMA can describe: the
//   logits pass is the wide route's tied_wide_logits_kernel<D, 2>
//   (tied_row_wide_sm90.cuh) on its feature splits, which a stage of fewer
//   rows than it holds takes too (TMA fills the missing rows with zeros),
//   then split_sum_kernel adds the splits into the caller's plane in split
//   order; the product pass is tied_wide_product_kernel<D, C>.
// * every other dtype, row width or layout: split_logits_kernel<T> and
//   split_product_kernel<T>, 32 x 32 output tiles on the CUDA cores,
//   features and keys staged 32 at a time through shared memory.
// The softmax and grad passes are the wide route's tied_wide_softmax_kernel<T>
// and tied_wide_grad_kernel<T> on the one all-reduced plane as a single
// split, with P and dS in the operand dtype (bf16 rounded as the wide route
// rounds them; f32 kept whole).
//
// No atomics: every sum has one owner and a fixed order.

#pragma once

#include "tied_row_wide_sm90.cuh"

namespace af2 {
namespace split {

constexpr int kTile = 32;           // outputs of a CUDA-core block side
constexpr int kGenericThreads = 256;  // each thread 4 outputs of a 32 x 32 tile
constexpr int kRows = sm90::wide::kRows;  // the planes' padding
constexpr int kReduceThreads = sm90::wide::kReduceThreads;
using sm90::wide::from_f;
using sm90::wide::round64;
using sm90::wide::to_f;

// ------------------------------------------------------------- logits

struct LogitsParams {
  const void* a;  // (B, R, Na, H, D) through as
  const void* b;  // (B, R, Nb, H, D) through bs
  Operand as, bs;
  float* plane;   // (B*H, nap, nbp) f32
  int heads, na, nb, nap, nbp, features, row_width, a_tiles, b_tiles;
};

// plane[bh, i, j] = sum over the features of a[i] b[j]; zero past na, nb.
template <typename T>
__global__ void __launch_bounds__(kGenericThreads) split_logits_kernel(const LogitsParams p) {
  __shared__ float sa[kTile][kTile + 1], sb[kTile][kTile + 1];
  long long blk = blockIdx.x;
  const int bt = (int)(blk % p.b_tiles);
  blk /= p.b_tiles;
  const int at = (int)(blk % p.a_tiles);
  const long long bh = blk / p.a_tiles;
  const int b = (int)(bh / p.heads), h = (int)(bh % p.heads);
  const T* a = static_cast<const T*>(p.a);
  const T* bb = static_cast<const T*>(p.b);
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;  // ty in [0, 8)
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int f0 = 0; f0 < p.features; f0 += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += kGenericThreads) {
      const int row = e / kTile, col = e % kTile, f = f0 + col;
      const int i = at * kTile + row, j = bt * kTile + row;
      sa[row][col] = i < p.na && f < p.features
                         ? to_f<T>(a[offset(p.as, b, h, i, f, p.row_width)]) : 0.f;
      sb[row][col] = j < p.nb && f < p.features
                         ? to_f<T>(bb[offset(p.bs, b, h, j, f, p.row_width)]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kTile; ++c) {
      const float y = sb[tx][c];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = __fmaf_rn(sa[ty + 8 * r][c], y, acc[r]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = at * kTile + ty + 8 * r, j = bt * kTile + tx;
    if (i < p.nap && j < p.nbp) p.plane[(bh * p.nap + i) * p.nbp + j] = acc[r];
  }
}

// out[i] = the splits' partials of element i summed in split order.
__global__ void split_sum_kernel(const float* ws, float* out, long long plane, int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < plane;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += ws[s * plane + i];
    out[i] = acc;
  }
}

// ------------------------------------------------------------ product

struct ProductParams {
  const void* a;  // T (B*H, mp, kp)
  const void* x;  // (B, R, n, H, D) through xs
  void* out;      // (B, R, m, H, D) through os
  Operand xs, os;
  const float* tie_scale;
  float sm_scale;
  int scaled;
  int heads, m, n, mp, kp, features, row_width, m_tiles, f_tiles;
};

// out[i, f] = sum over j < n of a[i, j] x[j, f] (times s where `scaled`).
template <typename T>
__global__ void __launch_bounds__(kGenericThreads) split_product_kernel(const ProductParams p) {
  __shared__ float sa[kTile][kTile + 1], sx[kTile][kTile + 1];
  long long blk = blockIdx.x;
  const int ft = (int)(blk % p.f_tiles);
  blk /= p.f_tiles;
  const int mt = (int)(blk % p.m_tiles);
  const long long bh = blk / p.m_tiles;
  const int b = (int)(bh / p.heads), h = (int)(bh % p.heads);
  const T* a = static_cast<const T*>(p.a);
  const T* x = static_cast<const T*>(p.x);
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < p.n; j0 += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += kGenericThreads) {
      const int row = e / kTile, col = e % kTile;
      const int i = mt * kTile + row, j = j0 + col, jr = j0 + row, f = ft * kTile + col;
      sa[row][col] = i < p.m && j < p.n ? to_f<T>(a[(bh * p.mp + i) * p.kp + j]) : 0.f;
      sx[row][col] = jr < p.n && f < p.features
                         ? to_f<T>(x[offset(p.xs, b, h, jr, f, p.row_width)]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kTile; ++c) {
      const float y = sx[c][tx];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = __fmaf_rn(sa[ty + 8 * r][c], y, acc[r]);
    }
    __syncthreads();
  }
  const float scale =
      p.scaled ? p.sm_scale * (p.tie_scale != nullptr ? p.tie_scale[b] : 1.f) : 1.f;
  T* out = static_cast<T*>(p.out);
  const int f = ft * kTile + tx;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = mt * kTile + ty + 8 * r;
    if (i < p.m && f < p.features)
      out[offset(p.os, b, h, i, f, p.row_width)] = from_f<T>(acc[r] * scale);
  }
}

// --------------------------------------------------------------- host

// Which route a pass takes: the Hopper one (bf16, row width 32, 64 or 128,
// operands TMA can describe) or the CUDA-core one.
__host__ inline bool hopper_width(int dtype, int row_width, int features) {
  return dtype == 1 && (row_width == 32 || row_width == 64 || row_width == 128) &&
         features >= row_width && features % row_width == 0;
}

// The Hopper logits pass's feature splits at a shape: the wide route's plan
// (sm90::wide::plan_wide) with any whole number of rows, a stage of fewer
// rows than it holds included.
__host__ inline sm90::wide::WidePlan plan_logits(int batch, int heads, int na, int nb,
                                                 int features, int row_width) {
  namespace w = sm90::wide;
  const int rows = features / row_width, sr = w::kStageFeatures / row_width;
  if (rows >= sr) return w::plan_wide(false, batch, heads, na, nb, features, row_width);
  return {1, 1, 1};  // one stage of `rows` rows, zero-filled to sr
}

// Bytes of the logits pass's workspace: the splits' f32 partials where it
// splits (none otherwise: the one split writes the caller's plane).
__host__ inline long long logits_work_bytes(const sm90::wide::WidePlan& wp, int batch, int heads,
                                            int na, int nb) {
  return wp.splits > 1 ? 4LL * wp.splits * batch * heads * round64(na) * round64(nb) : 0;
}

// The plan of one pass at a shape. pass: 0 the logits (hopper: its first
// kernel), 1 the splits' sum, 2 the softmax, 3 the grad, 4 a product of m
// output tokens over n. `hopper` picks the route (see hopper_width).
__host__ inline Af2LaunchPlan plan_split_pass(int pass, bool hopper, int dtype, int batch,
                                              int heads, int m, int n, int features,
                                              int row_width) {
  Af2LaunchPlan plan{};
  const long long bh = (long long)batch * heads;
  const char* t = dtype == 1 ? "__nv_bfloat16" : "float";
  if (pass == 0 && hopper) {
    const sm90::wide::WidePlan wp = plan_logits(batch, heads, m, n, features, row_width);
    plan = sm90::wide::plan_pass(false, 0, wp, batch, heads, m, n, features, row_width);
  } else if (pass == 0) {
    plan.blocks = bh * (round64(m) / kTile) * (round64(n) / kTile);
    plan.threads = kGenericThreads;
    name_kernel(plan, "split_logits_kernel<%s>", t);
  } else if (pass == 1) {
    const long long elems = bh * round64(m) * round64(n);
    plan.blocks = (elems + 1023) / 1024 < 65536 ? (elems + 1023) / 1024 : 65536;
    plan.threads = 1024;
    name_kernel(plan, "split_sum_kernel");
  } else if (pass == 2) {
    plan.blocks = bh * round64(m) / (kReduceThreads / 32);
    plan.threads = kReduceThreads;
    name_kernel(plan, "tied_wide_softmax_kernel<%s>", t);
  } else if (pass == 3) {
    plan.blocks = bh * (round64(m) / kRows) * (round64(n) / kRows);
    plan.threads = kReduceThreads;
    name_kernel(plan, "tied_wide_grad_kernel<%s>", t);
  } else if (hopper) {
    plan = sm90::wide::plan_product(batch, heads, m, features, row_width);
  } else {
    plan.blocks = bh * ((m + kTile - 1) / kTile) * ((features + kTile - 1) / kTile);
    plan.threads = kGenericThreads;
    name_kernel(plan, "split_product_kernel<%s>", t);
  }
  return plan;
}

}  // namespace split
}  // namespace af2
