// K2: tied-row MSA attention for Hopper (sm_90a).
//
// Replaces the TPU path alphafold2_tpu/ops/pallas/tied_row.py
// `tied_row_attention` (:53), which folds (B, R, N, H, D) into head dim R*D
// and runs the fused kernel of ops/pallas/axial.py (`_run`, pallas_call
// :249) with the per-batch tie scale pre-folded into q.
//
// Computes one attention matrix per (batch, head) shared by all R MSA rows:
//     logits[b, h, i, j] = sm_scale * tie_scale[b] * sum_r q[b, r, i, h] . k[b, r, j, h]
//     out[b, r, i, h]    = sum_j softmax_j(logits | kv_mask) v[b, r, j, h]
// with the masking contract of attention_tile.cuh (masked keys excluded,
// masked queries and key-less rows write 0). The (B, R, N, H, D) operands
// are read in place (no fold copy) and the tie scale is applied to the f32
// logits, not to a rounded copy of q.
//
// What bounds it on the H100: at the main-path shapes (R*D 320, N 64-128)
// the problem is small and one block's latency bounds it (its loads and its
// chain of R*D / 16 products for S); at the PLM grid's R*D 8192 the bytes
// of q, k and v do. The plan picks one of four routes by dtype, shape and
// alignment alone (never by retrying a failed launch):
//
// * bf16 at head dim 32, 64 or 128 with 16-byte aligned operands and R*D
//   narrow enough for the resident q tile plus two stages (R*D <= 512 at
//   head dim 64): tied_row_attention_kernel_sm90<D, C>
//   (tied_row_attention_sm90.cuh): 5-D TMA boxes of all R rows of a token
//   tile, S computed once per 64-key tile over the whole R*D axis by wgmma,
//   C = 64 or 128 output columns a block. Every main-path shape takes it.
// * any wider bf16 problem at those head dims with aligned operands: the
//   wide route (tied_row_wide_sm90.cuh), three passes: the logits once over
//   R*D in feature splits (tied_wide_logits_kernel<D, 2>), the splits summed
//   in a fixed order with the softmax (tied_wide_softmax_kernel, bf16 P and
//   the lse into the caller's workspace), then P V' by column group
//   (tied_wide_product_kernel<D, C>). edge_tied_rows_1280, config_4's
//   R*D 1024 and the PLM grid's R*D 8192 and 12288 take it.
// * any other bf16 problem (other head dims, unaligned operands):
//   attention_kernel_mma<64> (attention_tile.cuh), D-chunked: the logits of
//   a 64-key tile accumulated over 64-wide feature chunks staged one at a
//   time, one block per 64-wide output chunk, each recomputing the logits
//   of its query tile (R*D / 64 times the work).
// * f32: attention_kernel<64> on the CUDA cores, D-chunked likewise, the
//   exactness path of the small-model checks.
//
// Training uses af2_tied_row_attention_lse, which also writes each row's
// logsumexp of the shared (tie-scaled) logits for the backward kernels
// (tied_row_attention_bwd.cu), as the TPU path's `_kernel` does beside
// `_kernel_no_lse` (axial.py :110-120). Both entries launch the kernel the
// plan names, so af2_tied_row_attention_plan plans both. The strided entry,
// af2_tied_row_attention_strided, takes each operand's element strides
// instead of the contiguous layout; K1's wrapper runs a bf16 head dim past
// 128 that is a multiple of 64 through it, as R = D/64 rows of 64 under tie
// scale 1 (the same plans, by R and the row width).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (alphafold2_tpu_torch/ops/cuda/build.py). Bound with ctypes.

#include "attention_tile.cuh"
#include "tied_row_attention_sm90.cuh"
#include "tied_row_wide_sm90.cuh"
#include "tied_row_split.cuh"

namespace {

constexpr int kChunk = 64;  // feature chunk for logits and output

template <int D, int C>
cudaError_t dispatch_sm90(const af2::Problem& p, int rows, int stages, cudaStream_t stream,
                          Af2LaunchPlan* plan_out) {
  if (plan_out != nullptr) {
    *plan_out = af2::sm90::tied::plan_tied<D, C>(p.batch, rows, p.heads, p.nq, stages);
    return cudaSuccess;
  }
  return af2::sm90::tied::launch_tied<D, C>(p, rows, stages, stream);
}

namespace wide = af2::sm90::wide;

// The wide route's operands from K2's contiguous problem.
wide::WideOperands wide_operands(const af2::Problem& p, void* work, long long work_bytes) {
  wide::WideOperands a{};
  a.q = p.q;
  a.k = p.k;
  a.v = p.v;
  a.q_mask = p.q_mask;
  a.kv_mask = p.kv_mask;
  a.tie_scale = p.tie_scale;
  a.out = p.o;
  a.lse_out = p.lse;
  a.qs = p.qs;
  a.ks = p.ks;
  a.vs = p.vs;
  a.os = p.os;
  a.batch = p.batch;
  a.heads = p.heads;
  a.nq = p.nq;
  a.nk = p.nk;
  a.features = p.features;
  a.row_width = p.fd;
  a.sm_scale = p.sm_scale;
  a.work = work;
  a.work_bytes = work_bytes;
  return a;
}

// Launches K2, or with `plan_out` only fills its plan (no pointer is read,
// and `aligned` stands for whether TMA can describe the operands, which a
// launch finds from the pointers and strides). strides: 16 element strides,
// (batch, head, token, row group) of q, k, v and out, or null for the
// contiguous (B, R, N, H, D) layout. tie_scale: (batch,) f32, or null (1).
// `info`, when given, receives {1 if a Hopper kernel (the resident one or
// the wide route) ran, 1 if the wide route ran}.
int run(int dtype, const void* q, const void* k, const void* v, void* out, float* lse,
        const unsigned char* q_mask, const unsigned char* kv_mask, const float* tie_scale,
        const long long* strides, int batch, int rows, int heads, int nq, int nk, int head_dim,
        float sm_scale, void* stream, void* work = nullptr, long long work_bytes = 0,
        int* info = nullptr, Af2LaunchPlan* plan_out = nullptr, int aligned = 0) {
  af2::Problem p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.lse = lse;
  p.q_mask = q_mask;
  p.kv_mask = kv_mask;
  p.tie_scale = tie_scale;
  const long long hd = (long long)heads * head_dim;
  const int n_of[4] = {nq, nk, nk, nq};
  const void* ptr_of[4] = {q, k, v, out};
  af2::Operand* ops[4] = {&p.qs, &p.ks, &p.vs, &p.os};
  bool tma = true;
  for (int t = 0; t < 4; ++t) {
    if (strides != nullptr) {
      ops[t]->sb = strides[4 * t];
      ops[t]->sh = strides[4 * t + 1];
      ops[t]->sn = strides[4 * t + 2];
      ops[t]->sr = strides[4 * t + 3];
    } else {
      ops[t]->sn = hd;
      ops[t]->sh = head_dim;
      ops[t]->sr = (long long)n_of[t] * hd;
      ops[t]->sb = (long long)rows * n_of[t] * hd;
    }
    if (plan_out == nullptr)
      tma = tma && af2::sm90::rows_operand(ptr_of[t], *ops[t], batch, heads, n_of[t], rows);
  }
  p.batch = batch;
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.features = rows * head_dim;
  p.fd = head_dim;
  p.out_chunks = (p.features + kChunk - 1) / kChunk;
  p.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan_out != nullptr) tma = aligned != 0;
  const af2::sm90::tied::TiedPlan hp =
      dtype == 1 && tma ? af2::sm90::tied::plan_shape(batch, rows, heads, nq, head_dim)
                        : af2::sm90::tied::TiedPlan{0, 0};
  const wide::WidePlan wp = dtype == 1 && tma && hp.columns == 0
                               ? wide::plan_wide(false, batch, heads, nq, nk, p.features, head_dim)
                               : wide::WidePlan{0, 0, 0};
  if (info != nullptr) {
    info[0] = hp.columns != 0 || wp.splits != 0 ? 1 : 0;
    info[1] = wp.splits != 0 ? 1 : 0;
  }
  if (hp.columns == 128) {
    switch (head_dim) {
      case 32: return dispatch_sm90<32, 128>(p, rows, hp.stages, s, plan_out);
      case 64: return dispatch_sm90<64, 128>(p, rows, hp.stages, s, plan_out);
      default: return dispatch_sm90<128, 128>(p, rows, hp.stages, s, plan_out);
    }
  }
  if (hp.columns == 64) {
    switch (head_dim) {
      case 32: return dispatch_sm90<32, 64>(p, rows, hp.stages, s, plan_out);
      case 64: return dispatch_sm90<64, 64>(p, rows, hp.stages, s, plan_out);
      default: return dispatch_sm90<128, 64>(p, rows, hp.stages, s, plan_out);
    }
  }
  if (wp.splits != 0) {
    if (plan_out != nullptr) {
      *plan_out = wide::plan_pass(false, 0, wp, batch, heads, nq, nk, p.features, head_dim);
      return cudaSuccess;
    }
    const wide::WideOperands a = wide_operands(p, work, work_bytes);
    switch (head_dim) {
      case 32: return wide::launch_forward<32>(a, wp, s);
      case 64: return wide::launch_forward<64>(a, wp, s);
      default: return wide::launch_forward<128>(a, wp, s);
    }
  }
  if (dtype == 0) return af2::launch_attention<float, kChunk>(p, s, plan_out);
  if (dtype == 1) return af2::launch_attention<__nv_bfloat16, kChunk>(p, s, plan_out);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: (batch, rows, nq, heads, head_dim), k/v: (batch, rows, nk, heads,
// head_dim), out like q; all contiguous. tie_scale: (batch,) f32 on the
// device. dtype: 0 = float32, 1 = bfloat16. work: a 256-byte aligned device
// buffer of work_bytes, which the wide route needs (at least
// wide::workspace_bytes of its plan) and the other routes ignore (null, 0).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int af2_tied_row_attention(int dtype, const void* q, const void* k, const void* v,
                                      void* out, const unsigned char* q_mask,
                                      const unsigned char* kv_mask, const float* tie_scale,
                                      int batch, int rows, int heads, int nq, int nk,
                                      int head_dim, float sm_scale, void* work,
                                      long long work_bytes, void* stream) {
  return run(dtype, q, k, v, out, nullptr, q_mask, kv_mask, tie_scale, nullptr, batch, rows,
             heads, nq, nk, head_dim, sm_scale, stream, work, work_bytes);
}

// The training forward: as af2_tied_row_attention, and also writes each
// query row's logsumexp of the shared scaled logits into lse, a contiguous
// (batch, heads, nq) f32 buffer (+inf for a row with no valid key).
extern "C" int af2_tied_row_attention_lse(int dtype, const void* q, const void* k,
                                          const void* v, void* out, float* lse,
                                          const unsigned char* q_mask,
                                          const unsigned char* kv_mask, const float* tie_scale,
                                          int batch, int rows, int heads, int nq, int nk,
                                          int head_dim, float sm_scale, void* work,
                                          long long work_bytes, void* stream) {
  return run(dtype, q, k, v, out, lse, q_mask, kv_mask, tie_scale, nullptr, batch, rows, heads,
             nq, nk, head_dim, sm_scale, stream, work, work_bytes);
}

// K2 on operands through their element strides, as the backward's entries
// take them, and the route of K1 at a head dim past 128 that is a multiple
// of 64 (ops/cuda/axial.py): its (B, H, N, D) views read as R = D/64 rows
// of 64 features (row stride 64) under tie scale 1 (tie_scale null).
// strides: 16 element strides, (batch, head, token, row group) of q, k, v
// and out; features: R * row_width; lse: (batch, heads, nq) f32, or null
// (serving); info: 2 ints out, as `run`. work, work_bytes: as
// af2_tied_row_attention. Returns the cudaError_t of the launch.
extern "C" int af2_tied_row_attention_strided(int dtype, const void* q, const void* k,
                                              const void* v, void* out, float* lse,
                                              const unsigned char* q_mask,
                                              const unsigned char* kv_mask,
                                              const float* tie_scale, const long long* strides,
                                              int batch, int heads, int nq, int nk,
                                              int features, int row_width, float sm_scale,
                                              void* work, long long work_bytes, int* info,
                                              void* stream) {
  if (row_width < 1 || features < row_width || features % row_width != 0 || strides == nullptr)
    return cudaErrorInvalidValue;
  return run(dtype, q, k, v, out, lse, q_mask, kv_mask, tie_scale, strides, batch,
             features / row_width, heads, nq, nk, row_width, sm_scale, stream, work, work_bytes,
             info);
}

// K2's launch plan at one shape (with or without lse, contiguous or
// strided: the same kernels), given whether TMA can describe the operands;
// touches no device. Names
// the instantiation a launch at that shape takes (the wide route: its first
// pass, the logits). Returns 0, or cudaErrorInvalidValue for a dtype the
// kernels do not take.
extern "C" int af2_tied_row_attention_plan(int dtype, int batch, int rows, int heads, int nq,
                                           int nk, int head_dim, int aligned,
                                           Af2LaunchPlan* plan) {
  return run(dtype, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             nullptr, batch, rows, heads, nq, nk, head_dim, 1.f, nullptr, nullptr, 0, nullptr,
             plan, aligned);
}

// The wide route's plan at one shape, as af2_tied_row_attention_plan
// (cudaErrorInvalidValue where the shape does not take the wide route):
// `wide_route` fills the route's numbers, the logits pass's feature splits
// and the workspace a launch needs; `wide_pass` the plan of pass `pass` (0
// the logits, 1 the softmax, 2 P V').
static wide::WidePlan wide_route(int dtype, int batch, int rows, int heads, int nq, int nk,
                          int head_dim, int aligned) {
  const bool hopper = dtype == 1 && aligned &&
                      af2::sm90::tied::plan_shape(batch, rows, heads, nq, head_dim).columns != 0;
  return dtype == 1 && aligned && !hopper
             ? wide::plan_wide(false, batch, heads, nq, nk, rows * head_dim, head_dim)
             : wide::WidePlan{0, 0, 0};
}

extern "C" int af2_tied_row_attention_wide_route(int dtype, int batch, int rows, int heads,
                                                 int nq, int nk, int head_dim, int aligned,
                                                 int* splits, long long* work_bytes) {
  const wide::WidePlan wp = wide_route(dtype, batch, rows, heads, nq, nk, head_dim, aligned);
  if (wp.splits == 0) return cudaErrorInvalidValue;
  *splits = wp.splits;
  *work_bytes = wide::workspace_bytes(false, wp, batch, heads, nq, nk);
  return cudaSuccess;
}

extern "C" int af2_tied_row_attention_wide_pass(int pass, int dtype, int batch, int rows,
                                                int heads, int nq, int nk, int head_dim,
                                                int aligned, Af2LaunchPlan* plan) {
  const wide::WidePlan wp = wide_route(dtype, batch, rows, heads, nq, nk, head_dim, aligned);
  if (wp.splits == 0 || pass < 0 || pass > 2) return cudaErrorInvalidValue;
  *plan = wide::plan_pass(false, pass, wp, batch, heads, nq, nk, rows * head_dim, head_dim);
  return cudaSuccess;
}

// ------------------------------------------------ the split route (a mesh)
//
// K2 on MSA rows sharded over a mesh axis (tied_row_split.cuh): each pass
// its own entry on caller-owned buffers, so that the caller all-reduces the
// logits (forward) and dP and dsum (backward) over the row axis between
// them. dtype: 0 = float32, 1 = bfloat16. Operands through element strides,
// (batch, head, token, row group) of each; planes (B*H, round64(nq),
// round64(nk)) f32; P, dS, dS^T and P^T in the operand dtype. Each returns
// the cudaError_t of its launches (0 on success).

namespace {

namespace sp = af2::split;

af2::Operand operand(const long long* strides, int t) {
  return af2::Operand{strides[4 * t], strides[4 * t + 1], strides[4 * t + 2], strides[4 * t + 3]};
}

// The Hopper route takes bf16 at row width 32, 64 or 128 whose operands TMA
// can describe.
bool split_hopper(int dtype, const void* const* ptrs, const af2::Operand* ops, const int* ns,
                  int count, int batch, int heads, int features, int row_width) {
  if (!sp::hopper_width(dtype, row_width, features)) return false;
  for (int t = 0; t < count; ++t)
    if (!af2::sm90::rows_operand(ptrs[t], ops[t], batch, heads, ns[t], features / row_width))
      return false;
  return true;
}

wide::WideOperands split_operands(int batch, int heads, int na, int nb, int features,
                                  int row_width, const float* tie_scale, float sm_scale) {
  wide::WideOperands a{};
  a.batch = batch;
  a.heads = heads;
  a.nq = na;
  a.nk = nb;
  a.features = features;
  a.row_width = row_width;
  a.tie_scale = tie_scale;
  a.sm_scale = sm_scale;
  return a;
}

}  // namespace

// The plan of one split pass at a shape (touches no device): pass 0 the
// logits (of na x nb tokens; on the Hopper route its first kernel), 1 the
// splits' sum, 2 the softmax, 3 the grad, 4 a product of m = na output
// tokens over n = nb. hopper: whether the operands take the Hopper route.
// work_bytes (pass 0): the workspace the logits pass needs; splits (pass
// 0): its feature splits (1 off the Hopper route).
extern "C" int af2_tied_split_plan(int pass, int dtype, int batch, int heads, int na, int nb,
                                   int features, int row_width, int hopper, Af2LaunchPlan* plan,
                                   int* splits, long long* work_bytes) {
  if (pass < 0 || pass > 4 || (dtype != 0 && dtype != 1) || features < row_width ||
      row_width < 1 || features % row_width != 0)
    return cudaErrorInvalidValue;
  const bool hop = hopper != 0 && sp::hopper_width(dtype, row_width, features);
  *plan = sp::plan_split_pass(pass, hop, dtype, batch, heads, na, nb, features, row_width);
  const wide::WidePlan wp = hop ? sp::plan_logits(batch, heads, na, nb, features, row_width)
                                : wide::WidePlan{1, 1, 1};
  if (splits != nullptr) *splits = wp.splits;
  if (work_bytes != nullptr) *work_bytes = sp::logits_work_bytes(wp, batch, heads, na, nb);
  return cudaSuccess;
}

// The logits pass: plane = A B^T over the fused features, A (B, R, na, H,
// D) and B (B, R, nb, H, D); strides: 8, A's then B's. work: the plan's
// work_bytes (256-byte aligned) where the Hopper route splits. info: 2 ints
// out, {the Hopper route ran, its splits}, or null.
extern "C" int af2_tied_split_logits(int dtype, const void* a, const void* b, float* plane,
                                     const long long* strides, int batch, int heads, int na,
                                     int nb, int features, int row_width, void* work,
                                     long long work_bytes, int* info, void* stream) {
  if (features < row_width || row_width < 1 || features % row_width != 0 || strides == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const af2::Operand ops[2] = {operand(strides, 0), operand(strides, 1)};
  const void* ptrs[2] = {a, b};
  const int ns[2] = {na, nb};
  const bool hop = split_hopper(dtype, ptrs, ops, ns, 2, batch, heads, features, row_width);
  const long long nap = sp::round64(na), nbp = sp::round64(nb);
  if (info != nullptr) info[0] = hop ? 1 : 0;
  if (hop) {
    const wide::WidePlan wp = sp::plan_logits(batch, heads, na, nb, features, row_width);
    if (info != nullptr) info[1] = wp.splits;
    const long long need = sp::logits_work_bytes(wp, batch, heads, na, nb);
    if (need > 0 && (work == nullptr || work_bytes < need ||
                     reinterpret_cast<uintptr_t>(work) % 256 != 0))
      return cudaErrorInvalidValue;
    wide::WideOperands w = split_operands(batch, heads, na, nb, features, row_width, nullptr, 1.f);
    w.q = a;
    w.k = b;
    w.qs = ops[0];
    w.ks = ops[1];
    float* ws = wp.splits > 1 ? static_cast<float*>(work) : plane;
    cudaError_t err;
    switch (row_width) {
      case 32: err = wide::launch_logits<32, 2>(w, wp, ws, s); break;
      case 64: err = wide::launch_logits<64, 2>(w, wp, ws, s); break;
      default: err = wide::launch_logits<128, 2>(w, wp, ws, s); break;
    }
    if (err != cudaSuccess || wp.splits == 1) return err;
    const Af2LaunchPlan sum =
        sp::plan_split_pass(1, true, dtype, batch, heads, na, nb, features, row_width);
    sp::split_sum_kernel<<<(unsigned)sum.blocks, sum.threads, 0, s>>>(
        ws, plane, (long long)batch * heads * nap * nbp, wp.splits);
    return cudaGetLastError();
  }
  if (info != nullptr) info[1] = 1;
  sp::LogitsParams lp;
  lp.a = a;
  lp.b = b;
  lp.as = ops[0];
  lp.bs = ops[1];
  lp.plane = plane;
  lp.heads = heads;
  lp.na = na;
  lp.nb = nb;
  lp.nap = (int)nap;
  lp.nbp = (int)nbp;
  lp.features = features;
  lp.row_width = row_width;
  lp.a_tiles = (int)(nap / sp::kTile);
  lp.b_tiles = (int)(nbp / sp::kTile);
  const Af2LaunchPlan plan =
      sp::plan_split_pass(0, false, dtype, batch, heads, na, nb, features, row_width);
  if (!af2::grid_fits(plan)) return cudaErrorInvalidValue;
  if (dtype == 1)
    sp::split_logits_kernel<__nv_bfloat16><<<(unsigned)plan.blocks, plan.threads, 0, s>>>(lp);
  else if (dtype == 0)
    sp::split_logits_kernel<float><<<(unsigned)plan.blocks, plan.threads, 0, s>>>(lp);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// The softmax pass on the whole logits: prob (the operand dtype) and lse
// (B, H, nq) f32 (+inf for a row with no valid key). tie_scale (B,) f32 or
// null. The wide route's softmax on the plane as its one split.
extern "C" int af2_tied_split_softmax(int dtype, const float* plane, void* prob, float* lse,
                                      const unsigned char* q_mask, const unsigned char* kv_mask,
                                      const float* tie_scale, int batch, int heads, int nq,
                                      int nk, float sm_scale, void* stream) {
  wide::SoftmaxParams p;
  p.ws = plane;
  p.prob = prob;
  p.lse = lse;
  p.q_mask = q_mask;
  p.kv_mask = kv_mask;
  p.tie_scale = tie_scale;
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.nqp = (int)sp::round64(nq);
  p.nkp = (int)sp::round64(nk);
  p.plane = (long long)batch * heads * p.nqp * p.nkp;
  p.splits = 1;
  p.scale_log2 = sm_scale * wide::kLog2e;
  const Af2LaunchPlan plan = sp::plan_split_pass(2, false, dtype, batch, heads, nq, nk, 1, 1);
  if (!af2::grid_fits(plan)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    wide::tied_wide_softmax_kernel<__nv_bfloat16>
        <<<(unsigned)plan.blocks, plan.threads, 0, s>>>(p);
  else if (dtype == 0)
    wide::tied_wide_softmax_kernel<float><<<(unsigned)plan.blocks, plan.threads, 0, s>>>(p);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// The grad pass: from the forward's whole logits s_plane and lse and the
// whole dp_plane and dsum, dS (B*H, nqp, nkp) and dS^T, P^T (B*H, nkp,
// nqp), all in the operand dtype. The wide route's grad on the planes as
// their one split.
extern "C" int af2_tied_split_grad(int dtype, const float* s_plane, const float* dp_plane,
                                   const float* lse, const float* dsum, void* ds, void* ds_t,
                                   void* p_t, const unsigned char* q_mask,
                                   const unsigned char* kv_mask, const float* tie_scale,
                                   int batch, int heads, int nq, int nk, float sm_scale,
                                   void* stream) {
  wide::GradParams p;
  p.ws = s_plane;
  p.dp = dp_plane;
  p.lse = lse;
  p.dsum = dsum;
  p.ds = ds;
  p.ds_t = ds_t;
  p.p_t = p_t;
  p.q_mask = q_mask;
  p.kv_mask = kv_mask;
  p.tie_scale = tie_scale;
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.nqp = (int)sp::round64(nq);
  p.nkp = (int)sp::round64(nk);
  p.plane = (long long)batch * heads * p.nqp * p.nkp;
  p.splits = 1;
  p.q_tiles = p.nqp / sp::kRows;
  p.k_tiles = p.nkp / sp::kRows;
  p.scale_log2 = sm_scale * wide::kLog2e;
  const Af2LaunchPlan plan = sp::plan_split_pass(3, false, dtype, batch, heads, nq, nk, 1, 1);
  if (!af2::grid_fits(plan)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    wide::tied_wide_grad_kernel<__nv_bfloat16><<<(unsigned)plan.blocks, plan.threads, 0, s>>>(p);
  else if (dtype == 0)
    wide::tied_wide_grad_kernel<float><<<(unsigned)plan.blocks, plan.threads, 0, s>>>(p);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// A product pass: out (B, R, m, H, D) = A X over n tokens, A (B*H,
// round64(m), round64(n)) in the operand dtype, X (B, R, n, H, D), times
// sm_scale * tie[b] where `scaled`; strides: 8, X's then out's. info: 1 int
// out, whether the Hopper route ran, or null.
extern "C" int af2_tied_split_product(int dtype, const void* amat, const void* x, void* out,
                                      const long long* strides, const float* tie_scale,
                                      int batch, int heads, int m, int n, int features,
                                      int row_width, float sm_scale, int scaled, int* info,
                                      void* stream) {
  if (features < row_width || row_width < 1 || features % row_width != 0 || strides == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const af2::Operand ops[2] = {operand(strides, 0), operand(strides, 1)};
  const void* ptrs[2] = {x, out};
  const int ns[2] = {n, m};
  const bool hop = split_hopper(dtype, ptrs, ops, ns, 2, batch, heads, features, row_width);
  if (info != nullptr) info[0] = hop ? 1 : 0;
  if (hop) {
    const wide::WideOperands w =
        split_operands(batch, heads, m, n, features, row_width, tie_scale, sm_scale);
    const auto* a = static_cast<const unsigned short*>(amat);
    switch (row_width) {
      case 32: return wide::launch_product<32>(w, m, x, ops[0], n, a, out, ops[1], scaled, s);
      case 64: return wide::launch_product<64>(w, m, x, ops[0], n, a, out, ops[1], scaled, s);
      default: return wide::launch_product<128>(w, m, x, ops[0], n, a, out, ops[1], scaled, s);
    }
  }
  sp::ProductParams p;
  p.a = amat;
  p.x = x;
  p.out = out;
  p.xs = ops[0];
  p.os = ops[1];
  p.tie_scale = tie_scale;
  p.sm_scale = sm_scale;
  p.scaled = scaled;
  p.heads = heads;
  p.m = m;
  p.n = n;
  p.mp = (int)sp::round64(m);
  p.kp = (int)sp::round64(n);
  p.features = features;
  p.row_width = row_width;
  p.m_tiles = (m + sp::kTile - 1) / sp::kTile;
  p.f_tiles = (features + sp::kTile - 1) / sp::kTile;
  const Af2LaunchPlan plan =
      sp::plan_split_pass(4, false, dtype, batch, heads, m, n, features, row_width);
  if (!af2::grid_fits(plan)) return cudaErrorInvalidValue;
  if (dtype == 1)
    sp::split_product_kernel<__nv_bfloat16><<<(unsigned)plan.blocks, plan.threads, 0, s>>>(p);
  else if (dtype == 0)
    sp::split_product_kernel<float><<<(unsigned)plan.blocks, plan.threads, 0, s>>>(p);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
