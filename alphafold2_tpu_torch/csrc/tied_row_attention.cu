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
