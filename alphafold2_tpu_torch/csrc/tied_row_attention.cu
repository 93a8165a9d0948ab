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
// chain of R*D / 16 products for S). The plan picks one of three kernels by
// dtype, shape and alignment alone (never by retrying a failed launch):
//
// * bf16 at head dim 32, 64 or 128 with 16-byte aligned operands and R*D
//   narrow enough for the resident q tile plus two stages (R*D <= 512 at
//   head dim 64): tied_row_attention_kernel_sm90<D, C>
//   (tied_row_attention_sm90.cuh): 5-D TMA boxes of all R rows of a token
//   tile, S computed once per 64-key tile over the whole R*D axis by wgmma,
//   C = 64 or 128 output columns a block. Every main-path and gate shape
//   but edge_tied_rows_1280 (R*D 1280) takes it.
// * any other bf16 problem: attention_kernel_mma<64> (attention_tile.cuh),
//   D-chunked: the logits of a 64-key tile accumulated over 64-wide feature
//   chunks staged one at a time, one block per 64-wide output chunk, each
//   recomputing the logits of its query tile (R*D / 64 times the work).
// * f32: attention_kernel<64> on the CUDA cores, D-chunked likewise, the
//   exactness path of the small-model checks.
//
// Training uses af2_tied_row_attention_lse, which also writes each row's
// logsumexp of the shared (tie-scaled) logits for the backward kernels
// (tied_row_attention_bwd.cu), as the TPU path's `_kernel` does beside
// `_kernel_no_lse` (axial.py :110-120). Both entries launch the kernel the
// plan names, so af2_tied_row_attention_plan plans both.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (alphafold2_tpu_torch/ops/cuda/build.py). Bound with ctypes.

#include "attention_tile.cuh"
#include "tied_row_attention_sm90.cuh"

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

// Launches K2, or with `plan_out` only fills its plan (no pointer is read,
// and `aligned` stands for the operands' 16-byte alignment, which a launch
// finds from the pointers).
int run(int dtype, const void* q, const void* k, const void* v, void* out, float* lse,
        const unsigned char* q_mask, const unsigned char* kv_mask, const float* tie_scale,
        int batch, int rows, int heads, int nq, int nk, int head_dim, float sm_scale,
        void* stream, Af2LaunchPlan* plan_out = nullptr, int aligned = 0) {
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
  af2::Operand* ops[4] = {&p.qs, &p.ks, &p.vs, &p.os};
  for (int t = 0; t < 4; ++t) {
    ops[t]->sn = hd;
    ops[t]->sh = head_dim;
    ops[t]->sr = (long long)n_of[t] * hd;
    ops[t]->sb = (long long)rows * n_of[t] * hd;
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
  const bool tma = plan_out != nullptr ? aligned != 0
                                       : af2::aligned16(q) && af2::aligned16(k) &&
                                             af2::aligned16(v) && af2::aligned16(out);
  const af2::sm90::tied::TiedPlan hp =
      dtype == 1 && tma ? af2::sm90::tied::plan_shape(batch, rows, heads, nq, head_dim)
                        : af2::sm90::tied::TiedPlan{0, 0};
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
  if (dtype == 0) return af2::launch_attention<float, kChunk>(p, s, plan_out);
  if (dtype == 1) return af2::launch_attention<__nv_bfloat16, kChunk>(p, s, plan_out);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: (batch, rows, nq, heads, head_dim), k/v: (batch, rows, nk, heads,
// head_dim), out like q; all contiguous. tie_scale: (batch,) f32 on the
// device. dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int af2_tied_row_attention(int dtype, const void* q, const void* k, const void* v,
                                      void* out, const unsigned char* q_mask,
                                      const unsigned char* kv_mask, const float* tie_scale,
                                      int batch, int rows, int heads, int nq, int nk,
                                      int head_dim, float sm_scale, void* stream) {
  return run(dtype, q, k, v, out, nullptr, q_mask, kv_mask, tie_scale, batch, rows, heads, nq,
             nk, head_dim, sm_scale, stream);
}

// The training forward: as af2_tied_row_attention, and also writes each
// query row's logsumexp of the shared scaled logits into lse, a contiguous
// (batch, heads, nq) f32 buffer (+inf for a row with no valid key).
extern "C" int af2_tied_row_attention_lse(int dtype, const void* q, const void* k,
                                          const void* v, void* out, float* lse,
                                          const unsigned char* q_mask,
                                          const unsigned char* kv_mask, const float* tie_scale,
                                          int batch, int rows, int heads, int nq, int nk,
                                          int head_dim, float sm_scale, void* stream) {
  return run(dtype, q, k, v, out, lse, q_mask, kv_mask, tie_scale, batch, rows, heads, nq, nk,
             head_dim, sm_scale, stream);
}

// K2's launch plan at one shape (with or without lse: the same kernel),
// given whether the operands are 16-byte aligned; touches no device. Names
// the instantiation a launch at that shape takes. Returns 0, or
// cudaErrorInvalidValue for a dtype the kernels do not take.
extern "C" int af2_tied_row_attention_plan(int dtype, int batch, int rows, int heads, int nq,
                                           int nk, int head_dim, int aligned,
                                           Af2LaunchPlan* plan) {
  return run(dtype, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             batch, rows, heads, nq, nk, head_dim, 1.f, nullptr, plan, aligned);
}
