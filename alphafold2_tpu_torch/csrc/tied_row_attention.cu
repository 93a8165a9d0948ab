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
// masked queries and key-less rows write 0).
//
// What bounds it on the H100: the fused feature axis R*D (320 on the serving
// path, up to 1280 = MAX_NUM_MSA x 64) does not fit one tile of shared
// memory, so the design is D-chunked: the logits of a 64-key tile are
// accumulated over 64-wide feature chunks staged one at a time, and the
// R*D-wide output is split across blocks, one 64-wide chunk each, each block
// recomputing the logits of its query tile. That recomputation multiplies the
// logits work by R*D/64 (5x on the serving path); at these sizes the kernel
// is bounded by launch and latency more than by either roofline (bf16
// multiplies on the tensor cores with mma.sync, f32 on the CUDA cores).
// The (B, R, N, H, D) operands are read in place (no fold copy) and the tie
// scale is applied to the f32 logits, not to a rounded copy of q.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (alphafold2_tpu_torch/ops/cuda/build.py). Bound with ctypes.

#include "attention_tile.cuh"

namespace {

constexpr int kChunk = 64;  // feature chunk for logits and output

// Launches K2, or with `plan_out` only fills its plan (no pointer is read).
int run(int dtype, const void* q, const void* k, const void* v, void* out,
        const unsigned char* q_mask, const unsigned char* kv_mask, const float* tie_scale,
        int batch, int rows, int heads, int nq, int nk, int head_dim, float sm_scale,
        void* stream, Af2LaunchPlan* plan_out = nullptr) {
  af2::Problem p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
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
  return run(dtype, q, k, v, out, q_mask, kv_mask, tie_scale, batch, rows, heads, nq, nk,
             head_dim, sm_scale, stream);
}

// K2's launch plan at one shape; touches no device. Returns 0, or
// cudaErrorInvalidValue for a dtype the kernel does not take.
extern "C" int af2_tied_row_attention_plan(int dtype, int batch, int rows, int heads, int nq,
                                           int nk, int head_dim, Af2LaunchPlan* plan) {
  return run(dtype, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, batch, rows,
             heads, nq, nk, head_dim, 1.f, nullptr, plan);
}
