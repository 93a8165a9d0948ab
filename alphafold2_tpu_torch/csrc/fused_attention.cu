// K1: fused flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel alphafold2_tpu/ops/pallas/axial.py `_run`
// (pallas_call at :249, body `_fwd_core` :56), entered by `fused_attention`
// (:356) and `axial_attn_fn` (:438). On the serving path it carries the pair
// axial passes, the MSA column pass and both flat pair<->MSA
// cross-attentions (on the TPU the last two ran JAX's stock flash kernel,
// alphafold2_tpu/ops/flash.py:41, which has the same contract).
//
// Computes out[b, h, i] = softmax_j(sm_scale * q_i . k_j | kv_mask) v_j with
// an online softmax (f32 running max, sum and accumulator); masked keys and
// the ragged key tail are excluded inside the kernel (no padding copies),
// masked queries and query rows without a valid key write 0.
//
// What bounds it on the H100: at the main-path shapes (head dim 64) the
// logits work is 4*Nq*Nk*D operations against (2*Nq + 2*Nk)*D elements of
// traffic, far above the card's ops-per-byte ridge, so the bound is the
// arithmetic rate. What the design does about it: logits and probabilities
// never leave the SM (the TPU kernel's VMEM scratch becomes registers and
// shared memory), each 64x64 logit tile reuses a staged q tile against a
// staged k tile 64 times, and the (B, H, N, D) operands are read through
// their strides so a caller's (B, N, H, D) projection output needs no
// transpose. bf16 operands (the serving path) multiply on the tensor cores
// with mma.sync, the probabilities passing from the logit accumulators to
// P @ V in registers; f32 operands multiply on the CUDA cores (67 TFLOP/s).
// Without wgmma, TMA or cp.async double buffering the bf16 path stays well
// below the 989 TFLOP/s tensor-core peak; those are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (alphafold2_tpu_torch/ops/cuda/build.py). Bound with ctypes.
//
// Training uses af2_fused_attention_lse, which also writes each row's
// logsumexp for the backward kernels (K3a/K3b, fused_attention_bwd.cu), as the
// TPU path's `_kernel` does beside `_kernel_no_lse` (:110-120).

#include "attention_tile.cuh"

namespace {

template <int D>
cudaError_t dispatch_dtype(int dtype, const af2::Problem& p, cudaStream_t stream) {
  if (dtype == 0) return af2::launch_attention<float, D>(p, stream);
  if (dtype == 1) return af2::launch_attention<__nv_bfloat16, D>(p, stream);
  return cudaErrorInvalidValue;
}

int run(int dtype, const void* q, const void* k, const void* v, void* out, float* lse,
        const unsigned char* q_mask, const unsigned char* kv_mask, const long long* strides,
        int batch, int heads, int nq, int nk, int head_dim, float sm_scale, void* stream) {
  af2::Problem p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.lse = lse;
  p.q_mask = q_mask;
  p.kv_mask = kv_mask;
  p.tie_scale = nullptr;
  af2::Operand* ops[4] = {&p.qs, &p.ks, &p.vs, &p.os};
  for (int t = 0; t < 4; ++t) {
    ops[t]->sb = strides[3 * t];
    ops[t]->sh = strides[3 * t + 1];
    ops[t]->sn = strides[3 * t + 2];
    ops[t]->sr = 0;
  }
  p.batch = batch;
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.features = head_dim;
  p.fd = head_dim;
  p.out_chunks = 1;
  p.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return dispatch_dtype<16>(dtype, p, s);
    case 32: return dispatch_dtype<32>(dtype, p, s);
    case 64: return dispatch_dtype<64>(dtype, p, s);
    case 128: return dispatch_dtype<128>(dtype, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides, (batch, head, token) for q, k, v and out in
// that order; the head-dim stride must be 1. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int af2_fused_attention(int dtype, const void* q, const void* k, const void* v,
                                   void* out, const unsigned char* q_mask,
                                   const unsigned char* kv_mask, const long long* strides,
                                   int batch, int heads, int nq, int nk, int head_dim,
                                   float sm_scale, void* stream) {
  return run(dtype, q, k, v, out, nullptr, q_mask, kv_mask, strides, batch, heads, nq, nk,
             head_dim, sm_scale, stream);
}

// The training forward: as af2_fused_attention, and also writes each query
// row's logsumexp into lse, a contiguous (batch, heads, nq) f32 buffer.
extern "C" int af2_fused_attention_lse(int dtype, const void* q, const void* k, const void* v,
                                       void* out, float* lse, const unsigned char* q_mask,
                                       const unsigned char* kv_mask, const long long* strides,
                                       int batch, int heads, int nq, int nk, int head_dim,
                                       float sm_scale, void* stream) {
  return run(dtype, q, k, v, out, lse, q_mask, kv_mask, strides, batch, heads, nq, nk,
             head_dim, sm_scale, stream);
}
