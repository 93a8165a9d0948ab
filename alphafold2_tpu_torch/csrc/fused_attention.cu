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
// arithmetic rate. The plan picks one of three kernels, by dtype, head dim
// and alignment alone (never by retrying a failed launch):
//
// * bf16 at head dim 32, 64 or 128 with fewer than 64 queries and keys
//   and operands TMA can describe: attention_packed_kernel_sm90
//   (fused_attention_packed_sm90.cuh): G = min(2 floor(64/nq), floor(128/nk))
//   problems of one head packed into one 128 x 128 tile under a
//   block-diagonal mask, persistent blocks walking the tiles. The template
//   axis and the MSA column passes take it.
// * any other bf16 problem at head dim 32, 64 or 128 with operands TMA can
//   describe (16-byte aligned bases, strides of 8 elements):
//   attention_kernel_sm90 (fused_attention_sm90.cuh): TMA-fed K/V ring,
//   wgmma, skipped masked tiles, and where the grid is short of two waves a
//   split over the key axis merged by combine_kernel. The other seven
//   main-path passes take it.
// * any other bf16 problem: attention_kernel_mma (attention_tile.cuh,
//   mma.sync on tiles staged by ordinary loads), which K2 also runs.
// * f32: attention_kernel on the CUDA cores, the exactness path of the
//   small-model checks.
//
// A bf16 head dim past 128 that is a multiple of 64 never reaches this
// file: the wrapper (ops/cuda/axial.py) runs it on K2's kernels
// (tied_row_attention.cu's strided entry, whose plan takes the Hopper walk
// where TMA can describe the operands), the head dim read as R = D/64 rows
// of 64 features under tie scale 1, as K3a/K3b have run it since their
// Hopper port. Any other head dim past 128 (f32, a head dim that is not a
// multiple of 64) runs the tile kernels here D-chunked, as K2 runs its
// fused R*D axis: one block per 64-wide output chunk, the logits
// accumulated over 64-wide feature chunks (attention_tile.cuh). Head dims
// below 128 that no kernel is built for are zero-padded up to the next one
// by the caller, which is exact.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (alphafold2_tpu_torch/ops/cuda/build.py). Bound with ctypes.
//
// Training uses af2_fused_attention_lse, which also writes each row's
// logsumexp for the backward kernels (K3a/K3b, fused_attention_bwd.cu), as the
// TPU path's `_kernel` does beside `_kernel_no_lse` (:110-120).

#include "attention_tile.cuh"
#include "fused_attention_packed_sm90.cuh"
#include "fused_attention_sm90.cuh"

namespace {

template <int D>
cudaError_t dispatch_dtype(int dtype, const af2::Problem& p, cudaStream_t stream,
                           Af2LaunchPlan* plan_out) {
  if (dtype == 0) return af2::launch_attention<float, D>(p, stream, plan_out);
  if (dtype == 1) return af2::launch_attention<__nv_bfloat16, D>(p, stream, plan_out);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t dispatch_sm90(const af2::Problem& p, int splits, float* partials,
                          cudaStream_t stream, Af2LaunchPlan* plan_out) {
  if (plan_out != nullptr) {
    *plan_out = af2::sm90::plan_attention<D>(p, splits);
    return cudaSuccess;
  }
  return af2::sm90::launch_attention<D>(p, splits, partials, stream);
}

template <int D>
cudaError_t dispatch_packed(const af2::Problem& p, cudaStream_t stream,
                            Af2LaunchPlan* plan_out) {
  if (plan_out != nullptr) {
    *plan_out = af2::sm90::packed::plan_packed<D>(p.batch, p.heads, p.nq, p.nk);
    return cudaSuccess;
  }
  return af2::sm90::packed::launch_packed<D>(p, stream);
}

// Launches K1, or with `plan_out` only fills its plan (strides may then be
// null, no pointer is read, and `aligned` stands for the operands'
// alignment; a launch finds it from the pointers and strides).
// `splits` is ops/cuda/axial.py key_splits() of the shape:
// attention_kernel_sm90 takes it as given, the others run whole (it is 1
// on every shape the packed kernel takes). `info`, when given, receives
// {1 if a Hopper kernel ran (attention_kernel_sm90 or the packed one), the
// splits run, 1 if the packed kernel ran}; with more than one split, the
// partials are in `partials` and the caller launches
// af2_fused_attention_combine next.
int run(int dtype, const void* q, const void* k, const void* v, void* out, float* lse,
        const unsigned char* q_mask, const unsigned char* kv_mask, const long long* strides,
        int batch, int heads, int nq, int nk, int head_dim, float sm_scale, int splits,
        float* partials, int* info, void* stream, Af2LaunchPlan* plan_out = nullptr,
        int aligned = 0) {
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
    ops[t]->sb = strides != nullptr ? strides[3 * t] : 0;
    ops[t]->sh = strides != nullptr ? strides[3 * t + 1] : 0;
    ops[t]->sn = strides != nullptr ? strides[3 * t + 2] : 0;
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
  if (splits < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sm90 = dtype == 1 && (head_dim == 32 || head_dim == 64 || head_dim == 128) &&
                    (plan_out != nullptr ? aligned != 0 : af2::sm90::takes(p));
  const bool packed = sm90 && af2::sm90::packed::takes_shape(head_dim, nq, nk);
  if (info != nullptr) {
    info[0] = sm90 ? 1 : 0;
    info[1] = sm90 && !packed ? splits : 1;
    info[2] = packed ? 1 : 0;
  }
  if (packed) {
    switch (head_dim) {
      case 32: return dispatch_packed<32>(p, s, plan_out);
      case 64: return dispatch_packed<64>(p, s, plan_out);
      default: return dispatch_packed<128>(p, s, plan_out);
    }
  }
  if (sm90) {
    switch (head_dim) {
      case 32: return dispatch_sm90<32>(p, splits, partials, s, plan_out);
      case 64: return dispatch_sm90<64>(p, splits, partials, s, plan_out);
      default: return dispatch_sm90<128>(p, splits, partials, s, plan_out);
    }
  }
  switch (head_dim) {
    case 16: return dispatch_dtype<16>(dtype, p, s, plan_out);
    case 32: return dispatch_dtype<32>(dtype, p, s, plan_out);
    case 64: return dispatch_dtype<64>(dtype, p, s, plan_out);
    case 128: return dispatch_dtype<128>(dtype, p, s, plan_out);
    default:
      if (head_dim <= 128) return cudaErrorInvalidValue;
      p.out_chunks = (head_dim + 63) / 64;
      return dispatch_dtype<64>(dtype, p, s, plan_out);
  }
}

// The combine pass, or with `plan_out` only its plan.
int combine(const float* partials, void* out, float* lse, const unsigned char* q_mask,
            const long long* out_strides, int batch, int heads, int nq, int head_dim,
            int splits, void* stream, Af2LaunchPlan* plan_out = nullptr) {
  if (plan_out != nullptr) {
    switch (head_dim) {
      case 32: *plan_out = af2::sm90::plan_combine<32>(batch, heads, nq); return cudaSuccess;
      case 64: *plan_out = af2::sm90::plan_combine<64>(batch, heads, nq); return cudaSuccess;
      case 128: *plan_out = af2::sm90::plan_combine<128>(batch, heads, nq); return cudaSuccess;
      default: return cudaErrorInvalidValue;
    }
  }
  af2::sm90::CombineParams c;
  c.part = partials;
  c.out = out;
  c.lse = lse;
  c.q_mask = q_mask;
  c.osb = out_strides[0];
  c.osh = out_strides[1];
  c.osn = out_strides[2];
  c.batch = batch;
  c.heads = heads;
  c.nq = nq;
  c.splits = splits;
  if (splits < 1 || !af2::aligned16(out) ||
      !af2::sm90::stride_ok(c.osb, batch) || !af2::sm90::stride_ok(c.osh, heads) ||
      !af2::sm90::stride_ok(c.osn, nq))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return af2::sm90::launch_combine<32>(c, s);
    case 64: return af2::sm90::launch_combine<64>(c, s);
    case 128: return af2::sm90::launch_combine<128>(c, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides, (batch, head, token) for q, k, v and out in
// that order; the head-dim stride must be 1. dtype: 0 = float32, 1 = bfloat16.
// splits, partials, info (3 ints out): as `run`. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int af2_fused_attention(int dtype, const void* q, const void* k, const void* v,
                                   void* out, const unsigned char* q_mask,
                                   const unsigned char* kv_mask, const long long* strides,
                                   int batch, int heads, int nq, int nk, int head_dim,
                                   float sm_scale, int splits, float* partials, int* info,
                                   void* stream) {
  return run(dtype, q, k, v, out, nullptr, q_mask, kv_mask, strides, batch, heads, nq, nk,
             head_dim, sm_scale, splits, partials, info, stream);
}

// The training forward: as af2_fused_attention, and also writes each query
// row's logsumexp into lse, a contiguous (batch, heads, nq) f32 buffer (with
// splits, the combine pass writes it).
extern "C" int af2_fused_attention_lse(int dtype, const void* q, const void* k, const void* v,
                                       void* out, float* lse, const unsigned char* q_mask,
                                       const unsigned char* kv_mask, const long long* strides,
                                       int batch, int heads, int nq, int nk, int head_dim,
                                       float sm_scale, int splits, float* partials, int* info,
                                       void* stream) {
  return run(dtype, q, k, v, out, lse, q_mask, kv_mask, strides, batch, heads, nq, nk,
             head_dim, sm_scale, splits, partials, info, stream);
}

// K1's combine pass: merges `splits` partials (as attention_kernel_sm90
// writes them: m (splits, rows), l (splits, rows), acc (splits, rows,
// head_dim), rows = batch * heads * nq, f32) in split order into the bf16
// output (3 element strides, batch, head, token) and, when lse is given,
// the (batch, heads, nq) logsumexp. A masked query row writes 0.
extern "C" int af2_fused_attention_combine(const float* partials, void* out, float* lse,
                                           const unsigned char* q_mask,
                                           const long long* out_strides, int batch, int heads,
                                           int nq, int head_dim, int splits, void* stream) {
  return combine(partials, out, lse, q_mask, out_strides, batch, heads, nq, head_dim, splits,
                 stream);
}

// K1's launch plan at one shape (with or without lse: the same kernel),
// given the splits and whether the operands are TMA-aligned. Touches no
// device. Returns 0, or
// cudaErrorInvalidValue for a dtype, head dim or split count the kernels do
// not take (head dims: 16, 32, 64, 128 and any past 128; past 128 it plans
// this file's D-chunked kernel, which the wrapper keeps for the shapes K2's
// walk does not take).
extern "C" int af2_fused_attention_plan(int dtype, int batch, int heads, int nq, int nk,
                                        int head_dim, int splits, int aligned,
                                        Af2LaunchPlan* plan) {
  return run(dtype, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             batch, heads, nq, nk, head_dim, 1.f, splits, nullptr, nullptr, nullptr, plan,
             aligned);
}

// The combine pass's launch plan (bf16 output).
extern "C" int af2_fused_attention_combine_plan(int batch, int heads, int nq, int head_dim,
                                                Af2LaunchPlan* plan) {
  return combine(nullptr, nullptr, nullptr, nullptr, nullptr, batch, heads, nq, head_dim, 2,
                 nullptr, plan);
}
