// X's counterpart, the valid form: o = 2 * x over a (rows, n) f32 array, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel alphafold2_tpu/analysis/lowering.py
// `case_negative_control` (:257, pallas_call :267): the body
// `o_ref[...] = x_ref[...] * 2.0` on a (4, 512) f32 array, grid (4,), one
// (1, 512) row block per step. That kernel exists to be refused (Mosaic
// rejects the (1, 512) block); its mis-tiled Hopper analogue, which ptxas must
// refuse, is scale_rows_mistiled.cu beside this file. This form is the one
// that builds: one block per row, one thread per element, so X's shape is 4
// blocks of 512 threads. Doubling is exact in f32, so the kernel equals its
// plain version (ops/cuda/controls.py) bit for bit.
//
// What bounds it on the H100: 8 bytes of traffic per element and one
// multiply, so bytes; at X's 16 KiB the launch itself sets the time. The
// design does nothing about it: the kernel is a control, not a hot path.
//
// The same kernel launched with more than 1024 threads a block (a (1, 2048)
// array) must be refused by the card with cudaErrorInvalidConfiguration: the
// launch-level control, raised by the wrapper.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (alphafold2_tpu_torch/ops/cuda/build.py). Bound with ctypes.

#include "../launch_plan.cuh"

namespace {

__global__ void scale_rows(const float* __restrict__ x, float* __restrict__ o, int n) {
  const long long i = (long long)blockIdx.x * n + threadIdx.x;
  o[i] = 2.f * x[i];
}

// One block per row, one thread per element; the card, not the plan, refuses
// a row longer than a block can hold.
Af2LaunchPlan plan_launch(int rows, int n) {
  Af2LaunchPlan plan{};
  plan.blocks = rows;
  plan.threads = n;
  plan.dynamic_smem = 0;
  af2::name_kernel(plan, "scale_rows");
  return plan;
}

}  // namespace

// x, o: contiguous (rows, n) f32 on the device. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int af2_scale_rows(const float* x, float* o, int rows, int n, void* stream) {
  const Af2LaunchPlan plan = plan_launch(rows, n);
  if (!af2::grid_fits(plan)) return cudaErrorInvalidConfiguration;
  scale_rows<<<(unsigned)plan.blocks, plan.threads, plan.dynamic_smem,
               static_cast<cudaStream_t>(stream)>>>(x, o, n);
  return cudaGetLastError();
}

// The launch plan at one shape; touches no device. Returns 0.
extern "C" int af2_scale_rows_plan(int rows, int n, Af2LaunchPlan* plan) {
  *plan = plan_launch(rows, n);
  return 0;
}

extern "C" const char* af2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
