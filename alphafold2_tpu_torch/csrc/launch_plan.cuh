// The launch plan shared by every kernel source of this package.
//
// Each source computes its launch (which template instantiation, how many
// blocks, how many threads, how much dynamic shared memory) in one host
// function. The launch takes its numbers from that plan, and each source also
// exports it as `af2_<source>_plan`, which fills an Af2LaunchPlan for a given
// dtype and shape and touches no device. The Hopper build gate
// (alphafold2_tpu_torch/analysis/lowering.py) calls those entries and holds
// the numbers against sm_90's limits and against ptxas's report of the named
// instantiation, so it checks the arithmetic the launch uses, not a copy.

#pragma once

#include <cstdarg>
#include <cstdio>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Plain C layout: the Python side mirrors it with ctypes (ops/cuda/build.py
// LaunchPlan).
struct Af2LaunchPlan {
  long long blocks;   // one-dimensional grid
  int threads;        // per block, one-dimensional
  int dynamic_smem;   // bytes of dynamic shared memory per block
  char kernel[120];   // the instantiation as cu++filt names it, without its
                      // namespace and argument list, with no spaces:
                      // "fwd_kernel<__nv_bfloat16,16,64>"
  int cluster;        // blocks a thread-block cluster (one-dimensional); 0 for a
                      // launch without the cluster attribute
};

namespace af2 {

template <typename T>
struct TypeName;
template <>
struct TypeName<float> {
  static constexpr const char* value = "float";
};
template <>
struct TypeName<__nv_bfloat16> {
  static constexpr const char* value = "__nv_bfloat16";
};

__host__ inline void name_kernel(Af2LaunchPlan& plan, const char* fmt, ...) {
  va_list args;
  va_start(args, fmt);
  vsnprintf(plan.kernel, sizeof(plan.kernel), fmt, args);
  va_end(args);
}

// The launch itself refuses only a grid it cannot express; every other limit
// is the card's to enforce (and the gate's to check before a card runs it).
__host__ inline bool grid_fits(const Af2LaunchPlan& plan) {
  return plan.blocks > 0 && plan.blocks <= 2147483647LL;
}

}  // namespace af2
