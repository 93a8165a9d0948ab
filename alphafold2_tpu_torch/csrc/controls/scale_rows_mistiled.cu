// X's counterpart, the mis-tiled form: a kernel ptxas must refuse to build.
//
// The Hopper analogue of the TPU kernel alphafold2_tpu/analysis/lowering.py
// `case_negative_control` (:257, pallas_call :267), whose (1, 512) row block
// on a (4, 512) f32 array Mosaic's tiling checks reject. Here the same
// function, o = 2 * x, stages a whole (32, 512) f32 row tile in a *static*
// __shared__ array: 64 KiB, over the 48 KiB a kernel may declare statically
// (more needs dynamic shared memory and cudaFuncSetAttribute, as every kernel
// of this package does). ptxas refuses it with
//     uses too much shared data (0x10000 bytes, 0xc000 max)
// and the Hopper build gate (alphafold2_tpu_torch/analysis/lowering.py,
// case negative_control_rejects_bad_tiling) requires exactly that refusal: if
// this file ever builds, the gate is not checking what it claims to.
//
// This file is never built by ops/cuda/build.py's build_all; only the gate
// compiles it, expecting failure.

#include "../launch_plan.cuh"

namespace {

constexpr int kTileRows = 32;
constexpr int kTileCols = 512;

__global__ void scale_rows_mistiled(const float* __restrict__ x, float* __restrict__ o,
                                    int rows) {
  __shared__ float tile[kTileRows][kTileCols];  // 65,536 bytes, static
  const int r0 = blockIdx.x * kTileRows;
  for (int e = threadIdx.x; e < kTileRows * kTileCols; e += blockDim.x) {
    const int r = r0 + e / kTileCols;
    tile[e / kTileCols][e % kTileCols] = r < rows ? x[(long long)r * kTileCols + e % kTileCols]
                                                  : 0.f;
  }
  __syncthreads();
  // each thread writes the element after the one it staged, which another
  // thread staged: the tile has to live in shared memory
  for (int e = threadIdx.x; e < kTileRows * kTileCols; e += blockDim.x) {
    const int f = (e + 1) % (kTileRows * kTileCols);
    const int r = r0 + f / kTileCols;
    if (r < rows) o[(long long)r * kTileCols + f % kTileCols] = 2.f * tile[f / kTileCols][f % kTileCols];
  }
}

}  // namespace

extern "C" int af2_scale_rows_mistiled(const float* x, float* o, int rows, void* stream) {
  scale_rows_mistiled<<<(rows + kTileRows - 1) / kTileRows, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, o, rows);
  return cudaGetLastError();
}
