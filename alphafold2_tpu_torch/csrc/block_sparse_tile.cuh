// Shared pieces of the block-sparse attention kernels (K4 forward,
// block_sparse_attention.cu; K5a/K5b backward, block_sparse_attention_bwd.cu).
//
// Work unit: a *group* of warps owns R = min(block, 64) consecutive rows of
// one (batch, head) -- query rows in K4 and K5a, key rows in K5b -- and loops
// over that block's own list of active blocks on the other side, R rows of
// it at a time (two steps per block at block 128). Each warp of a group owns
// 16 of its rows (one mma m16 tile); a block of 128 threads holds 64 / R
// groups, so at block 16 one thread block carries four query blocks. The
// groups of a thread block are independent: each synchronises on its own
// named barrier and returns on its own, and never waits for another.
//
// Every product is C += A . B^T with A and B staged row-major in shared
// memory (B's rows are C's columns), C in the mma.sync m16n8 accumulator
// layout: lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8, columns
// 8j + 2t and 8j + 2t + 1 of each 8-column n-tile j. bfloat16 operands
// multiply on the tensor cores (mma.sync m16n8k16, f32 accumulation), and a
// product whose A is an accumulator (P @ V, ds @ K, ...) takes it from the
// registers, rounded to bf16 as the TPU kernels round p and ds. float32
// operands multiply on the CUDA cores in the same layout, passing such an A
// through a 16-row scratch tile of the warp.
//
// An operand element (b, h, n, f) lives at b*sb + h*sh + n*sn + f: q, k, v,
// dO and the outputs are (B, H, N, D) views with a contiguous head dim.

#pragma once

#include "attention_tile.cuh"

namespace af2 {
namespace sparse {

using af2::lds32;
using af2::mma_bf16;
using af2::pack_bf16;
using af2::Operand;

constexpr int kThreads = 128;  // 4 warps per thread block

template <int R>
struct Group {
  static_assert(R == 16 || R == 32 || R == 64, "group rows are 16, 32 or 64");
  static constexpr int kWarps = R / 16;           // warps in a group
  static constexpr int kPerBlock = 4 / kWarps;    // groups in a thread block
  static constexpr int kThreads = 32 * kWarps;    // threads in a group
};

// Elements of T in one 16-byte word; also the row padding of staged tiles,
// which keeps rows 16-byte aligned and column reads off one bank.
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ void group_sync(int group, int threads) {
  // named barrier 1 + group: only this group's warps take part
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(threads) : "memory");
}

__device__ __forceinline__ long long at(const Operand& op, int b, int h, int n) {
  return (long long)b * op.sb + (long long)h * op.sh + (long long)n * op.sn;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Stage ROWS tokens n0.. of an operand in shared memory: token-major with row
// stride ld, or transposed (dst[f * ld + row]). With `vec` every kVec
// consecutive features load as one 16-byte word.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void stage(T* dst, int ld, bool transpose, const T* src,
                                      const Operand& op, int b, int h, int n0, int tid,
                                      int nthreads, bool vec) {
  constexpr int V = kVec<T>;
  for (int e = tid; e < ROWS * (D / V); e += nthreads) {
    const int row = e / (D / V), col = (e % (D / V)) * V;
    const T* p = src + at(op, b, h, n0 + row) + col;
    alignas(16) T x[V];
    if (vec) {
      *reinterpret_cast<uint4*>(x) = *reinterpret_cast<const uint4*>(p);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = p[i];
    }
    if (transpose) {
#pragma unroll
      for (int i = 0; i < V; ++i) dst[(col + i) * ld + row] = x[i];
    } else {
      *reinterpret_cast<uint4*>(dst + row * ld + col) = *reinterpret_cast<uint4*>(x);
    }
  }
}

// c[NT][4] (16 rows x NT*8 columns) += A[16 x K] . B[NT*8 x K]^T; `a` points
// at the warp's first row, `b` at the first column's row.
template <int NT, int K>
__device__ __forceinline__ void mma_smem(float (&c)[NT][4], const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int ldb, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const int kc = kk * 16 + 2 * t;
    const uint32_t af[4] = {lds32(a + g * lda + kc), lds32(a + (g + 8) * lda + kc),
                            lds32(a + g * lda + kc + 8), lds32(a + (g + 8) * lda + kc + 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* br = b + (8 * j + g) * ldb + kc;
      mma_bf16(c[j], af, lds32(br), lds32(br + 8));
    }
  }
}

template <int NT, int K>
__device__ __forceinline__ void mma_smem(float (&c)[NT][4], const float* a, int lda,
                                         const float* b, int ldb, int g, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* ar = a + (g + 8 * (e >> 1)) * lda;
      const float* br = b + (8 * j + 2 * t + (e & 1)) * ldb;
      float s = 0.f;
#pragma unroll 8
      for (int f = 0; f < K; ++f) s = fmaf(ar[f], br[f], s);
      c[j][e] += s;
    }
}

// c[NT][4] += P[16 x KP] . B[NT*8 x KP]^T with P an accumulator p[KP/8][4]
// of this warp. bf16: P goes to the A fragments in registers, rounded to
// bf16. f32: P passes through the warp's scratch tile (16 x (KP + 4)).
template <int NT, int KP>
__device__ __forceinline__ void mma_acc(float (&c)[NT][4], const float (&p)[KP / 8][4],
                                        const __nv_bfloat16* b, int ldb, int g, int t,
                                        __nv_bfloat16* /*scratch*/) {
#pragma unroll
  for (int kk = 0; kk < KP / 16; ++kk) {
    const uint32_t af[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* br = b + (8 * j + g) * ldb + kk * 16 + 2 * t;
      mma_bf16(c[j], af, lds32(br), lds32(br + 8));
    }
  }
}

template <int NT, int KP>
__device__ __forceinline__ void mma_acc(float (&c)[NT][4], const float (&p)[KP / 8][4],
                                        const float* b, int ldb, int g, int t, float* scratch) {
  constexpr int LP = KP + 4;
  __syncwarp();  // the warp's last read of the scratch tile is done
#pragma unroll
  for (int j = 0; j < KP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) scratch[(g + 8 * (e >> 1)) * LP + 8 * j + 2 * t + (e & 1)] = p[j][e];
  __syncwarp();
  mma_smem<NT, KP>(c, scratch, LP, b, ldb, g, t);
}

// Scratch elements a warp needs for mma_acc over KP columns (f32 only).
template <typename T, int KP>
constexpr int kScratch = kIsBf16<T> ? 0 : 16 * (KP + 4);

__device__ __forceinline__ bool key_valid(const unsigned char* kv_mask, int b, int n, int key) {
  return kv_mask == nullptr || kv_mask[(long long)b * n + key] != 0;
}

// 16-byte loads need 16-byte aligned bases and strides in whole words.
template <typename T>
__host__ inline bool vec_ok(std::initializer_list<const void*> ptrs,
                            std::initializer_list<const Operand*> ops) {
  bool ok = true;
  for (const void* p : ptrs) ok = ok && af2::aligned16(p);
  for (const Operand* op : ops)
    ok = ok && op->sb % kVec<T> == 0 && op->sh % kVec<T> == 0 && op->sn % kVec<T> == 0;
  return ok;
}

}  // namespace sparse
}  // namespace af2
