// The Hopper (sm_90a) building blocks shared by K1's forward
// (fused_attention_sm90.cuh, fused_attention_packed_sm90.cuh), K3a/K3b's backward
// (fused_attention_bwd_sm90.cuh) and the kernels built on them (K2, K4, K5):
// mbarriers with a spin limit, 4-D and 5-D TMA loads, wgmma with
// shared-memory descriptors, and on the host the tensor maps over the
// callers' strided (B, H, N, D) bf16 views and their row-grouped 5-D
// counterparts.
//
// Tiles land in shared memory as chunks of rows of SWB bytes (SWB = 128 for
// a 64-column bf16 chunk, 64 for a 32-column one), swizzled by TMA at the
// same span; the descriptors below read them back in that layout.

#pragma once

#include <cuda.h>

#include "attention_tile.cuh"

namespace af2 {
namespace sm90 {

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. A wait
// that outlasts kSpinLimit polls traps (the launch fails with an error)
// rather than hang the card: no stage of these pipelines waits that long.
constexpr uint32_t kSpinLimit = 1u << 26;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == kSpinLimit) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// K2's (B, R, N, H, D) operands: one box spans the R rows of a token tile
// (tied_row_attention_sm90.cuh).
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins an accumulator register after wgmma_wait_all: no read of it may
// move above the wait.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Orders this thread's generic-proxy accesses to shared memory before later
// async-proxy ones (TMA writes, wgmma reads) to the same bytes: a stage a
// consumer staged its output in is then safe to refill.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout in bits 62-63 (1: 128B, 2: 64B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// The descriptor's swizzle layout for rows of SWB bytes: 1 (128B), 2 (64B).
template <int SWB>
struct SwizzleLayout {
  static_assert(SWB == 128 || SWB == 64, "128- or 64-byte swizzled rows");
  static constexpr int value = SWB == 128 ? 1 : 2;
};

// K-major operand (rows whose contiguous axis is the product's depth: q, k
// in q.k^T): rows of SWB bytes, 8-row swizzle atoms SBO apart; the leading
// offset is unused for swizzled K-major layouts (1 by convention).
template <int SWB>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return make_desc(addr, 16, 8 * SWB, SwizzleLayout<SWB>::value);
}

// MN-major operand (a token-major tile read transposed, as v in P @ V): the
// depth is the token axis, in 8-row groups 8*SWB apart. One product spans
// one swizzle atom along the head dim, so the leading offset (the stride
// between atoms along it) is never stepped; it is given the same value so
// the descriptor reads the same either way.
template <int SWB>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return make_desc(addr, 8 * SWB, 8 * SWB, SwizzleLayout<SWB>::value);
}

// wgmma m64nNk16, f32 += bf16 * bf16. wgmma_ss: A and B from shared memory,
// both K-major. wgmma_rs: A from registers (the mma.m16n8k16 A fragment of
// each warp's 16 rows), B from shared memory, transposed (MN-major).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// ---------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda).
__host__ inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// TMA (and the epilogues' vector stores) can address a (B, H, N, D) bf16
// view when its base is 16-byte aligned and every stride of an axis longer
// than 1 is a positive multiple of 8 elements (16 bytes) below 2^39.
__host__ inline bool stride_ok(long long s, int extent) {
  return extent == 1 || (s > 0 && s % 8 == 0 && s < (1LL << 39));
}

__host__ inline bool tma_operand(const void* ptr, const Operand& op, int batch, int heads,
                                 int n) {
  return aligned16(ptr) && stride_ok(op.sb, batch) && stride_ok(op.sh, heads) &&
         stride_ok(op.sn, n);
}

// Can TMA address an operand of `n` tokens and `rows` row groups (K2's
// layout, or a head dim read as rows): as tma_operand, and the row-group
// stride too.
__host__ inline bool rows_operand(const void* ptr, const Operand& op, int batch, int heads,
                                  int n, int rows) {
  return tma_operand(ptr, op, batch, heads, n) && stride_ok(op.sr, rows);
}

// The tensor map of one (B, H, N, d) bf16 operand: dims (d, N, H, B), box
// (cw, rows, 1, box_batch) with cw = min(d, 64) columns, swizzled at cw * 2
// bytes (128 at d >= 64, 64 at d = 32). One copy lands the rows of
// box_batch batch entries one after another (K1's packed kernel takes whole
// short problems so). An axis of extent 1 gets its contiguous stride (its
// own is never used).
__host__ inline bool encode_bf16(CUtensorMap* map, const void* ptr, const Operand& op, int batch,
                                 int heads, int n, int d, int box_rows, int box_batch = 1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int cw = d < 64 ? d : 64;
  const int extent[3] = {n, heads, batch};
  const long long given[3] = {op.sn, op.sh, op.sb};
  const long long contiguous[3] = {d, (long long)n * d, (long long)heads * n * d};
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = (cuuint64_t)((extent[i] == 1 ? contiguous[i] : given[i]) * 2);
  const cuuint32_t box[4] = {(cuuint32_t)cw, (cuuint32_t)box_rows, 1, (cuuint32_t)box_batch};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            cw * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The 5-D tensor map of one bf16 operand whose feature axis is R rows of d
// (K2's (B, R, N, H, D) layout, or a (B, H, N, R*d) view read as rows),
// through its element strides: dims {d, H, N, R, B}, box {cw, 1, 64,
// box_rows, 1} with cw = min(d, 64), swizzled at cw * 2 bytes. One copy of
// box_rows = R lands a 64-token tile as R K-major chunks of 64 x cw. An
// axis of extent 1 gets its contiguous stride (its own is never used).
__host__ inline bool encode_rows(CUtensorMap* map, const void* ptr, const Operand& op, int batch,
                                 int heads, int n, int rows, int d, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int cw = d < 64 ? d : 64;
  const int extent[4] = {heads, n, rows, batch};
  const long long given[4] = {op.sh, op.sn, op.sr, op.sb};
  const long long contiguous[4] = {d, (long long)heads * d, (long long)n * heads * d,
                                   (long long)rows * n * heads * d};
  const cuuint64_t dims[5] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)n,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  cuuint64_t strides[4];
  for (int i = 0; i < 4; ++i)
    strides[i] = (cuuint64_t)((extent[i] == 1 ? contiguous[i] : given[i]) * 2);
  const cuuint32_t box[5] = {(cuuint32_t)cw, 1, 64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            cw * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace af2
