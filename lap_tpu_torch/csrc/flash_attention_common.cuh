// Device helpers shared by the flash-attention forward and backward kernels
// (sm_90a): cp.async copies into XOR-swizzled shared tiles, ldmatrix loads
// and the mma.sync m16n8k16 bf16 product with f32 accumulation.
//
// Fragment layout of m16n8k16 (lane = 4 * g + t): a C tile holds rows g and
// g + 8, columns 2t and 2t + 1; two neighbouring C tiles (16 columns) re-pack
// as one A fragment of the next product without leaving registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr float MASK_VALUE = -2.3819763e38f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes == 0 writes zeros (rows past the end).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b for one 16x8x16 tile (a row-major 16x16, b col-major 16x8).
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Offset, in 16-byte chunks, of (row, chunk) in a swizzled tile of H columns.
template <int H>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * (H / 8) + (chunk ^ (row & 7));
}

// Async copy of rows [row0, row0 + BLOCK) of a [rows, H] bf16 matrix with
// row stride `stride` (elements) into a swizzled shared tile, by a block of
// THREADS threads.
template <int H, int ROWS, int THREADS = NUM_THREADS>
__device__ __forceinline__ void load_tile(uint4* tile, const __nv_bfloat16* base, int64_t stride,
                                          int row0, int rows) {
  constexpr int CHUNKS = H / 8;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    const bool valid = row0 + r < rows;
    const __nv_bfloat16* src = valid ? base + (row0 + r) * stride + c * 8 : base;
    cp_async_16(smem_addr(tile + swz<H>(r, c)), src, valid ? 16 : 0);
  }
}


// The A fragment of a product over columns [16 * kk, 16 * kk + 16) of a
// C-fragment row block, rounded to bf16.
template <int TILES>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[TILES][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

}  // namespace
