// Device code shared by the weight-only int8 and int4 dequant-matmul kernels
// (sm_90a): conversion of int8 and int4 weights to bf16, the block's
// reduction of its warps' partial sums, and the deterministic split-K pass.
//
// Both kernels compute the transposed product out^T = W^T . x^T with
// mma.sync m16n8k16 (bf16 in, f32 accumulate): W^T is the A operand (16
// output columns x 16 contraction rows), x^T the B operand (16 contraction
// rows x 8 rows of x), so the at most 8 or 16 rows of a decode step fill the
// narrow side of the tile. A lane (lane = 4 * g + q) holds A rows g and g + 8
// and contraction rows 2q, 2q + 1, 2q + 8, 2q + 9. The A rows map to output
// columns so that a lane's columns are contiguous in memory across its tiles:
// row g of tile j is column 16 g + 2 j (int8, 8 tiles) or 8 g + 2 j (int4, 4
// tiles), row g + 8 the next column. Each lane then loads its weights with
// one 16-byte (int8) or 8-byte (int4) load per contraction row, eight lanes
// cover 128 or 64 neighbouring bytes of a row, and no weight passes through
// shared memory.

#pragma once

#include "flash_attention_common.cuh"  // mma_16816, NUM_WARPS, NUM_THREADS

namespace {

// Contraction rows a warp loads at once: 4 mma k-steps of 16.
constexpr int CHUNK_ROWS = 64;
constexpr int CHUNK_STEPS = CHUNK_ROWS / 16;

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bits_bf162(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// Word i of a 16-byte load (i is a constant once the loops are unrolled, so
// the load stays in registers).
__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The bytes at position p (0..3) of two words side by side: [a_p, -, b_p, -].
__device__ __forceinline__ uint32_t pair_bytes(uint32_t a, uint32_t b, int p) {
  return __byte_perm(a, b, p | ((p + 4) << 8));
}

// Two int8 weights, the low bytes of the two 16-bit halves of `pair`, to an
// exact bf16x2. bf16 0x4300 | m is 128 + m for m < 128, so with m = b & 127
// and the sign bit moved into the subtrahend (0x4300 = 128, 0x4380 = 256)
// the difference is b exactly: b >= 0 gives 128 + b - 128, b < 0 gives
// 128 + (b + 128) - 256.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t pair) {
  const uint32_t mag = (pair & 0x007F007Fu) | 0x43004300u;
  const uint32_t off = (pair & 0x00800080u) | 0x43004300u;
  return bf162_bits(__hsub2(bits_bf162(mag), bits_bf162(off)));
}

// Two int4 weights, the low nibbles of the low bytes of the two halves of
// `pair` (two's complement), to an exact bf16x2: (128 + (v & 7)) - (128 + (v & 8)).
__device__ __forceinline__ uint32_t int4x2_to_bf16x2(uint32_t pair) {
  const uint32_t mag = (pair & 0x00070007u) | 0x43004300u;
  const uint32_t off = (pair & 0x00080008u) | 0x43004300u;
  return bf162_bits(__hsub2(bits_bf162(mag), bits_bf162(off)));
}

// x^T fragment of one mma k-step: rows k, k + 1 and k + 8, k + 9 of x's row
// `row` (zero for a row past M: M is padded per tile here, x is not copied).
__device__ __forceinline__ void load_x_frag(uint32_t (&b)[2], const __nv_bfloat16* row, bool valid,
                                            int k) {
  b[0] = valid ? __ldg(reinterpret_cast<const unsigned int*>(row + k)) : 0u;
  b[1] = valid ? __ldg(reinterpret_cast<const unsigned int*>(row + k + 8)) : 0u;
}

// Sum the NUM_WARPS warps' [TILES x MT] C fragments of a block (each warp
// covered its own contraction slice) in a fixed order and write the block's
// [8 MT, 16 TILES] f32 partial for its split. `red` is shared memory of
// NUM_WARPS * 8 MT * (16 TILES + 4) floats.
template <int TILES, int MT>
__device__ __forceinline__ void block_partial_store(float* red, const float (&c)[TILES][MT][4],
                                                    float* partial, int split, int m0, int n0, int M,
                                                    int N) {
  constexpr int BN = 16 * TILES;
  constexpr int LD = BN + 4;
  constexpr int BM = 8 * MT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int q = lane & 3;
  float* mine = red + warp * BM * LD;
#pragma unroll
  for (int j = 0; j < TILES; ++j) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int n = (BN / 8) * g + 2 * j;
      const int m = 8 * mt + 2 * q;
      mine[m * LD + n] = c[j][mt][0];
      mine[(m + 1) * LD + n] = c[j][mt][1];
      mine[m * LD + n + 1] = c[j][mt][2];
      mine[(m + 1) * LD + n + 1] = c[j][mt][3];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += NUM_THREADS) {
    const int m = idx / BN;
    const int n = idx % BN;
    if (m0 + m < M && n0 + n < N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NUM_WARPS; ++w) s += red[(w * BM + m) * LD + n];
      partial[(static_cast<int64_t>(split) * M + m0 + m) * N + n0 + n] = s;
    }
  }
}

// out[m, n] = bf16(sum over splits of partial[s, m, n], in split order,
// times scale[n] when scale is given). Deterministic: no atomics.
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                                     int64_t total, int N, int splits) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[sp * total + idx];
  if (scale != nullptr) s *= scale[idx % N];
  out[idx] = __float2bfloat16_rn(s);
}

inline cudaError_t launch_splitk_reduce(const float* partial, const float* scale,
                                        __nv_bfloat16* out, int M, int N, int splits,
                                        cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(M) * N;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  splitk_reduce_kernel<<<blocks, threads, 0, stream>>>(partial, scale, out, total, N, splits);
  return cudaGetLastError();
}

}  // namespace
