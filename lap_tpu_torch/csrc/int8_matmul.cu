// Weight-only int8 dequant matmul for Hopper (sm_90a): bf16 x, int8 weights
// with per-output-channel f32 scales, bf16 out.
//
// Replaces the Pallas TPU kernel lap_tpu/ops/int8_matmul.py:_kernel (launched
// by int8_matmul). It computes the same function:
//   out[m, n] = bf16( (sum_k x[m, k] * w[k, n]) * scale[n] )
// with the int8 weights converted to bf16 exactly (|w| <= 127), the sum in
// f32, and the scale applied once to the f32 sum; the scale is never folded
// into a bf16 weight.
//
// What bounds it on the H100: bytes. The callers pass at most 128 rows (one
// AR token, or 16 flow-suffix rows per request), so a call does at most
// 2 * 128 flops per weight byte, below the card's ~295 flop/byte bf16 ridge,
// and at 1 or 16 rows far below it. The least time is the weight's K * N
// bytes (plus x, scale and out) at 3.35 TB/s.
//
// Design (a simple, correct first version; cp.async/TMA pipelining and wgmma
// come later):
// - the product is computed transposed, out^T = W^T . x^T, with bf16
//   mma.sync m16n8k16 and f32 accumulation: the weight is the 16-wide A side
//   and x the 8-wide B side, so 1 to 8 rows take one B tile and 9 to 16 two;
//   more rows take more blocks along grid z (each re-reads the weight);
// - the weight is read once, coalesced, straight into registers: a lane
//   loads 16 neighbouring output columns of a contraction row in one
//   16-byte load, eight lanes cover 128 bytes of the row; the A rows of the
//   mma are mapped to those columns (dequant_matmul_common.cuh). A warp
//   issues the 16 loads of 64 contraction rows before it converts any;
// - conversion to bf16 without the slow int-to-float unit: the byte is
//   spliced into the mantissa of bf16 128.0 and the sign moved into the
//   subtrahend (one byte permute, two logic ops and one bf16x2 subtract per
//   two weights, all exact);
// - a block of 4 warps owns 128 output columns and up to 16 rows; its warps
//   take consecutive slices of the contraction axis and their partial sums
//   meet in shared memory in a fixed order. The Pallas grid carries the
//   accumulator along K in VMEM; here K is also split across blocks
//   (split-K) until the grid has two blocks per SM, since 128-column tiles of
//   an N = 2048 weight give only 16 blocks for 132 SMs. A second pass adds
//   the splits in order, applies the scale and casts: the same inputs give
//   the same bits on every run (no atomics);
// - ragged edges: rows past M are zero in registers, columns past N are
//   skipped (N must be a multiple of 16, the vocab head's 257,152 is 128 *
//   2009); K must be a multiple of 256 (a block's 4 warps x 64 rows), which
//   every quantized weight of LAP-3B is. The wrapper raises otherwise.

#include "dequant_matmul_common.cuh"

namespace {

constexpr int TILES = 8;  // 16-column mma tiles per warp: 128 columns, one 16-byte load a lane
constexpr int BLOCK_N = 16 * TILES;

template <int MT>
__global__ void __launch_bounds__(NUM_THREADS)
    int8_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                       float* __restrict__ partial, int M, int N, int K, int k_per_block) {
  __shared__ float red[NUM_WARPS * 8 * MT * (BLOCK_N + 4)];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int n0 = blockIdx.x * BLOCK_N;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * 8 * MT;
  const int k_per_warp = k_per_block / NUM_WARPS;
  const int k_begin = split * k_per_block + warp * k_per_warp;

  const int col = n0 + 16 * g;  // this lane's 16 columns
  const bool col_ok = col < N;
  const __nv_bfloat16* xrow[MT];
  bool row_ok[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = m0 + 8 * mt + g;
    row_ok[mt] = m < M;
    xrow[mt] = x + static_cast<int64_t>(row_ok[mt] ? m : 0) * K;
  }

  float c[TILES][MT][4];
#pragma unroll
  for (int j = 0; j < TILES; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][mt][e] = 0.f;

  for (int kc = k_begin; kc < k_begin + k_per_warp; kc += CHUNK_ROWS) {
    // Contraction rows 2q, 2q + 1, 2q + 8, 2q + 9 of each 16-row step.
    uint4 raw[CHUNK_STEPS][4];
#pragma unroll
    for (int s = 0; s < CHUNK_STEPS; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = kc + 16 * s + 2 * q + (r & 1) + 8 * (r >> 1);
        raw[s][r] = col_ok ? __ldg(reinterpret_cast<const uint4*>(w + static_cast<int64_t>(k) * N + col))
                           : make_uint4(0, 0, 0, 0);
      }
    uint32_t b[CHUNK_STEPS][MT][2];
#pragma unroll
    for (int s = 0; s < CHUNK_STEPS; ++s)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) load_x_frag(b[s][mt], xrow[mt], row_ok[mt], kc + 16 * s + 2 * q);

#pragma unroll
    for (int s = 0; s < CHUNK_STEPS; ++s) {
#pragma unroll
      for (int j = 0; j < TILES; ++j) {
        // Tile j: A row g is column byte 2j of the lane's 16, row g + 8 byte 2j + 1.
        const int p = 2 * (j & 1);
        const uint32_t w0 = word_of(raw[s][0], j >> 1);
        const uint32_t w1 = word_of(raw[s][1], j >> 1);
        const uint32_t w2 = word_of(raw[s][2], j >> 1);
        const uint32_t w3 = word_of(raw[s][3], j >> 1);
        uint32_t a[4];
        a[0] = int8x2_to_bf16x2(pair_bytes(w0, w1, p));
        a[1] = int8x2_to_bf16x2(pair_bytes(w0, w1, p + 1));
        a[2] = int8x2_to_bf16x2(pair_bytes(w2, w3, p));
        a[3] = int8x2_to_bf16x2(pair_bytes(w2, w3, p + 1));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_16816(c[j][mt], a, b[s][mt][0], b[s][mt][1]);
      }
    }
  }
  block_partial_store<TILES, MT>(red, c, partial, split, m0, n0, M, N);
}

template <int MT>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* w, float* partial, int M, int N, int K,
                   int splits, cudaStream_t stream) {
  const dim3 grid((N + BLOCK_N - 1) / BLOCK_N, splits, (M + 8 * MT - 1) / (8 * MT));
  int8_matmul_kernel<MT><<<grid, NUM_THREADS, 0, stream>>>(x, w, partial, M, N, K, K / splits);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16, w [K, N] int8, scale [N] f32, partial [splits, M, N] f32
// scratch, out [M, N] bf16; all contiguous. Returns the first CUDA error.
extern "C" int int8_matmul(const void* x, const void* w, const void* scale, void* partial,
                           void* out, int M, int N, int K, int splits, void* stream) {
  if (M < 1 || N % 16 || splits < 1 || K % (splits * NUM_WARPS * CHUNK_ROWS)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const int8_t*>(w);
  auto* pf = static_cast<float*>(partial);
  cudaError_t err = M <= 8 ? launch<1>(xb, wb, pf, M, N, K, splits, s)
                           : launch<2>(xb, wb, pf, M, N, K, splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_splitk_reduce(pf, static_cast<const float*>(scale),
                                               static_cast<__nv_bfloat16*>(out), M, N, splits, s));
}
