// Weight-only int4 dequant matmul for Hopper (sm_90a): bf16 x, nibble-packed
// int4 weights with group-wise f32 scales, bf16 out.
//
// Replaces the Pallas TPU kernel lap_tpu/ops/int4_matmul.py:_kernel (launched
// by int4_matmul). It computes the same function:
//   out[m, n] = bf16( sum_g (sum_{k in g} x[m, k] * w[k, n]) * scale[g, n] )
// with the nibbles sign-extended and converted to bf16 exactly, f32 partial
// sums, and each group's scale applied to the f32 partial before it joins
// the sum; the scale is never folded into a bf16 weight. Packing: byte
// packed[i, n] holds row i in its low nibble and row K/2 + i in its high
// nibble, so one byte feeds the low half and the high half of K.
//
// What bounds it on the H100: bytes, as for int8 (int8_matmul.cu), at half
// the weight bytes: K * N / 2 plus the scales (K / G * N * 4) at 3.35 TB/s.
// At half the bytes per weight the conversion has half the time per weight,
// so it must stay cheap.
//
// Design (a simple, correct first version; pipelining and wgmma come later):
// - out^T = W^T . x^T with bf16 mma.sync m16n8k16 and f32 accumulation, the
//   weight on the 16-wide A side (dequant_matmul_common.cuh);
// - a lane loads 8 neighbouring packed columns of a packed row in one 8-byte
//   load (eight lanes cover 64 bytes), 16 loads for 64 packed rows before
//   any conversion; the low nibbles feed the mma k-steps of rows [p, p + 64)
//   and the high nibbles those of rows [K/2 + p, K/2 + p + 64), read from
//   the same registers;
// - conversion: the nibble is spliced into the mantissa of bf16 128.0 and
//   its sign bit into the subtrahend (one byte permute, two logic ops and a
//   bf16x2 subtract per two weights, exact);
// - each 64-row slice lies inside one group (the group size is a multiple of
//   64), so a warp scales the f32 sum of each slice by the group's scale
//   before it adds it to its total: the Pallas kernel scales a whole group's
//   partial, this scales the group's 64-row pieces (the same sum in another
//   order);
// - a block of 4 warps owns 64 output columns and up to 16 rows and splits
//   its slice of K among its warps; K is split across blocks until the grid
//   has two blocks per SM, and a second pass adds the splits in order (no
//   atomics: the same bits on every run);
// - ragged edges: rows past M are zero in registers, columns past N skipped
//   (N a multiple of 16); K must be a multiple of 512 and the group size a
//   multiple of 64 (LAP-3B: K in {1024, 2048, 4096, 16384}, groups of 256).
//   The wrapper raises otherwise.

#include "dequant_matmul_common.cuh"

namespace {

constexpr int TILES = 4;  // 16-column mma tiles per warp: 64 columns, one 8-byte load a lane
constexpr int BLOCK_N = 16 * TILES;

__device__ __forceinline__ uint32_t half_of(const uint2& v, int i) { return i == 0 ? v.x : v.y; }

template <int MT>
__global__ void __launch_bounds__(NUM_THREADS)
    int4_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
                       const float* __restrict__ scales, float* __restrict__ partial, int M, int N,
                       int K, int group, int kp_per_block) {
  __shared__ float red[NUM_WARPS * 8 * MT * (BLOCK_N + 4)];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int n0 = blockIdx.x * BLOCK_N;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * 8 * MT;
  const int half = K / 2;
  const int kp_per_warp = kp_per_block / NUM_WARPS;
  const int p_begin = split * kp_per_block + warp * kp_per_warp;

  const int col = n0 + 8 * g;  // this lane's 8 columns
  const bool col_ok = col < N;
  const __nv_bfloat16* xrow[MT];
  bool row_ok[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = m0 + 8 * mt + g;
    row_ok[mt] = m < M;
    xrow[mt] = x + static_cast<int64_t>(row_ok[mt] ? m : 0) * K;
  }

  float total[TILES][MT][4];
#pragma unroll
  for (int j = 0; j < TILES; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[j][mt][e] = 0.f;

  for (int pc = p_begin; pc < p_begin + kp_per_warp; pc += CHUNK_ROWS) {
    // Packed rows 2q, 2q + 1, 2q + 8, 2q + 9 of each 16-row step.
    uint2 raw[CHUNK_STEPS][4];
#pragma unroll
    for (int s = 0; s < CHUNK_STEPS; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = pc + 16 * s + 2 * q + (r & 1) + 8 * (r >> 1);
        raw[s][r] = col_ok ? __ldg(reinterpret_cast<const uint2*>(packed + static_cast<int64_t>(p) * N + col))
                           : make_uint2(0, 0);
      }

#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int k0 = pc + hi * half;  // first contraction row of this slice
      uint32_t b[CHUNK_STEPS][MT][2];
#pragma unroll
      for (int s = 0; s < CHUNK_STEPS; ++s)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) load_x_frag(b[s][mt], xrow[mt], row_ok[mt], k0 + 16 * s + 2 * q);

      float acc[TILES][MT][4];
#pragma unroll
      for (int j = 0; j < TILES; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][mt][e] = 0.f;

#pragma unroll
      for (int s = 0; s < CHUNK_STEPS; ++s) {
#pragma unroll
        for (int j = 0; j < TILES; ++j) {
          // Tile j: A row g is packed column byte 2j of the lane's 8, row g + 8 byte 2j + 1.
          const int p = 2 * (j & 1);
          const int shift = 4 * hi;  // the high nibbles move to the low bits
          const uint32_t w0 = half_of(raw[s][0], j >> 1) >> shift;
          const uint32_t w1 = half_of(raw[s][1], j >> 1) >> shift;
          const uint32_t w2 = half_of(raw[s][2], j >> 1) >> shift;
          const uint32_t w3 = half_of(raw[s][3], j >> 1) >> shift;
          uint32_t a[4];
          a[0] = int4x2_to_bf16x2(pair_bytes(w0, w1, p));
          a[1] = int4x2_to_bf16x2(pair_bytes(w0, w1, p + 1));
          a[2] = int4x2_to_bf16x2(pair_bytes(w2, w3, p));
          a[3] = int4x2_to_bf16x2(pair_bytes(w2, w3, p + 1));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_16816(acc[j][mt], a, b[s][mt][0], b[s][mt][1]);
        }
      }

      // Scale this 64-row slice of one group into the total. C rows g and
      // g + 8 of tile j are columns col + 2j and col + 2j + 1.
      const float* srow = scales + static_cast<int64_t>(k0 / group) * N + col;
#pragma unroll
      for (int j = 0; j < TILES; ++j) {
        const float2 sc = col_ok ? __ldg(reinterpret_cast<const float2*>(srow + 2 * j)) : make_float2(0.f, 0.f);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          total[j][mt][0] += acc[j][mt][0] * sc.x;
          total[j][mt][1] += acc[j][mt][1] * sc.x;
          total[j][mt][2] += acc[j][mt][2] * sc.y;
          total[j][mt][3] += acc[j][mt][3] * sc.y;
        }
      }
    }
  }
  block_partial_store<TILES, MT>(red, total, partial, split, m0, n0, M, N);
}

template <int MT>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* packed, const float* scales, float* partial,
                   int M, int N, int K, int group, int splits, cudaStream_t stream) {
  const dim3 grid((N + BLOCK_N - 1) / BLOCK_N, splits, (M + 8 * MT - 1) / (8 * MT));
  int4_matmul_kernel<MT><<<grid, NUM_THREADS, 0, stream>>>(x, packed, scales, partial, M, N, K,
                                                           group, (K / 2) / splits);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16, packed [K/2, N] int8, scales [K/group, N] f32, partial
// [splits, M, N] f32 scratch, out [M, N] bf16; all contiguous. Returns the
// first CUDA error.
extern "C" int int4_matmul(const void* x, const void* packed, const void* scales, void* partial,
                           void* out, int M, int N, int K, int group, int splits, void* stream) {
  if (M < 1 || N % 16 || splits < 1 || group < CHUNK_ROWS || group % CHUNK_ROWS ||
      (K / 2) % group || K % 2 || (K / 2) % (splits * NUM_WARPS * CHUNK_ROWS)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* pb = static_cast<const int8_t*>(packed);
  const auto* sf = static_cast<const float*>(scales);
  auto* pf = static_cast<float*>(partial);
  cudaError_t err = M <= 8 ? launch<1>(xb, pb, sf, pf, M, N, K, group, splits, s)
                           : launch<2>(xb, pb, sf, pf, M, N, K, group, splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_splitk_reduce(pf, nullptr, static_cast<__nv_bfloat16*>(out), M, N,
                                               splits, s));
}
