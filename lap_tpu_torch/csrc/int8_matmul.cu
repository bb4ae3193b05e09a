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
// bytes (plus x, scale and out) at 3.35 TB/s. To reach it the card needs
// some 25 KB of loads in flight on every SM all the time (3.35 TB/s over 132
// SMs at ~1 us of loaded latency), and the fixed cost of a call must stay
// small beside bounds of 1-20 us.
//
// Design (dequant_matmul_common.cuh has the ring, the layout and the split
// sum):
// - a block of 16 warps owns 128 columns, a tile of up to 16 rows of x (more
//   rows take more row tiles along grid x, next to each other in launch
//   order so that they find the weight in L2) and one split of K; it streams
//   64-row chunks of the weight (8 KB) and of its rows of x through a
//   4-stage cp.async ring: 24 KB in flight a block, and the x rows are read
//   from global memory once a block;
// - each warp converts the 16 x 32 weights of its k-step and columns of a
//   chunk from shared memory (the byte is spliced into the mantissa of bf16
//   128.0 and the sign moved into the subtrahend: one byte permute, two
//   logic ops and one bf16x2 subtract per two weights, all exact) and feeds
//   mma.sync m16n8k16 with the weight on the 16-wide side;
// - the wrapper's plan (ops/int8_matmul.py, launch_plan) splits K until the
//   grid keeps 40 KB of weight in flight per SM, or the whole weight if it is
//   smaller; the splits' partials meet inside the kernel (one launch a call)
//   in a fixed order, and the scale is applied to their f32 sum;
// - ragged edges: rows past M are zero in shared memory, columns past N are
//   zero and skipped (N must be a multiple of 16, the vocab head's 257,152 is
//   128 * 2009); K must be a multiple of 64. The wrapper raises otherwise.

#include "dequant_matmul_common.cuh"

namespace {

template <int MT>
__host__ __device__ constexpr int stage_bytes() {
  return W_STAGE_BYTES + 8 * MT * ROW_BYTES;
}
template <int MT>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * stage_bytes<MT>();
}

template <int MT>
__global__ void __launch_bounds__(DQ_THREADS, DQ_MIN_BLOCKS)
    int8_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, float* __restrict__ partial,
                       __nv_bfloat16* __restrict__ out, int* __restrict__ counters, int M, int N,
                       int K, int chunks) {
  extern __shared__ uint4 smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  const int m0 = blockIdx.x * 8 * MT;
  const int k_begin = blockIdx.z * chunks * CHUNK_ROWS;
  WeightCopy wcopy(w, k_begin, blockIdx.y * BLOCK_N, N);
  XCopy<8 * MT> xcopy(x, m0, M, K, k_begin);
  auto load = [&](int slot) {
    unsigned char* st = base + slot * stage_bytes<MT>();
    wcopy.issue(st, N);
    xcopy.issue(st + W_STAGE_BYTES);
  };

  float c[2][MT][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][mt][e] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < chunks) load(i);
    cp_async_commit();
  }
  int slot = 0;  // stage of this chunk; chunk + STAGES - 1 goes to the one before it
  for (int chunk = 0; chunk < chunks; ++chunk) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk landed for all; the stage of chunk - 1 is free
    if (chunk + STAGES - 1 < chunks) load(slot == 0 ? STAGES - 1 : slot - 1);
    cp_async_commit();

    const unsigned char* st = base + slot * stage_bytes<MT>();
    slot = slot == STAGES - 1 ? 0 : slot + 1;
    uint32_t wv[4];
    load_weight_words(wv, st, warp_part());
    uint32_t b[MT][2];
    load_x_frags<MT>(b, reinterpret_cast<const __nv_bfloat16*>(st + W_STAGE_BYTES), warp_part());
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t a[4];
      a_frag_int8(a, wv, j);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_16816(c[j][mt], a, b[mt][0], b[mt][1]);
    }
  }
  finish_tile<MT>(c, base, scale, partial, out, counters, M, N);
}

bool configured[2] = {false, false};

template <int MT>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* w, const float* scale, float* partial,
                   __nv_bfloat16* out, int* counters, int M, int N, int K, int splits,
                   cudaStream_t stream) {
  cudaError_t err = allow_smem(int8_matmul_kernel<MT>, smem_bytes<MT>(), &configured[MT - 1]);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + 8 * MT - 1) / (8 * MT), (N + BLOCK_N - 1) / BLOCK_N, splits);
  int8_matmul_kernel<MT><<<grid, DQ_THREADS, smem_bytes<MT>(), stream>>>(
      x, w, scale, partial, out, counters, M, N, K, K / CHUNK_ROWS / splits);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16, w [K, N] int8, scale [N] f32, out [M, N] bf16; with
// splits > 1, partial [splits, M, N] f32 scratch and counters (one int per
// (row tile, column block), zero, and left zero); all contiguous and 16-byte
// aligned. Returns the first CUDA error.
extern "C" int int8_matmul(const void* x, const void* w, const void* scale, void* partial, void* out,
                           void* counters, int M, int N, int K, int rows_per_tile, int splits,
                           void* stream) {
  if (M < 1 || N % 16 || splits < 1 || K % (splits * CHUNK_ROWS) ||
      rows_per_tile != (M <= 8 ? 8 : 16) || (splits > 1 && (partial == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const int8_t*>(w);
  const auto* sf = static_cast<const float*>(scale);
  auto* pf = static_cast<float*>(partial);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* ct = static_cast<int*>(counters);
  return static_cast<int>(M <= 8 ? launch<1>(xb, wb, sf, pf, ob, ct, M, N, K, splits, s)
                                 : launch<2>(xb, wb, sf, pf, ob, ct, M, N, K, splits, s));
}

// Registers, local bytes, dynamic shared memory and resident blocks per SM
// of the kernel for `rows_per_tile` (8 or 16) rows.
extern "C" int int8_matmul_info(int rows_per_tile, int* out) {
  if (rows_per_tile == 8) {
    cudaError_t err = allow_smem(int8_matmul_kernel<1>, smem_bytes<1>(), &configured[0]);
    return static_cast<int>(err != cudaSuccess ? err : kernel_info(int8_matmul_kernel<1>, smem_bytes<1>(), out));
  }
  if (rows_per_tile == 16) {
    cudaError_t err = allow_smem(int8_matmul_kernel<2>, smem_bytes<2>(), &configured[1]);
    return static_cast<int>(err != cudaSuccess ? err : kernel_info(int8_matmul_kernel<2>, smem_bytes<2>(), out));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
