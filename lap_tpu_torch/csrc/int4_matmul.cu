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
// and the fixed cost of a call weighs twice as much.
//
// Design (dequant_matmul_common.cuh has the ring, the layout and the split
// sum; the same as int8's, with packed bytes in place of int8 bytes):
// - a block of 16 warps owns 128 packed columns, a tile of up to 16 rows of
//   x and one split of the packed rows; it streams chunks of 64 packed rows
//   (8 KB, 128 contraction rows) through a 4-stage cp.async ring, each stage
//   with the chunk's x for the low half [p, p + 64) and the high half
//   [K/2 + p, K/2 + p + 64) of K and the two scale rows the chunk needs (one
//   group per half: the group size is a multiple of 64): 24 KB of weight in
//   flight a block, every lane copying 16 bytes;
// - up to 8 rows, each warp reads the 16 x 32 bytes of its k-step and
//   columns of a chunk from shared memory once and converts both halves from
//   the same words; at 9-16 rows, where the sums of both halves would not fit
//   in 64 registers, each warp takes two k-steps of one half; conversion for
//   mma.sync m16n8k16 (bf16, f32 sums, the weight on the 16-wide side): one
//   XOR flips the sign bits of eight nibbles (u = v + 8), one byte permute
//   gathers a tile's bytes of two rows, and each pair of weights is a shift,
//   one logic op splicing u into the mantissa of bf16 128.0 and a bf16x2
//   subtract of 136 (exact);
// - a 64-row chunk of a half lies inside one group (the group size is a
//   multiple of 64), so a warp sums its rows of a group (a quarter or a half
//   of each chunk's) in f32 and scales that sum by the group's scale before
//   it adds it to its total: the Pallas kernel scales a whole group's
//   partial, this scales the sums of its parts (the same sum in another
//   order);
// - the wrappers' plan (launch_plan in ops/int8_matmul.py) splits the packed
//   rows until the grid keeps 40 KB of weight in flight per SM, or the whole
//   weight;
//   the splits' partials meet inside the kernel (one launch a call) in a
//   fixed order;
// - ragged edges: rows past M are zero in shared memory, columns past N are
//   zero and skipped (N a multiple of 16); K must be a multiple of 128 and
//   the group size a multiple of 64 that divides K/2 (LAP-3B: K in {1024,
//   2048, 4096, 16384}, groups of 256). The wrapper raises otherwise.

#include "dequant_matmul_common.cuh"

namespace {

constexpr int SCALE_STAGE_BYTES = 2 * BLOCK_N * 4;  // the low and the high half's scale rows

template <int MT>
__host__ __device__ constexpr int x_stage_bytes() {
  return 2 * 8 * MT * ROW_BYTES;
}
template <int MT>
__host__ __device__ constexpr int stage_bytes() {
  return W_STAGE_BYTES + x_stage_bytes<MT>() + SCALE_STAGE_BYTES;
}
template <int MT>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * stage_bytes<MT>();
}

template <int MT>
__global__ void __launch_bounds__(DQ_THREADS, DQ_MIN_BLOCKS)
    int4_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
                       const float* __restrict__ scales, float* __restrict__ partial,
                       __nv_bfloat16* __restrict__ out, int* __restrict__ counters, int M, int N,
                       int K, int group, int chunks) {
  extern __shared__ uint4 smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * 8 * MT;
  const int n0 = blockIdx.y * BLOCK_N;
  const int half = K / 2;
  const int p_begin = blockIdx.z * chunks * CHUNK_ROWS;
  const int group_chunks = group / CHUNK_ROWS;
  WeightCopy wcopy(packed, p_begin, n0, N);
  XCopy<8 * MT> xcopy(x, m0, M, K, p_begin);
  // The last 64 threads copy the scale rows of the chunk's groups in the low
  // and the high half, moving down a row when a group ends (at the same chunk
  // in both halves: K/2 is a multiple of the group).
  const int si = static_cast<int>(threadIdx.x) - (DQ_THREADS - 2 * BLOCK_N / 4);
  const int scol = n0 + 4 * (si % (BLOCK_N / 4));
  const bool scopy = si >= 0, svalid = scopy && scol < N;
  const float* ssrc =
      scales + static_cast<int64_t>((si >= BLOCK_N / 4 ? half : 0) + p_begin) / group * N + (svalid ? scol : 0);
  int scale_left = group_chunks - p_begin / CHUNK_ROWS % group_chunks;  // chunks until the group ends
  auto load = [&](int slot) {
    unsigned char* st = base + slot * stage_bytes<MT>();
    wcopy.issue(st, N);
    xcopy.issue2(st + W_STAGE_BYTES, st + W_STAGE_BYTES + x_stage_bytes<MT>() / 2, half);
    if (scopy) cp_async_16(smem_addr(st + W_STAGE_BYTES + x_stage_bytes<MT>() + 16 * si), ssrc, svalid ? 16 : 0);
    if (--scale_left == 0) {
      ssrc += N;
      scale_left = group_chunks;
    }
  };

  // Warp part 0 .. 3. One 8-row tile: k-step `part` of each chunk in both
  // halves of K (the same bytes feed both). Two: k-steps 2 (part / 2) and
  // 2 (part / 2) + 1 in the low (part even) or the high (part odd) half, so
  // that the sums of 16 rows fit in 64 registers.
  constexpr int HALVES = MT == 1 ? 2 : 1;
  constexpr int STEPS = 3 - HALVES;
  const int h0 = MT == 1 ? 0 : warp_part() & 1;
  const int step0 = MT == 1 ? warp_part() : 2 * (warp_part() >> 1);
  // acc: this warp's sums over its rows of the current group, per half it
  // takes; total: the scaled sums of the groups before it.
  float acc[HALVES][2][MT][4], total[2][MT][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        total[j][mt][e] = 0.f;
#pragma unroll
        for (int hh = 0; hh < HALVES; ++hh) acc[hh][j][mt][e] = 0.f;
      }

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < chunks) load(i);
    cp_async_commit();
  }
  int slot = 0;  // stage of this chunk; chunk + STAGES - 1 goes to the one before it
  int group_left = group_chunks - p_begin / CHUNK_ROWS % group_chunks;  // chunks until the group ends
  for (int chunk = 0; chunk < chunks; ++chunk) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk landed for all; the stage of chunk - 1 is free
    if (chunk + STAGES - 1 < chunks) load(slot == 0 ? STAGES - 1 : slot - 1);
    cp_async_commit();

    const unsigned char* st = base + slot * stage_bytes<MT>();
    slot = slot == STAGES - 1 ? 0 : slot + 1;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st + W_STAGE_BYTES);
#pragma unroll
    for (int t = 0; t < STEPS; ++t) {
      uint32_t wv[4];
      load_weight_words(wv, st, step0 + t);
#pragma unroll
      for (int r = 0; r < 4; ++r) wv[r] = int4_offset(wv[r]);
      uint32_t b[HALVES][MT][2];
#pragma unroll
      for (int hh = 0; hh < HALVES; ++hh) load_x_frags<MT>(b[hh], xs + (h0 + hh) * 8 * MT * X_LD, step0 + t);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t bytes[2];
        gather_int4(bytes, wv, j);
#pragma unroll
        for (int hh = 0; hh < HALVES; ++hh) {
          uint32_t a[4];
          a_frag_int4(a, bytes, 4 * (h0 + hh));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_16816(acc[hh][j][mt], a, b[hh][mt][0], b[hh][mt][1]);
        }
      }
    }

    // At the end of a group (and of the split), scale the group's sums into
    // the total: C rows g and g + 8 of tile j are the lane's columns
    // 4 g + 2 j and 4 g + 2 j + 1.
    if (--group_left == 0 || chunk == chunks - 1) {
      group_left = group_chunks;
      const float* ss = reinterpret_cast<const float*>(st + W_STAGE_BYTES + x_stage_bytes<MT>());
#pragma unroll
      for (int hh = 0; hh < HALVES; ++hh) {
        const float4 sc = *reinterpret_cast<const float4*>(ss + (h0 + hh) * BLOCK_N + warp_col() + 4 * (lane >> 2));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          total[0][mt][0] += acc[hh][0][mt][0] * sc.x;
          total[0][mt][1] += acc[hh][0][mt][1] * sc.x;
          total[0][mt][2] += acc[hh][0][mt][2] * sc.y;
          total[0][mt][3] += acc[hh][0][mt][3] * sc.y;
          total[1][mt][0] += acc[hh][1][mt][0] * sc.z;
          total[1][mt][1] += acc[hh][1][mt][1] * sc.z;
          total[1][mt][2] += acc[hh][1][mt][2] * sc.w;
          total[1][mt][3] += acc[hh][1][mt][3] * sc.w;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[hh][j][mt][e] = 0.f;
        }
      }
    }
  }
  finish_tile<MT>(total, base, nullptr, partial, out, counters, M, N);
}

bool configured[2] = {false, false};

template <int MT>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* packed, const float* scales, float* partial,
                   __nv_bfloat16* out, int* counters, int M, int N, int K, int group, int splits,
                   cudaStream_t stream) {
  cudaError_t err = allow_smem(int4_matmul_kernel<MT>, smem_bytes<MT>(), &configured[MT - 1]);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + 8 * MT - 1) / (8 * MT), (N + BLOCK_N - 1) / BLOCK_N, splits);
  int4_matmul_kernel<MT><<<grid, DQ_THREADS, smem_bytes<MT>(), stream>>>(
      x, packed, scales, partial, out, counters, M, N, K, group, K / 2 / CHUNK_ROWS / splits);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16, packed [K/2, N] int8, scales [K/group, N] f32, out [M, N]
// bf16; with splits > 1, partial [splits, M, N] f32 scratch and counters
// (one int per (row tile, column block), zero, and left zero); all
// contiguous and 16-byte aligned. Returns the first CUDA error.
extern "C" int int4_matmul(const void* x, const void* packed, const void* scales, void* partial,
                           void* out, void* counters, int M, int N, int K, int group, int rows_per_tile,
                           int splits, void* stream) {
  if (M < 1 || N % 16 || splits < 1 || K % 2 || group < CHUNK_ROWS || group % CHUNK_ROWS ||
      (K / 2) % group || (K / 2) % (splits * CHUNK_ROWS) || rows_per_tile != (M <= 8 ? 8 : 16) ||
      (splits > 1 && (partial == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* pb = static_cast<const int8_t*>(packed);
  const auto* sf = static_cast<const float*>(scales);
  auto* pf = static_cast<float*>(partial);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* ct = static_cast<int*>(counters);
  return static_cast<int>(M <= 8 ? launch<1>(xb, pb, sf, pf, ob, ct, M, N, K, group, splits, s)
                                 : launch<2>(xb, pb, sf, pf, ob, ct, M, N, K, group, splits, s));
}

// Registers, local bytes, dynamic shared memory and resident blocks per SM
// of the kernel for `rows_per_tile` (8 or 16) rows.
extern "C" int int4_matmul_info(int rows_per_tile, int* out) {
  if (rows_per_tile == 8) {
    cudaError_t err = allow_smem(int4_matmul_kernel<1>, smem_bytes<1>(), &configured[0]);
    return static_cast<int>(err != cudaSuccess ? err : kernel_info(int4_matmul_kernel<1>, smem_bytes<1>(), out));
  }
  if (rows_per_tile == 16) {
    cudaError_t err = allow_smem(int4_matmul_kernel<2>, smem_bytes<2>(), &configured[1]);
    return static_cast<int>(err != cudaSuccess ? err : kernel_info(int4_matmul_kernel<2>, smem_bytes<2>(), out));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
