// Device code shared by the weight-only int8 and int4 dequant-matmul kernels
// (sm_90a): the shared-memory copy ring of weight, x (and int4 scale) tiles,
// the exact conversion of int8 and int4 weights to bf16, and the epilogue
// that adds the warps' sums and the split-K partials inside the kernel.
//
// Both kernels compute the transposed product out^T = W^T . x^T with
// mma.sync m16n8k16 (bf16 in, f32 accumulate): W^T is the A operand (16
// output columns x 16 contraction rows), x^T the B operand (16 contraction
// rows x 8 rows of x), so the at most 8 or 16 rows of a decode step fill the
// narrow side of the tile.
//
// Block and ring. A block owns BLOCK_N = 128 output columns (128 weight bytes
// a row: int8 columns, or packed int4 columns), up to 16 rows of x (one row
// tile) and one split of the weight's rows, which it walks in chunks of 64
// rows. A chunk's stage holds the 64 x 128 weight bytes, the row tile's x for
// those contraction rows (int4: for the low and the high half of K) and, for
// int4, the chunk's two scale rows; every thread copies 16 bytes at a time
// with cp.async.cg, from a source pointer it keeps and advances a chunk at a
// time (no address arithmetic per copy). STAGES = 4 stages: while chunk c
// converts, chunks c + 1 .. c + 3 are in flight (24 KB of weight a block,
// 48 KB an SM). One barrier a chunk, as in the flash backward's ring.
//
// Warps. The block's 16 warps split each chunk four ways by columns and four
// ways by k-steps: warp w owns columns [32 (w % 4), 32 (w % 4) + 32) and part
// w / 4 of the chunk's rows (int8: k-step w / 4; int4: int4_matmul.cu).
// Converting weights is the costly part of the math (integer ops at half the
// FMA rate, and the cost of a chunk's copies and barrier besides), so a
// chunk's work is spread over many warps, two blocks of 512 threads on an SM
// (at most 64 registers a thread), and the four parts' sums of a column meet
// once, at the end, in shared memory in a fixed order. Lane (g = lane / 4,
// q = lane % 4) reads one 32-bit word of each of rows 2q, 2q + 1, 2q + 8,
// 2q + 9 of a k-step: columns 4 g .. 4 g + 3 of its warp's slice. Tile j (0, 1) maps A row g to column 4 g + 2 j and A
// row g + 8 to column 4 g + 2 j + 1, so those four words give all A
// fragments of both tiles, and a lane's C entries of one x row are four
// neighbouring columns. Stage rows are 144 bytes apart (128 + 16 of padding):
// the 32 lanes' words of one read then fall on 32 different banks, for the
// weight (rows 2q + r, words 8 (w % 4) + g) and for x (rows g, words q + 8 s)
// alike.
//
// Split-K inside the kernel. With one split a block writes bf16 directly.
// With S splits each block writes its f32 partial [M, N] slice and counts
// itself in at its tile's arrival counter (one atomic add with
// acquire-release semantics on an int; no atomic touches data). The block
// that arrives last adds the S partials of the tile in the fixed order
// 0 .. S-1, applies int8's scale to the f32 sum, casts to bf16, writes, and
// resets the counter to 0 for the next call. The same inputs give the same
// bits whichever block arrives last. Chosen over a thread-block cluster
// that sums through distributed shared memory: a cluster holds at most 8
// splits where MLP down wants 16, and a version with clusters of up to 8
// ran slower on an H100 at MLP down (clusters constrain where blocks run).

#pragma once

#include "flash_attention_common.cuh"  // cp_async_*, mma_16816, pack_bf16

namespace {

constexpr int CHUNK_ROWS = 64;                // weight rows of one stage
constexpr int CHUNK_STEPS = CHUNK_ROWS / 16;  // mma k-steps of a chunk
constexpr int BLOCK_N = 128;                  // weight bytes of a stage row
constexpr int WARP_N = 32;                    // columns a warp
constexpr int COL_GROUPS = BLOCK_N / WARP_N;
constexpr int DQ_THREADS = 32 * COL_GROUPS * CHUNK_STEPS;  // 16 warps
constexpr int DQ_MIN_BLOCKS = 2;              // resident blocks an SM: at most 64 registers a thread
constexpr int STAGES = 4;
constexpr int ROW_BYTES = BLOCK_N + 16;       // padded stage row (weight and x)
constexpr int X_LD = ROW_BYTES / 2;           // bf16 elements of a padded x row
constexpr int W_STAGE_BYTES = CHUNK_ROWS * ROW_BYTES;
constexpr int PIECES = BLOCK_N / 16;          // 16-byte copies of a weight row
constexpr int RED_LD = BLOCK_N + 4;           // floats of a row of the warps' sums
constexpr int LOAD_BATCH = 8;                 // partial loads issued together in the split sum

// A warp's share of a chunk: its column group and its part (0 .. 3) of the
// chunk's k-steps (int8: k-step `warp_part`; int4: see int4_matmul.cu).
__device__ __forceinline__ int warp_part() { return threadIdx.x / 32 / COL_GROUPS; }
__device__ __forceinline__ int warp_col() { return WARP_N * (threadIdx.x / 32 % COL_GROUPS); }

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bits_bf162(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
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

// Nibbles of int4 weights (two's complement) with their sign bits flipped:
// u = v + 8, in 0 .. 15. One XOR serves eight weights.
__device__ __forceinline__ uint32_t int4_offset(uint32_t word) { return word ^ 0x88888888u; }

// Two int4 weights, the low nibbles u = v + 8 of the low bytes of the two
// halves of `pair` (int4_offset), to an exact bf16x2: bf16 0x4300 | u is
// 128 + u, and (128 + u) - 136 = v.
__device__ __forceinline__ uint32_t int4x2_to_bf16x2(uint32_t pair) {
  const uint32_t mag = (pair & 0x000F000Fu) | 0x43004300u;
  return bf162_bits(__hsub2(bits_bf162(mag), bits_bf162(0x43084308u)));
}

// This thread's share of a stage's copies, its source advanced one chunk a
// call, so that issuing a chunk costs a few instructions: one 16-byte piece
// of the 64 x 128 weight bytes (rows [row0, row0 + 64) and bytes
// [col0, col0 + 128) of a [rows, N]-byte matrix; pieces past N are zeros).
struct WeightCopy {
  const int8_t* src;
  int dst;
  bool valid;
  __device__ __forceinline__ WeightCopy(const int8_t* w, int64_t row0, int col0, int N) {
    static_assert(CHUNK_ROWS * PIECES == DQ_THREADS, "one piece a thread");
    const int piece = threadIdx.x % PIECES;
    const int col = col0 + 16 * piece;
    valid = col < N;
    src = w + (row0 + threadIdx.x / PIECES) * N + (valid ? col : 0);
    dst = threadIdx.x / PIECES * ROW_BYTES + 16 * piece;
  }
  // cp.async with a 256-byte L2 prefetch: the row's neighbouring blocks ask
  // for the bytes next to these (a little faster at the vocab head on an H100).
  __device__ __forceinline__ void issue(unsigned char* stage, int N) {
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(smem_addr(stage + dst)),
                 "l"(src), "r"(valid ? 16 : 0));
    src += static_cast<int64_t>(CHUNK_ROWS) * N;
  }
};

// One 16-byte piece of x[m0 .. m0 + ROWS, k0 .. k0 + 64) (bf16, row stride K)
// for threads [0, 8 ROWS); rows past M are zeros. For int4 the same thread
// also copies the piece K/2 columns on, for the high half of K.
template <int ROWS>
struct XCopy {
  const __nv_bfloat16* src;
  int dst;
  bool active, valid;
  __device__ __forceinline__ XCopy(const __nv_bfloat16* x, int m0, int M, int K, int k0) {
    constexpr int X_PIECES = CHUNK_ROWS * 2 / 16;
    active = threadIdx.x < ROWS * X_PIECES;
    const int r = active ? threadIdx.x / X_PIECES : 0;
    valid = active && m0 + r < M;
    src = x + (valid ? static_cast<int64_t>(m0 + r) * K : 0) + k0 + 8 * (threadIdx.x % X_PIECES);
    dst = r * ROW_BYTES + 16 * (threadIdx.x % X_PIECES);
  }
  __device__ __forceinline__ void issue(unsigned char* xs) {
    if (active) cp_async_16(smem_addr(xs + dst), src, valid ? 16 : 0);
    src += CHUNK_ROWS;
  }
  // Both halves of K: the low half's piece at xs, the high half's at xs_hi.
  __device__ __forceinline__ void issue2(unsigned char* xs, unsigned char* xs_hi, int half) {
    if (active) {
      cp_async_16(smem_addr(xs + dst), src, valid ? 16 : 0);
      cp_async_16(smem_addr(xs_hi + dst), src + half, valid ? 16 : 0);
    }
    src += CHUNK_ROWS;
  }
};

// The four weight words a lane converts in k-step s: rows 2q, + 1, + 8, + 9
// of the step, columns 4 g .. 4 g + 3 of its warp's slice.
__device__ __forceinline__ void load_weight_words(uint32_t (&wv)[4], const unsigned char* stage, int s) {
  const int lane = threadIdx.x % 32;
  const unsigned char* base = stage + (16 * s + 2 * (lane & 3)) * ROW_BYTES + warp_col() + 4 * (lane >> 2);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    wv[r] = *reinterpret_cast<const uint32_t*>(base + ((r & 1) + 8 * (r >> 1)) * ROW_BYTES);
  }
}

// x^T fragments of k-step s for the MT 8-row tiles of a staged x chunk.
template <int MT>
__device__ __forceinline__ void load_x_frags(uint32_t (&b)[MT][2], const __nv_bfloat16* xs, int s) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const __nv_bfloat16* row = xs + (8 * mt + (lane >> 2)) * X_LD + 16 * s + 2 * (lane & 3);
    b[mt][0] = *reinterpret_cast<const uint32_t*>(row);
    b[mt][1] = *reinterpret_cast<const uint32_t*>(row + 8);
  }
}

// int8 A fragment of tile j from the four words of a k-step.
__device__ __forceinline__ void a_frag_int8(uint32_t (&a)[4], const uint32_t (&wv)[4], int j) {
  const int p = 2 * j;
  a[0] = int8x2_to_bf16x2(pair_bytes(wv[0], wv[1], p));
  a[1] = int8x2_to_bf16x2(pair_bytes(wv[0], wv[1], p + 1));
  a[2] = int8x2_to_bf16x2(pair_bytes(wv[2], wv[3], p));
  a[3] = int8x2_to_bf16x2(pair_bytes(wv[2], wv[3], p + 1));
}

// Tile j's bytes of the four offset words of an int4 k-step: one byte
// permute each gathers [w0_p, w0_p+1, w1_p, w1_p+1] (p = 2 j) for rows 2q,
// 2q + 1 and for rows 2q + 8, 2q + 9.
__device__ __forceinline__ void gather_int4(uint32_t (&t)[2], const uint32_t (&wv)[4], int j) {
  const int sel = (2 * j) | ((2 * j + 1) << 4) | ((2 * j + 4) << 8) | ((2 * j + 5) << 12);
  t[0] = __byte_perm(wv[0], wv[1], sel);
  t[1] = __byte_perm(wv[2], wv[3], sel);
}

// int4 A fragment of a tile from its gathered bytes for the low (shift 0) or
// the high (shift 4) half of K: shifted by 0 or 8 bits more, the low nibbles
// at bits 0 and 16 are A rows g and g + 8.
__device__ __forceinline__ void a_frag_int4(uint32_t (&a)[4], const uint32_t (&t)[2], int shift) {
  const uint32_t rows01 = t[0] >> shift;
  const uint32_t rows89 = t[1] >> shift;
  a[0] = int4x2_to_bf16x2(rows01);
  a[1] = int4x2_to_bf16x2(rows01 >> 8);
  a[2] = int4x2_to_bf16x2(rows89);
  a[3] = int4x2_to_bf16x2(rows89 >> 8);
}

// x row 2q + h of 8-row tile mt, as the four neighbouring columns 4 g .. 4 g + 3
// of the lane's C entries (tile j holds columns 4 g + 2 j and + 1).
template <int MT>
__device__ __forceinline__ float4 row_values(const float (&c)[2][MT][4], int mt, int h) {
  return make_float4(c[0][mt][h], c[0][mt][2 + h], c[1][mt][h], c[1][mt][2 + h]);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float4 v, float4 sc) {
  uint2 packed;
  packed.x = pack_bf16(v.x * sc.x, v.y * sc.y);
  packed.y = pack_bf16(v.z * sc.z, v.w * sc.w);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// After the last chunk: add the four warp parts' sums of each column in
// shared memory (`smem`, the idle ring) in part order, then write the
// block's [8 MT, 128] result: bf16 directly with one split; else the f32
// partial, and the tile's last block to arrive adds all splits in order
// 0 .. S-1. Thread t takes row t / 32 and columns 4 (t % 32) .. + 3 of the
// tile. `scale` (int8's per-column scale, or nullptr) multiplies the f32 sum.
// Grid: (row tiles, column blocks, splits).
template <int MT>
__device__ __forceinline__ void finish_tile(const float (&c)[2][MT][4], unsigned char* smem,
                                            const float* __restrict__ scale, float* __restrict__ partial,
                                            __nv_bfloat16* __restrict__ out, int* __restrict__ counters,
                                            int M, int N) {
  constexpr int ROWS = 8 * MT;
  static_assert(ROWS * (BLOCK_N / 4) <= DQ_THREADS, "one item a thread");
  const int lane = threadIdx.x % 32;
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 8 * mt + 2 * (lane & 3) + h;
      *reinterpret_cast<float4*>(red + (warp_part() * ROWS + m) * RED_LD + warp_col() + 4 * (lane >> 2)) =
          row_values(c, mt, h);
    }
  __syncthreads();

  const int r = threadIdx.x / (BLOCK_N / 4);
  const int m = blockIdx.x * ROWS + r;
  const int n = blockIdx.y * BLOCK_N + 4 * (threadIdx.x % (BLOCK_N / 4));
  const bool valid = r < ROWS && m < M && n < N;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid) {
    const float* src = red + r * RED_LD + 4 * (threadIdx.x % (BLOCK_N / 4));
#pragma unroll
    for (int s = 0; s < CHUNK_STEPS; ++s) v = add4(v, *reinterpret_cast<const float4*>(src + s * ROWS * RED_LD));
  }
  const float4 one = make_float4(1.f, 1.f, 1.f, 1.f);
  const int64_t at = static_cast<int64_t>(m) * N + n;
  const int splits = gridDim.z;
  if (splits == 1) {
    if (valid) store_bf16x4(out + at, v, scale != nullptr ? __ldg(reinterpret_cast<const float4*>(scale + n)) : one);
    return;
  }

  const int64_t slice = static_cast<int64_t>(M) * N;
  if (valid) *reinterpret_cast<float4*>(partial + blockIdx.z * slice + at) = v;
  // The barrier orders the block's partial stores before thread 0's count;
  // the count's release (cumulative, at GPU scope) makes them visible to the
  // block that reads them, and its acquire, passed on by the second
  // barrier, orders the last block's loads after every split's stores. One
  // thread fences, not 512: the small split shapes run faster.
  __syncthreads();
  int* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
  bool last = false;
  if (threadIdx.x == 0) {
    int arrived;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n" : "=r"(arrived) : "l"(counter) : "memory");
    last = arrived == splits - 1;
    if (last) *counter = 0;  // every split has arrived: ready for the next call
  }
  if (!__syncthreads_or(last) || !valid) return;

  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < splits; s0 += LOAD_BATCH) {
    float4 p[LOAD_BATCH];
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      p[u] = s0 + u < splits ? __ldcg(reinterpret_cast<const float4*>(partial + (s0 + u) * slice + at))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      if (s0 + u < splits) sum = add4(sum, p[u]);
    }
  }
  store_bf16x4(out + at, sum, scale != nullptr ? __ldg(reinterpret_cast<const float4*>(scale + n)) : one);
}

// Registers, local (spill) bytes, dynamic shared memory and resident blocks
// per SM of one compiled kernel.
template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, int smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, DQ_THREADS, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = smem;
  out[3] = blocks;
  return cudaSuccess;
}

// Let `kernel` take `bytes` of dynamic shared memory (above the default 48 KB).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* configured) {
  if (*configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *configured = true;
  return err;
}

}  // namespace
