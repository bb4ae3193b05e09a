// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out + f32 lse.
//
// Replaces the Pallas TPU kernel lap_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _flash_forward). It computes the same function:
//   s   = (q . k^T) * scale in f32, masked to -2.3819763e38 where mask == 0
//   out = softmax(s) . v, lse = logsumexp(s) per query row
// with GQA through kv head n / (N / K), and zeros plus lse = -2.3819763e38
// for a query row whose keys are all masked.
//
// What bounds it on the H100. At the LAP-3B prefill shape (B=1, T=S=692,
// N=8, K=1, H=256) one call does 4*N*T*S*H = 3.9 GFLOP on ~6.9 MB, so it sits
// far above the card's ~295 flop/byte ridge: it is bound by tensor-core
// operations (about 4 us at 989 TFLOP/s), and by latency and occupancy at a
// grid of only 8 heads x 11 query tiles = 88 blocks for 132 SMs.
//
// Design (a simple, correct first version; wgmma and TMA come later):
// - one block of 4 warps per (query tile of 64 rows, query head, batch);
//   each warp owns 16 query rows;
// - a loop over KV tiles of 64 keys inside the block replaces the Pallas
//   grid's sequential kv axis; K and V tiles are brought to shared memory
//   with cp.async (V of tile j loads while S = Q K^T of tile j is computed,
//   K of tile j+1 while O += P V of tile j is computed);
// - shared tiles are XOR-swizzled in 16-byte chunks so that ldmatrix reads
//   are free of bank conflicts;
// - Q K^T and P V run on the tensor cores with mma.sync m16n8k16 (bf16 in,
//   f32 accumulate); the online softmax (running max, sum, rescale) is f32
//   in registers. P is rounded to bf16 for the P V product: the Pallas
//   kernel keeps P in f32, so the two differ by up to about 2^-9 relative
//   per probability; chip_smoke.py states the tolerance against the f32-P
//   plain version;
// - the int8 (bool) mask tile is read from device memory into shared memory;
//   a KV tile whose mask is all false for the block is skipped (the numerics
//   do not change: its probabilities are all zero);
// - the output is staged through shared memory and written with 16-byte
//   stores.
// Head dims 128 and 256 are compiled; the wrapper raises on any other.

#include "flash_attention_common.cuh"

namespace {

constexpr int BLOCK_M = 64;
constexpr int BLOCK_N = 64;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const uint8_t* mask;
  __nv_bfloat16* out;
  float* lse;
  int B, T, S, N, KH;
  int64_t q_sb, q_st, q_sn, k_sb, k_st, k_sn, v_sb, v_st, v_sn, m_sb, m_st;
  float scale;
};

template <int H>
__global__ void __launch_bounds__(NUM_THREADS) flash_fwd_kernel(const Params p) {
  extern __shared__ uint4 smem[];
  constexpr int CHUNKS = H / 8;
  uint4* sQ = smem;
  uint4* sK = sQ + BLOCK_M * CHUNKS;
  uint4* sV = sK + BLOCK_N * CHUNKS;
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sV + BLOCK_N * CHUNKS);

  const int m0 = blockIdx.x * BLOCK_M;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / (p.N / p.KH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // row within an 8-row group of a fragment
  const int t = lane & 3;   // column pair within a fragment

  const __nv_bfloat16* q = p.q + b * p.q_sb + n * p.q_sn;
  const __nv_bfloat16* k = p.k + b * p.k_sb + kvh * p.k_sn;
  const __nv_bfloat16* v = p.v + b * p.v_sb + kvh * p.v_sn;
  const uint8_t* mask = p.mask + b * p.m_sb;

  load_tile<H, BLOCK_M>(sQ, q + m0 * p.q_st, p.q_st, 0, p.T - m0);
  load_tile<H, BLOCK_N>(sK, k, p.k_st, 0, p.S);
  cp_async_commit();

  float o[H / 8][4];
#pragma unroll
  for (int i = 0; i < H / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  // Running max (-inf until a row meets an unmasked key) and this thread's
  // partial row sums, for rows g and g + 8 of the warp's 16.
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};

  const int num_tiles = (p.S + BLOCK_N - 1) / BLOCK_N;
  for (int j = 0; j < num_tiles; ++j) {
    const int n0 = j * BLOCK_N;
    load_tile<H, BLOCK_N>(sV, v + n0 * p.v_st, p.v_st, 0, p.S - n0);
    cp_async_commit();

    int any = 0;
    for (int idx = threadIdx.x; idx < BLOCK_M * BLOCK_N; idx += NUM_THREADS) {
      const int r = idx / BLOCK_N, c = idx % BLOCK_N;
      const int row = m0 + r, col = n0 + c;
      uint8_t bit = 0;
      if (row < p.T && col < p.S) bit = mask[row * p.m_st + col] != 0;
      sMask[idx] = bit;
      any |= bit;
    }
    cp_async_wait<1>();  // Q and K tile j have landed
    any = __syncthreads_or(any);

    float s[BLOCK_N / 8][4];
    if (any) {
#pragma unroll
      for (int i = 0; i < BLOCK_N / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_addr(sQ + swz<H>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4))));
#pragma unroll
        for (int np = 0; np < BLOCK_N / 16; ++np) {
          uint32_t bk[4];
          const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(bk, smem_addr(sK + swz<H>(key, kk * 2 + ((lane >> 3) & 1))));
          mma_16816(s[2 * np], a, bk[0], bk[1]);
          mma_16816(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }

      // Mask, online softmax; s becomes the unnormalised probabilities.
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = warp * 16 + g + hr * 8;
        float tile_max = -INFINITY;
#pragma unroll
        for (int i = 0; i < BLOCK_N / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = i * 8 + t * 2 + e;
            const float x = sMask[row * BLOCK_N + col] ? s[i][hr * 2 + e] * p.scale : -INFINITY;
            s[i][hr * 2 + e] = x;
            tile_max = fmaxf(tile_max, x);
          }
        }
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffff, tile_max, 1));
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffff, tile_max, 2));
        const float new_max = fmaxf(row_max[hr], tile_max);
        const float use_max = new_max == -INFINITY ? 0.f : new_max;
        const float corr = exp2f((row_max[hr] - use_max) * LOG2E);
        row_max[hr] = new_max;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < BLOCK_N / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pr = exp2f((s[i][hr * 2 + e] - use_max) * LOG2E);
            s[i][hr * 2 + e] = pr;
            sum += pr;
          }
        }
        row_sum[hr] = row_sum[hr] * corr + sum;
#pragma unroll
        for (int i = 0; i < H / 8; ++i) {
          o[i][hr * 2] *= corr;
          o[i][hr * 2 + 1] *= corr;
        }
      }
    }

    __syncthreads();  // every warp is done with sK and sMask
    if (j + 1 < num_tiles) load_tile<H, BLOCK_N>(sK, k + (n0 + BLOCK_N) * p.k_st, p.k_st, 0, p.S - n0 - BLOCK_N);
    cp_async_commit();
    cp_async_wait<1>();  // V tile j has landed
    __syncthreads();

    if (any) {
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
        uint32_t a[4];
        c_to_a(a, s, kk);
#pragma unroll
        for (int hp = 0; hp < H / 16; ++hp) {
          uint32_t bv[4];
          const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
          ldmatrix_x4_trans(bv, smem_addr(sV + swz<H>(key, hp * 2 + (lane >> 4))));
          mma_16816(o[2 * hp], a, bv[0], bv[1]);
          mma_16816(o[2 * hp + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with sV
  }
  cp_async_wait<0>();

  // Normalise; stage this warp's 16 rows in its own rows of sQ.
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(sQ);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = row_sum[hr];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    const float inv = l == 0.f ? 0.f : 1.f / l;
    const int row = warp * 16 + g + hr * 8;
#pragma unroll
    for (int i = 0; i < H / 8; ++i) {
      // Column i*8 + t*2 lies in chunk i, element t*2.
      __nv_bfloat162 val = __floats2bfloat162_rn(o[i][hr * 2] * inv, o[i][hr * 2 + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(stage + swz<H>(row, i) * 8 + t * 2) = val;
    }
    if (t == 0 && m0 + row < p.T) {
      const float lse = l == 0.f ? MASK_VALUE : row_max[hr] + logf(l);
      p.lse[(static_cast<int64_t>(b) * p.N + n) * p.T + m0 + row] = lse;
    }
  }
  __syncwarp();
  // out is [B, T, N, H] contiguous.
  for (int idx = lane; idx < 16 * CHUNKS; idx += 32) {
    const int r = warp * 16 + idx / CHUNKS;
    const int c = idx % CHUNKS;
    if (m0 + r < p.T) {
      uint4* dst = reinterpret_cast<uint4*>(
          p.out + ((static_cast<int64_t>(b) * p.T + m0 + r) * p.N + n) * H + c * 8);
      *dst = sQ[swz<H>(r, c)];
    }
  }
}

template <int H>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = (BLOCK_M + 2 * BLOCK_N) * H * 2 + BLOCK_M * BLOCK_N;
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<H>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((p.T + BLOCK_M - 1) / BLOCK_M, p.N, p.B);
  flash_fwd_kernel<H><<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                   void* out, void* lse, int B, int T, int S, int N, int KH, int H,
                                   long long q_sb, long long q_st, long long q_sn, long long k_sb,
                                   long long k_st, long long k_sn, long long v_sb, long long v_st,
                                   long long v_sn, long long m_sb, long long m_st, float scale,
                                   void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.T = T;
  p.S = S;
  p.N = N;
  p.KH = KH;
  p.q_sb = q_sb;
  p.q_st = q_st;
  p.q_sn = q_sn;
  p.k_sb = k_sb;
  p.k_st = k_st;
  p.k_sn = k_sn;
  p.v_sb = v_sb;
  p.v_st = v_st;
  p.v_sn = v_sn;
  p.m_sb = m_sb;
  p.m_st = m_st;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 256) return launch<256>(p, s);
  if (H == 128) return launch<128>(p, s);
  return cudaErrorInvalidValue;
}
