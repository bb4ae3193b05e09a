// Flash-attention backward for Hopper (sm_90a): two kernels, bf16 in and out.
//
// Replaces the Pallas TPU kernels lap_tpu/ops/flash_attention.py:_bwd_dq_kernel
// and :_bwd_dkv_kernel (launched by _flash_backward). With the forward's saved
// lse and delta = sum_h dO * O (computed by the wrapper in f32) they compute
//   s  = (q . k^T) * scale                      recomputed per tile, f32
//   p  = exp(s - lse) where mask, else 0; 0 for a row with lse <= -1.19e38
//   dp = dO . v^T,  ds = p * (dp - delta)
//   dQ = (ds . k) * scale
//   dV = sum over the GQA group of p^T . dO
//   dK = sum over the GQA group of (ds^T . q) * scale
// A fully masked query row gives dQ = 0 and an all-false key column gives
// dK = dV = 0, both exactly.
//
// What bounds them on the H100. At the LAP-3B training shape (T=692, S=708,
// N=8, K=1, H=256) the unmasked pairs need 6*N*H flops each for dQ and 8*N*H
// for dK/dV on a few tens of MB, far above the card's ~295 flop/byte ridge:
// both are bound by tensor-core operations.
//
// Design (simple and right first; wgmma, TMA and a pipeline come later):
// - The Pallas kernels carry their accumulators in VMEM scratch across a
//   sequential last grid axis. Here that axis is a loop inside the block.
// - dQ: one block of 4 warps per (64 queries, query head, batch); each warp
//   owns 16 query rows and keeps their 16 x H f32 dQ in registers while the
//   block walks the KV tiles of 32 keys. Q and dO stay in shared memory for
//   the whole loop; S and dP are C fragments that re-pack into the A fragment
//   of dS . K without leaving registers.
// - dK/dV: one block of 4 warps per (32 keys, KV head, batch). It loops over
//   the query heads of its GQA group and over query tiles of 32, so the group
//   sum happens in registers: one write of [B, S, K, H], no atomics, the same
//   bits on every run. Two f32 accumulators of 16 x H per warp do not fit in
//   registers at H = 256, so the warps split the head dim: warp (r, c) owns
//   key rows 16r..16r+15 and columns c*H/2..(c+1)*H/2 of dK and dV. Both
//   warps of a row pair compute the same S^T = K . Q^T and dP^T = V . dO^T
//   (full H contraction); the transposed products come out of the tensor
//   cores directly, and dO and Q then load with ldmatrix.trans.
// - P and dS are rounded to bf16 for the second products (the Pallas kernels
//   keep them in f32); accumulation is f32 throughout.
// - Tiles are zero-filled past the ends of T and S and the mask is
//   bounds-checked, so ragged shapes need no padding; a tile whose mask is
//   all false for the block is skipped.
// Head dims 128 and 256 are compiled; the wrapper raises on any other.

#include "flash_attention_common.cuh"

namespace {

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const uint8_t* mask;
  const __nv_bfloat16* dout;  // [B, T, N, H] contiguous
  const float* lse;           // [B, N, T]
  const float* delta;         // [B, N, T]
  __nv_bfloat16* dq;          // [B, T, N, H] contiguous
  __nv_bfloat16* dk;          // [B, S, KH, H] contiguous
  __nv_bfloat16* dv;          // [B, S, KH, H] contiguous
  int B, T, S, N, KH;
  int64_t q_sb, q_st, q_sn, k_sb, k_st, k_sn, v_sb, v_st, v_sn, m_sb, m_st;
  float scale;
};

// Stage mask[row0.., col0..] as a [ROWS, COLS] byte tile (0 past the ends).
// Returns whether this thread saw a true entry.
template <int ROWS, int COLS>
__device__ __forceinline__ int load_mask_tile(uint8_t* tile, const uint8_t* mask, int64_t stride,
                                              int row0, int rows, int col0, int cols) {
  int any = 0;
  for (int idx = threadIdx.x; idx < ROWS * COLS; idx += NUM_THREADS) {
    const int r = idx / COLS, c = idx % COLS;
    uint8_t bit = 0;
    if (row0 + r < rows && col0 + c < cols) bit = mask[(row0 + r) * stride + col0 + c] != 0;
    tile[idx] = bit;
    any |= bit;
  }
  return any;
}

__device__ __forceinline__ float prob(float s, float scale, float lse, bool keep) {
  return keep ? exp2f((s * scale - lse) * LOG2E) : 0.f;
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

constexpr int DQ_BLOCK_M = 64;
constexpr int DQ_BLOCK_N = 32;

template <int H>
__global__ void __launch_bounds__(NUM_THREADS) flash_bwd_dq_kernel(const Params p) {
  extern __shared__ uint4 smem[];
  constexpr int CHUNKS = H / 8;
  constexpr int BM = DQ_BLOCK_M, BN = DQ_BLOCK_N;
  uint4* sQ = smem;
  uint4* sDO = sQ + BM * CHUNKS;
  uint4* sK = sDO + BM * CHUNKS;
  uint4* sV = sK + BN * CHUNKS;
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sV + BN * CHUNKS);

  const int m0 = blockIdx.x * BM;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / (p.N / p.KH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  const __nv_bfloat16* q = p.q + b * p.q_sb + n * p.q_sn;
  const __nv_bfloat16* k = p.k + b * p.k_sb + kvh * p.k_sn;
  const __nv_bfloat16* v = p.v + b * p.v_sb + kvh * p.v_sn;
  const int64_t do_st = static_cast<int64_t>(p.N) * H;
  const __nv_bfloat16* dout = p.dout + (static_cast<int64_t>(b) * p.T * p.N + n) * H;
  const uint8_t* mask = p.mask + b * p.m_sb;

  load_tile<H, BM>(sQ, q + m0 * p.q_st, p.q_st, 0, p.T - m0);
  load_tile<H, BM>(sDO, dout + m0 * do_st, do_st, 0, p.T - m0);
  cp_async_commit();

  // lse and delta of this thread's rows g and g + 8; a row past T, or one
  // with no unmasked key, has p = 0 everywhere.
  float row_lse[2], row_delta[2];
  bool row_live[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = m0 + warp * 16 + g + hr * 8;
    const int64_t at = (static_cast<int64_t>(b) * p.N + n) * p.T + row;
    row_lse[hr] = row < p.T ? p.lse[at] : MASK_VALUE;
    row_delta[hr] = row < p.T ? p.delta[at] : 0.f;
    row_live[hr] = row_lse[hr] > MASK_VALUE / 2;
  }

  float dq[H / 8][4];
#pragma unroll
  for (int i = 0; i < H / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  const int num_tiles = (p.S + BN - 1) / BN;
  for (int j = 0; j < num_tiles; ++j) {
    const int n0 = j * BN;
    load_tile<H, BN>(sK, k + n0 * p.k_st, p.k_st, 0, p.S - n0);
    load_tile<H, BN>(sV, v + n0 * p.v_st, p.v_st, 0, p.S - n0);
    cp_async_commit();
    int any = load_mask_tile<BM, BN>(sMask, mask, p.m_st, m0, p.T, n0, p.S);
    cp_async_wait<0>();
    any = __syncthreads_or(any);

    if (any) {
      float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
        dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        uint32_t aq[4], ado[4];
        const int a_at = swz<H>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4));
        ldmatrix_x4(aq, smem_addr(sQ + a_at));
        ldmatrix_x4(ado, smem_addr(sDO + a_at));
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t bk[4], bv[4];
          const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int b_at = swz<H>(key, kk * 2 + ((lane >> 3) & 1));
          ldmatrix_x4(bk, smem_addr(sK + b_at));
          mma_16816(s[2 * np], aq, bk[0], bk[1]);
          mma_16816(s[2 * np + 1], aq, bk[2], bk[3]);
          ldmatrix_x4(bv, smem_addr(sV + b_at));
          mma_16816(dp[2 * np], ado, bv[0], bv[1]);
          mma_16816(dp[2 * np + 1], ado, bv[2], bv[3]);
        }
      }

      // s becomes dS = P * (dP - delta).
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = warp * 16 + g + hr * 8;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = i * 8 + t * 2 + e;
            const bool keep = row_live[hr] && sMask[row * BN + col];
            const float pr = prob(s[i][hr * 2 + e], p.scale, row_lse[hr], keep);
            s[i][hr * 2 + e] = pr * (dp[i][hr * 2 + e] - row_delta[hr]);
          }
        }
      }

      // dQ += dS . K
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t a[4];
        c_to_a(a, s, kk);
#pragma unroll
        for (int hp = 0; hp < H / 16; ++hp) {
          uint32_t bk[4];
          const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
          ldmatrix_x4_trans(bk, smem_addr(sK + swz<H>(key, hp * 2 + (lane >> 4))));
          mma_16816(dq[2 * hp], a, bk[0], bk[1]);
          mma_16816(dq[2 * hp + 1], a, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with sK, sV and sMask
  }
  cp_async_wait<0>();

  // Stage this warp's 16 rows in its own rows of sQ, then 16-byte stores.
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(sQ);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = warp * 16 + g + hr * 8;
#pragma unroll
    for (int i = 0; i < H / 8; ++i) {
      __nv_bfloat162 val =
          __floats2bfloat162_rn(dq[i][hr * 2] * p.scale, dq[i][hr * 2 + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(stage + swz<H>(row, i) * 8 + t * 2) = val;
    }
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * CHUNKS; idx += 32) {
    const int r = warp * 16 + idx / CHUNKS;
    const int c = idx % CHUNKS;
    if (m0 + r < p.T) {
      uint4* dst = reinterpret_cast<uint4*>(
          p.dq + ((static_cast<int64_t>(b) * p.T + m0 + r) * p.N + n) * H + c * 8);
      *dst = sQ[swz<H>(r, c)];
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV
// ---------------------------------------------------------------------------

constexpr int DKV_BLOCK_N = 32;  // keys per block
constexpr int DKV_BLOCK_M = 32;  // queries per loop step

template <int H>
__global__ void __launch_bounds__(NUM_THREADS) flash_bwd_dkv_kernel(const Params p) {
  extern __shared__ uint4 smem[];
  constexpr int CHUNKS = H / 8;
  constexpr int BM = DKV_BLOCK_M, BN = DKV_BLOCK_N;
  constexpr int HH = H / 2;  // columns of dK and dV owned by one warp
  uint4* sK = smem;
  uint4* sV = sK + BN * CHUNKS;
  uint4* sQ = sV + BN * CHUNKS;
  uint4* sDO = sQ + BM * CHUNKS;
  float* sLse = reinterpret_cast<float*>(sDO + BM * CHUNKS);
  float* sDelta = sLse + BM;
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sDelta + BM);  // [BM queries][BN keys]

  const int n0 = blockIdx.x * BN;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.N / p.KH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp & 1;   // which 16 key rows
  const int wc = warp >> 1;  // which half of the head dim

  const __nv_bfloat16* k = p.k + b * p.k_sb + kvh * p.k_sn;
  const __nv_bfloat16* v = p.v + b * p.v_sb + kvh * p.v_sn;
  const int64_t do_st = static_cast<int64_t>(p.N) * H;
  const uint8_t* mask = p.mask + b * p.m_sb;

  load_tile<H, BN>(sK, k + n0 * p.k_st, p.k_st, 0, p.S - n0);
  load_tile<H, BN>(sV, v + n0 * p.v_st, p.v_st, 0, p.S - n0);
  cp_async_commit();

  float dk[HH / 8][4], dv[HH / 8][4];
#pragma unroll
  for (int i = 0; i < HH / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  const int num_tiles = (p.T + BM - 1) / BM;
  for (int gi = 0; gi < group; ++gi) {
    const int n = kvh * group + gi;
    const __nv_bfloat16* q = p.q + b * p.q_sb + n * p.q_sn;
    const __nv_bfloat16* dout = p.dout + (static_cast<int64_t>(b) * p.T * p.N + n) * H;
    const int64_t row_base = (static_cast<int64_t>(b) * p.N + n) * p.T;

    for (int i = 0; i < num_tiles; ++i) {
      const int m0 = i * BM;
      load_tile<H, BM>(sQ, q + m0 * p.q_st, p.q_st, 0, p.T - m0);
      load_tile<H, BM>(sDO, dout + m0 * do_st, do_st, 0, p.T - m0);
      cp_async_commit();
      int any = load_mask_tile<BM, BN>(sMask, mask, p.m_st, m0, p.T, n0, p.S);
      if (threadIdx.x < BM) {
        const int row = m0 + threadIdx.x;
        sLse[threadIdx.x] = row < p.T ? p.lse[row_base + row] : MASK_VALUE;
        sDelta[threadIdx.x] = row < p.T ? p.delta[row_base + row] : 0.f;
      }
      cp_async_wait<0>();
      any = __syncthreads_or(any);

      if (any) {
        // S^T and dP^T for this warp's 16 keys against the BM queries.
        float st[BM / 8][4], dpt[BM / 8][4];
#pragma unroll
        for (int c = 0; c < BM / 8; ++c) {
          st[c][0] = st[c][1] = st[c][2] = st[c][3] = 0.f;
          dpt[c][0] = dpt[c][1] = dpt[c][2] = dpt[c][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < H / 16; ++kk) {
          uint32_t ak[4], av[4];
          const int a_at = swz<H>(wr * 16 + (lane & 15), kk * 2 + (lane >> 4));
          ldmatrix_x4(ak, smem_addr(sK + a_at));
          ldmatrix_x4(av, smem_addr(sV + a_at));
#pragma unroll
          for (int np = 0; np < BM / 16; ++np) {
            uint32_t bq[4], bdo[4];
            const int qrow = np * 16 + (lane & 7) + ((lane >> 4) << 3);
            const int b_at = swz<H>(qrow, kk * 2 + ((lane >> 3) & 1));
            ldmatrix_x4(bq, smem_addr(sQ + b_at));
            mma_16816(st[2 * np], ak, bq[0], bq[1]);
            mma_16816(st[2 * np + 1], ak, bq[2], bq[3]);
            ldmatrix_x4(bdo, smem_addr(sDO + b_at));
            mma_16816(dpt[2 * np], av, bdo[0], bdo[1]);
            mma_16816(dpt[2 * np + 1], av, bdo[2], bdo[3]);
          }
        }

        // st becomes P^T, dpt becomes dS^T (rows are keys, columns queries).
#pragma unroll
        for (int c = 0; c < BM / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = wr * 16 + g + (e >> 1) * 8;
            const int qc = c * 8 + t * 2 + (e & 1);
            const float lse = sLse[qc];
            const bool keep = lse > MASK_VALUE / 2 && sMask[qc * BN + key];
            const float pr = prob(st[c][e], p.scale, lse, keep);
            st[c][e] = pr;
            dpt[c][e] = pr * (dpt[c][e] - sDelta[qc]);
          }
        }

        // dV += P^T . dO and dK += dS^T . Q on this warp's half of H.
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) {
          uint32_t ap[4], ads[4];
          c_to_a(ap, st, kk);
          c_to_a(ads, dpt, kk);
#pragma unroll
          for (int hp = 0; hp < HH / 16; ++hp) {
            uint32_t bdo[4], bq[4];
            const int qrow = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
            const int b_at = swz<H>(qrow, wc * (HH / 8) + hp * 2 + (lane >> 4));
            ldmatrix_x4_trans(bdo, smem_addr(sDO + b_at));
            mma_16816(dv[2 * hp], ap, bdo[0], bdo[1]);
            mma_16816(dv[2 * hp + 1], ap, bdo[2], bdo[3]);
            ldmatrix_x4_trans(bq, smem_addr(sQ + b_at));
            mma_16816(dk[2 * hp], ads, bq[0], bq[1]);
            mma_16816(dk[2 * hp + 1], ads, bq[2], bq[3]);
          }
        }
      }
      __syncthreads();  // every warp is done with sQ, sDO, sMask, sLse, sDelta
    }
  }
  cp_async_wait<0>();  // K and V, when the loop ran no step

  // Stage dK in sQ and dV in sDO (BN == BM rows each), then 16-byte stores.
  static_assert(BN == BM, "the staging below reuses the query tiles");
  __nv_bfloat16* stage_k = reinterpret_cast<__nv_bfloat16*>(sQ);
  __nv_bfloat16* stage_v = reinterpret_cast<__nv_bfloat16*>(sDO);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = wr * 16 + g + hr * 8;
#pragma unroll
    for (int i = 0; i < HH / 8; ++i) {
      const int at = swz<H>(row, wc * (HH / 8) + i) * 8 + t * 2;
      *reinterpret_cast<__nv_bfloat162*>(stage_k + at) =
          __floats2bfloat162_rn(dk[i][hr * 2] * p.scale, dk[i][hr * 2 + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(stage_v + at) =
          __floats2bfloat162_rn(dv[i][hr * 2], dv[i][hr * 2 + 1]);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BN * CHUNKS; idx += NUM_THREADS) {
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    if (n0 + r < p.S) {
      const int64_t at = ((static_cast<int64_t>(b) * p.S + n0 + r) * p.KH + kvh) * H + c * 8;
      *reinterpret_cast<uint4*>(p.dk + at) = sQ[swz<H>(r, c)];
      *reinterpret_cast<uint4*>(p.dv + at) = sDO[swz<H>(r, c)];
    }
  }
}

// The dynamic shared memory attribute is per kernel: set it once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* configured) {
  if (*configured) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *configured = true;
  return err;
}

template <int H>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr int smem = (2 * DQ_BLOCK_M + 2 * DQ_BLOCK_N) * H * 2 + DQ_BLOCK_M * DQ_BLOCK_N;
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<H>, smem, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((p.T + DQ_BLOCK_M - 1) / DQ_BLOCK_M, p.N, p.B);
  flash_bwd_dq_kernel<H><<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr int smem = (2 * DKV_BLOCK_N + 2 * DKV_BLOCK_M) * H * 2 + 2 * DKV_BLOCK_M * 4 +
                       DKV_BLOCK_M * DKV_BLOCK_N;
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<H>, smem, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + DKV_BLOCK_N - 1) / DKV_BLOCK_N, p.KH, p.B);
  flash_bwd_dkv_kernel<H><<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, const void* mask,
                   const void* dout, const void* lse, const void* delta, int B, int T, int S,
                   int N, int KH, long long q_sb, long long q_st, long long q_sn, long long k_sb,
                   long long k_st, long long k_sn, long long v_sb, long long v_st, long long v_sn,
                   long long m_sb, long long m_st, float scale) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.mask = static_cast<const uint8_t*>(mask);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = nullptr;
  p.dk = nullptr;
  p.dv = nullptr;
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
  return p;
}

}  // namespace

extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* mask, const void* dout, const void* lse,
                                      const void* delta, void* dq, int B, int T, int S, int N,
                                      int KH, int H, long long q_sb, long long q_st,
                                      long long q_sn, long long k_sb, long long k_st,
                                      long long k_sn, long long v_sb, long long v_st,
                                      long long v_sn, long long m_sb, long long m_st, float scale,
                                      void* stream) {
  Params p = make_params(q, k, v, mask, dout, lse, delta, B, T, S, N, KH, q_sb, q_st, q_sn, k_sb,
                         k_st, k_sn, v_sb, v_st, v_sn, m_sb, m_st, scale);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 256) return launch_dq<256>(p, s);
  if (H == 128) return launch_dq<128>(p, s);
  return cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* mask, const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv, int B, int T, int S,
                                       int N, int KH, int H, long long q_sb, long long q_st,
                                       long long q_sn, long long k_sb, long long k_st,
                                       long long k_sn, long long v_sb, long long v_st,
                                       long long v_sn, long long m_sb, long long m_st,
                                       float scale, void* stream) {
  Params p = make_params(q, k, v, mask, dout, lse, delta, B, T, S, N, KH, q_sb, q_st, q_sn, k_sb,
                         k_st, k_sn, v_sb, v_st, v_sn, m_sb, m_st, scale);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 256) return launch_dkv<256>(p, s);
  if (H == 128) return launch_dkv<128>(p, s);
  return cudaErrorInvalidValue;
}
