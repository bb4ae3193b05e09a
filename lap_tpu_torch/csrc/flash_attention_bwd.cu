// Flash-attention backward for Hopper (sm_90a): bf16 in and out.
//
// Replaces the Pallas TPU kernels lap_tpu/ops/flash_attention.py:_bwd_dq_kernel
// and :_bwd_dkv_kernel (launched by _flash_backward), and the delta that
// _flash_backward computes before them. With the forward's saved lse they
// compute
//   delta = sum_h dO * O                        f32 (flash_bwd_delta_kernel)
//   s  = (q . k^T) * scale                      recomputed per tile, f32
//   p  = exp(s - lse) where mask, else 0; 0 for a row with lse <= -1.19e38
//   dp = dO . v^T,  ds = p * (dp - delta)
//   dQ = (ds . k) * scale
//   dV = sum over the GQA group of p^T . dO
//   dK = sum over the GQA group of (ds^T . q) * scale
// A fully masked query row gives dQ = 0 and an all-false key column gives
// dK = dV = 0, both exactly.
//
// What bounds them on the H100. At the LAP-3B training shape (B=8, T=692,
// S=708, N=8, K=1, H=256) the unmasked pairs need 6*N*H flops each for dQ and
// 8*N*H for dK/dV on a few tens of MB, far above the card's ~295 flop/byte
// ridge: both are bound by tensor-core operations. The delta pass and the
// group sum move bytes only.
//
// Design (mma.sync m16n8k16 bf16 with f32 sums; no atomics, so two calls give
// the same bits). Figures at H = 256 (H = 128 halves every tile and
// accumulator); registers and spills from nvcc -Xptxas -v, resident blocks
// from the occupancy query, both on an H100 (chip_smoke.py prints them).
// - The Pallas kernels carry their accumulators in VMEM scratch across a
//   sequential last grid axis. Here that axis is a loop inside the block.
// - Copies overlap the math through a cp.async ring: the prologue issues the
//   first STAGES - 1 tiles; step i waits until tile i has landed
//   (cp.async.wait_group STAGES - 2), passes one block-wide barrier (which
//   also ORs "any unmasked entry" and frees the stage of tile i - 1), issues
//   tile i + STAGES - 1 into that stage, then computes tile i. Each thread
//   reads the mask entries of its own fragment positions straight into
//   registers, one tile ahead, and packs them into bits after the math, so
//   the mask needs no shared memory and its loads hide behind a tile.
// - Every ldmatrix address is a per-lane register plus a constant: the
//   swizzle only permutes aligned groups of 8 chunks (chunk_offsets).
// - dQ: one block of 4 warps per (64 queries, query head, batch); each warp
//   owns 16 query rows and keeps their 16 x H f32 dQ in registers. Q and dO
//   stay in shared memory; K and V arrive in tiles of 16 keys in a ring of 3
//   stages: 64 + 48 = 112 KB. S and dP are C fragments that re-pack into the
//   A fragment of dS . K without leaving registers. 229 registers, no spill,
//   2 blocks an SM; 704 blocks at the training shape, 2.7 waves of 264.
// - dK/dV: one block of 8 warps per (32 keys, query head, batch): 1,472
//   blocks at the training shape, 5.6 waves of 264. Q, dO, lse and
//   delta arrive in tiles of 32 queries in a ring of 2 stages: K and V 32 KB,
//   2 x 32.25 KB of tiles, 8 KB for P and dS = 104.5 KB (a third stage would
//   leave one block an SM). 128 registers (the cap of two 256-thread blocks
//   an SM), no spill, 2 blocks an SM. Each of S^T = K . Q^T and dP^T = V .
//   dO^T is computed once: warp (role, q, k) computes the 16 x 16 quarter
//   (keys 16 k.., queries 16 q..) of S^T (role 0) or dP^T (role 1); the
//   transposed products come out of the tensor cores directly. The S^T warp
//   turns its quarter into P and hands it in f32 to the dP^T warp of the same
//   quarter, whose fragments sit at the same positions, and rounds P^T to
//   bf16 into shared memory; after a barrier the dP^T warp forms dS^T = P^T
//   (dP^T - delta) and rounds it likewise. After a second barrier each warp
//   accumulates dV += P^T . dO and dK += dS^T . Q for all 32 keys and one
//   eighth of H (two 32 x 32 f32 accumulators, 64 registers): each B
//   fragment feeds both 16-key halves.
// - The GQA group sum across blocks: with a group G > 1 each block writes its
//   head's f32 dK (already scaled) and dV into scratch [2, B, S, N, H] that
//   the wrapper allocates; flash_bwd_group_sum_kernel adds the G heads of each
//   group in the order 0..G-1 and writes bf16 [B, S, K, H]. With G = 1 the
//   kernel writes bf16 directly and no pass runs. One head a block: a pair
//   of heads a block (half the scratch, half the grid, the pair summed in
//   registers) was slower on the H100, and so were 64 keys a block (16
//   warps, one block an SM) and a warp per 16 x 32 half of S^T or dP^T (4
//   warps a block).
// - delta: one warp per (b, t, n) row, 16-byte loads of dO and O, f32 sum by
//   shuffles, [B, N, T] out.
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
  float* partial;             // [2, B, S, N, H] f32 when N > KH, else null
  int B, T, S, N, KH;
  int64_t q_sb, q_st, q_sn, k_sb, k_st, k_sn, v_sb, v_st, v_sn, m_sb, m_st;
  float scale;
};

// 4-byte async copy (lse and delta rows); src_bytes == 0 writes zeros.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ float prob(float s, float scale, float lse, bool keep) {
  return keep ? exp2f((s * scale - lse) * LOG2E) : 0.f;
}

__device__ __forceinline__ uint8_t mask_at(const uint8_t* mask, int64_t stride, int row, int rows,
                                           int col, int cols) {
  return row < rows && col < cols ? mask[row * stride + col] : 0;
}

// Byte offsets of chunks 2 i + hi (i = 0..3) of a row r of a swizzled tile
// (swz): the swizzle permutes each aligned group of 8 chunks, so chunk
// 2 kk + hi of the row sits at x[kk % 4] + 128 (kk / 4) bytes from the row's
// start, a register plus a constant once kk is unrolled.
__device__ __forceinline__ void chunk_offsets(uint32_t (&x)[4], int hi, int r) {
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = (((2 * i + hi) ^ (r & 7)) * 16);
}

template <int N>
__device__ __forceinline__ uint32_t pack_bits(const uint8_t (&m)[N]) {
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) bits |= static_cast<uint32_t>(m[i] != 0) << i;
  return bits;
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

constexpr int DQ_BLOCK_M = 64;
constexpr int DQ_BLOCK_N = 16;
constexpr int DQ_STAGES = 3;

template <int H>
__global__ void __launch_bounds__(NUM_THREADS, 2) flash_bwd_dq_kernel(const Params p) {
  extern __shared__ uint4 smem[];
  constexpr int CHUNKS = H / 8;
  constexpr int BM = DQ_BLOCK_M, BN = DQ_BLOCK_N, STAGES = DQ_STAGES;
  constexpr int NT = BN / 8;        // 8-key C tiles across a key tile
  constexpr int ENTRIES = 2 * NT * 2;  // mask entries of a thread's fragments
  uint4* sQ = smem;
  uint4* sDO = sQ + BM * CHUNKS;
  uint4* sK = sDO + BM * CHUNKS;       // [STAGES][BN * CHUNKS]
  uint4* sV = sK + STAGES * BN * CHUNKS;

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
  const int num_tiles = (p.S + BN - 1) / BN;

  auto issue = [&](int j) {
    if (j < num_tiles) {
      const int stage = j % STAGES, n0 = j * BN;
      load_tile<H, BN>(sK + stage * BN * CHUNKS, k + n0 * p.k_st, p.k_st, 0, p.S - n0);
      load_tile<H, BN>(sV + stage * BN * CHUNKS, v + n0 * p.v_st, p.v_st, 0, p.S - n0);
    }
    cp_async_commit();
  };
  // Entry (hr, i, e) is row g + 8 hr, key 8 i + 2 t + e of the warp's tile.
  auto load_mask = [&](uint8_t (&m)[ENTRIES], int j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          m[(hr * NT + i) * 2 + e] = mask_at(mask, p.m_st, m0 + warp * 16 + g + hr * 8, p.T,
                                             j * BN + i * 8 + t * 2 + e, p.S);
  };

  load_tile<H, BM>(sQ, q + m0 * p.q_st, p.q_st, 0, p.T - m0);
  load_tile<H, BM>(sDO, dout + m0 * do_st, do_st, 0, p.T - m0);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) issue(j);

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
  uint32_t bits;
  {
    uint8_t m[ENTRIES];
    load_mask(m, 0);
    bits = pack_bits(m);
  }

  float dq[H / 8][4];
#pragma unroll
  for (int i = 0; i < H / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  // ldmatrix addresses: every lane's rows have row % 8 == lane % 8.
  uint32_t xa[4], xb[4];
  chunk_offsets(xa, lane >> 4, lane);
  chunk_offsets(xb, (lane >> 3) & 1, lane);
  const uint32_t a_q = smem_addr(sQ + (warp * 16 + (lane & 15)) * CHUNKS);
  constexpr uint32_t DO_BYTES = BM * CHUNKS * 16;  // sDO - sQ
  const uint32_t b_row = ((lane & 7) + ((lane >> 4) << 3)) * CHUNKS * 16;
  const uint32_t bt_row = ((lane & 7) + (((lane >> 3) & 1) << 3)) * CHUNKS * 16;

  for (int j = 0; j < num_tiles; ++j) {
    cp_async_wait<STAGES - 2>();
    const int any = __syncthreads_or(bits != 0);  // tile j is in; tile j - 1's stage is free
    issue(j + STAGES - 1);
    uint8_t next[ENTRIES];
    load_mask(next, j + 1);  // rows and keys past the ends read nothing

    if (any) {
      const uint32_t k_at = smem_addr(sK + (j % STAGES) * BN * CHUNKS);
      constexpr uint32_t V_BYTES = STAGES * BN * CHUNKS * 16;  // sV - sK
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
        dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        uint32_t aq[4], ado[4];
        const uint32_t a_at = a_q + xa[kk % 4] + kk / 4 * 128;
        ldmatrix_x4(aq, a_at);
        ldmatrix_x4(ado, a_at + DO_BYTES);
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t bk[4], bv[4];
          const uint32_t b_at = k_at + b_row + np * 16 * CHUNKS * 16 + xb[kk % 4] + kk / 4 * 128;
          ldmatrix_x4(bk, b_at);
          mma_16816(s[2 * np], aq, bk[0], bk[1]);
          mma_16816(s[2 * np + 1], aq, bk[2], bk[3]);
          ldmatrix_x4(bv, b_at + V_BYTES);
          mma_16816(dp[2 * np], ado, bv[0], bv[1]);
          mma_16816(dp[2 * np + 1], ado, bv[2], bv[3]);
        }
      }

      // s becomes dS = P * (dP - delta).
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
        for (int i = 0; i < NT; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool keep = row_live[hr] && ((bits >> ((hr * NT + i) * 2 + e)) & 1);
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
          ldmatrix_x4_trans(bk, k_at + bt_row + kk * 16 * CHUNKS * 16 + xa[hp % 4] + hp / 4 * 128);
          mma_16816(dq[2 * hp], a, bk[0], bk[1]);
          mma_16816(dq[2 * hp + 1], a, bk[2], bk[3]);
        }
      }
    }
    bits = pack_bits(next);
  }
  cp_async_wait<0>();

  // Stage this warp's 16 rows in its own rows of sQ (no other warp reads
  // them), then 16-byte stores.
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
constexpr int DKV_STAGES = 2;
constexpr int DKV_WARPS = 8;
constexpr int DKV_THREADS = DKV_WARPS * 32;

// Offset, in 16-byte chunks, of (row, chunk) in a [32][32] bf16 tile (4
// chunks a row), swizzled so that 8 rows of one chunk column hit 8 different
// bank groups.
__device__ __forceinline__ int pswz(int row, int chunk) {
  return row * 4 + (chunk ^ ((row >> 1) & 3));
}

template <int H>
__global__ void __launch_bounds__(DKV_THREADS, 2) flash_bwd_dkv_kernel(const Params p) {
  extern __shared__ uint4 smem[];
  constexpr int CHUNKS = H / 8;
  constexpr int BM = DKV_BLOCK_M, BN = DKV_BLOCK_N, STAGES = DKV_STAGES;
  constexpr int HE = H / DKV_WARPS;  // columns of dK and dV owned by one warp
  static_assert(BM == 32 && BN == 32 && DKV_WARPS == 8, "the warp layout and pswz assume 32 x 32 tiles");
  uint4* sK = smem;
  uint4* sV = sK + BN * CHUNKS;
  uint4* sQ = sV + BN * CHUNKS;            // [STAGES][BM * CHUNKS]
  uint4* sDO = sQ + STAGES * BM * CHUNKS;  // [STAGES][BM * CHUNKS]
  uint4* sP = sDO + STAGES * BM * CHUNKS;  // P^T, [BN keys][BM queries] bf16
  uint4* sDS = sP + BN * BM / 8;           // dS^T, the same layout
  float* sPf = reinterpret_cast<float*>(sDS + BN * BM / 8);  // f32 P, [4 quarters][8][32 lanes]
  float* sLse = sPf + BN * BM;                               // [STAGES][BM]
  float* sDelta = sLse + STAGES * BM;                        // [STAGES][BM]

  const int n0 = blockIdx.x * BN;
  const int n = blockIdx.y;  // query head
  const int b = blockIdx.z;
  const int kvh = n / (p.N / p.KH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp & 1;         // key rows 16 wr.. of S^T or dP^T
  const int wq = (warp >> 1) & 1;  // query columns 16 wq..
  const int role = warp >> 2;      // 0: S^T and P, 1: dP^T and dS

  const __nv_bfloat16* k = p.k + b * p.k_sb + kvh * p.k_sn;
  const __nv_bfloat16* v = p.v + b * p.v_sb + kvh * p.v_sn;
  const __nv_bfloat16* q = p.q + b * p.q_sb + n * p.q_sn;
  const int64_t do_st = static_cast<int64_t>(p.N) * H;
  const __nv_bfloat16* dout = p.dout + (static_cast<int64_t>(b) * p.T * p.N + n) * H;
  const int64_t row_base = (static_cast<int64_t>(b) * p.N + n) * p.T;
  const uint8_t* mask = p.mask + b * p.m_sb;
  const int num_tiles = (p.T + BM - 1) / BM;

  auto issue = [&](int i) {
    if (i < num_tiles) {
      const int stage = i % STAGES, m0 = i * BM;
      load_tile<H, BM, DKV_THREADS>(sQ + stage * BM * CHUNKS, q + m0 * p.q_st, p.q_st, 0, p.T - m0);
      load_tile<H, BM, DKV_THREADS>(sDO + stage * BM * CHUNKS, dout + m0 * do_st, do_st, 0, p.T - m0);
      // Rows past T read zeros: their mask entries are 0, so lse is unused.
      if (threadIdx.x < 2 * BM) {
        const int r = threadIdx.x % BM;
        const bool valid = m0 + r < p.T;
        const float* src = (threadIdx.x < BM ? p.lse : p.delta) + row_base + (valid ? m0 + r : 0);
        float* dst = (threadIdx.x < BM ? sLse : sDelta) + stage * BM + r;
        cp_async_4(smem_addr(dst), src, valid ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  // The S^T warps' C fragment positions: entry c * 4 + e is key 16 wr + g +
  // 8 (e >> 1), query 16 wq + 8 c + 2 t + (e & 1). The dP^T warps need no mask.
  auto load_mask = [&](uint8_t (&m)[8], int i) {
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        m[c * 4 + e] = role ? 0
                            : mask_at(mask, p.m_st, i * BM + wq * 16 + c * 8 + t * 2 + (e & 1), p.T,
                                      n0 + wr * 16 + g + (e >> 1) * 8, p.S);
  };

  load_tile<H, BN, DKV_THREADS>(sK, k + n0 * p.k_st, p.k_st, 0, p.S - n0);
  load_tile<H, BN, DKV_THREADS>(sV, v + n0 * p.v_st, p.v_st, 0, p.S - n0);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  uint32_t bits;
  {
    uint8_t m[8];
    load_mask(m, 0);
    bits = pack_bits(m);
  }

  // dk[r], dv[r]: key rows 16 r.., columns HE warp.. of dK and dV.
  float dk[2][HE / 8][4], dv[2][HE / 8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < HE / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[r][i][e] = dv[r][i][e] = 0.f;

  __nv_bfloat16* p_t = reinterpret_cast<__nv_bfloat16*>(sP);
  __nv_bfloat16* ds_t = reinterpret_cast<__nv_bfloat16*>(sDS);
  float* pf = sPf + (wr * 2 + wq) * 8 * 32 + lane;  // this lane's f32 P entries, stride 32

  // ldmatrix addresses: every lane's rows have row % 8 == lane % 8 (pswz rows:
  // (row >> 1) % 4 == (lane >> 1) % 4).
  uint32_t xa[4], xb[4];
  chunk_offsets(xa, lane >> 4, lane);
  chunk_offsets(xb, (lane >> 3) & 1, lane);
  const uint32_t a_at = smem_addr((role ? sV : sK) + (wr * 16 + (lane & 15)) * CHUNKS);
  const uint32_t b_row = (wq * 16 + (lane & 7) + ((lane >> 4) << 3)) * CHUNKS * 16;
  uint32_t pa[2][2], bt[HE / 16];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) pa[r][kk] = smem_addr(sP + pswz(r * 16 + (lane & 15), kk * 2 + (lane >> 4)));
#pragma unroll
  for (int hp = 0; hp < HE / 16; ++hp)
    bt[hp] = swz<H>((lane & 7) + (((lane >> 3) & 1) << 3), warp * (HE / 8) + hp * 2 + (lane >> 4)) * 16;
  constexpr uint32_t DS_BYTES = BN * BM * 2;  // sDS - sP
  for (int i = 0; i < num_tiles; ++i) {
    cp_async_wait<STAGES - 2>();
    const int any = __syncthreads_or(bits != 0);  // tile i is in; tile i - 1's stage is free
    issue(i + STAGES - 1);
    uint8_t next[8];

    if (any) {
      const int stage = i % STAGES;
      const uint4* sQs = sQ + stage * BM * CHUNKS;
      const uint4* sDOs = sDO + stage * BM * CHUNKS;

      // One product per warp, computed once: a 16 x 16 quarter of S^T = K .
      // Q^T (role 0) or dP^T = V . dO^T (role 1), keys 16 wr.., queries 16 wq...
      const uint32_t b_at = smem_addr(role ? sDOs : sQs) + b_row;
      float acc[2][4];
#pragma unroll
      for (int c = 0; c < 2; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        uint32_t a[4], bb[4];
        ldmatrix_x4(a, a_at + xa[kk % 4] + kk / 4 * 128);
        ldmatrix_x4(bb, b_at + xb[kk % 4] + kk / 4 * 128);
        mma_16816(acc[0], a, bb[0], bb[1]);
        mma_16816(acc[1], a, bb[2], bb[3]);
      }

      // P^T (f32 to the dP^T warp of the same quarter, whose fragments sit at
      // the same positions, and bf16 to sP), then dS^T = P^T (dP^T - delta).
      if (role == 0) {
        const float* lse = sLse + stage * BM;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = wq * 16 + c * 8 + t * 2 + (e & 1);
            const bool keep = lse[qc] > MASK_VALUE / 2 && ((bits >> (c * 4 + e)) & 1);
            acc[c][e] = prob(acc[c][e], p.scale, lse[qc], keep);
            pf[(c * 4 + e) * 32] = acc[c][e];
          }
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            *reinterpret_cast<uint32_t*>(p_t + pswz(wr * 16 + g + hr * 8, wq * 2 + c) * 8 + t * 2) =
                pack_bf16(acc[c][hr * 2], acc[c][hr * 2 + 1]);
        }
      }
      __syncthreads();
      if (role == 1) {
        const float* delta = sDelta + stage * BM;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[c][e] = pf[(c * 4 + e) * 32] * (acc[c][e] - delta[wq * 16 + c * 8 + t * 2 + (e & 1)]);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            *reinterpret_cast<uint32_t*>(ds_t + pswz(wr * 16 + g + hr * 8, wq * 2 + c) * 8 + t * 2) =
                pack_bf16(acc[c][hr * 2], acc[c][hr * 2 + 1]);
        }
      }
      __syncthreads();
      load_mask(next, i + 1);  // the loads' latency hides behind the products below

      // dV += P^T . dO and dK += dS^T . Q on all 32 keys and this warp's
      // eighth of H: each B fragment feeds both key halves.
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        uint32_t ap[2][4], ads[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          ldmatrix_x4(ap[r], pa[r][kk]);
          ldmatrix_x4(ads[r], pa[r][kk] + DS_BYTES);
        }
#pragma unroll
        for (int hp = 0; hp < HE / 16; ++hp) {
          uint32_t bdo[4], bq[4];
          const uint32_t at = bt[hp] + kk * 16 * CHUNKS * 16;
          ldmatrix_x4_trans(bdo, smem_addr(sDOs) + at);
          ldmatrix_x4_trans(bq, smem_addr(sQs) + at);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mma_16816(dv[r][2 * hp], ap[r], bdo[0], bdo[1]);
            mma_16816(dv[r][2 * hp + 1], ap[r], bdo[2], bdo[3]);
            mma_16816(dk[r][2 * hp], ads[r], bq[0], bq[1]);
            mma_16816(dk[r][2 * hp + 1], ads[r], bq[2], bq[3]);
          }
        }
      }
    } else {
      load_mask(next, i + 1);
    }
    bits = pack_bits(next);
  }
  cp_async_wait<0>();

  // Rows 16 r + g (+ 8), columns HE warp + 8 i + 2 t (+ 1) of dK and dV.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = n0 + r * 16 + g + hr * 8;
      if (key >= p.S) continue;
      if (p.partial != nullptr) {
        const int64_t half = static_cast<int64_t>(p.B) * p.S * p.N * H;
        float* pk =
            p.partial + ((static_cast<int64_t>(b) * p.S + key) * p.N + n) * H + warp * HE + t * 2;
#pragma unroll
        for (int i = 0; i < HE / 8; ++i) {
          *reinterpret_cast<float2*>(pk + i * 8) =
              make_float2(dk[r][i][hr * 2] * p.scale, dk[r][i][hr * 2 + 1] * p.scale);
          *reinterpret_cast<float2*>(pk + half + i * 8) =
              make_float2(dv[r][i][hr * 2], dv[r][i][hr * 2 + 1]);
        }
      } else {
        const int64_t at =
            ((static_cast<int64_t>(b) * p.S + key) * p.KH + kvh) * H + warp * HE + t * 2;
#pragma unroll
        for (int i = 0; i < HE / 8; ++i) {
          *reinterpret_cast<uint32_t*>(p.dk + at + i * 8) =
              pack_bf16(dk[r][i][hr * 2] * p.scale, dk[r][i][hr * 2 + 1] * p.scale);
          *reinterpret_cast<uint32_t*>(p.dv + at + i * 8) =
              pack_bf16(dv[r][i][hr * 2], dv[r][i][hr * 2 + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The GQA group sum and delta
// ---------------------------------------------------------------------------

constexpr int PASS_THREADS = 256;

// dk/dv[b, s, kh, h] = bf16(sum over gi = 0..G-1 in order of
// partial[0/1, b, s, kh * G + gi, h]); one thread per 4 outputs.
__global__ void __launch_bounds__(PASS_THREADS)
    flash_bwd_group_sum_kernel(const float* __restrict__ partial, __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int64_t outputs, int G, int H) {
  const int64_t idx = (static_cast<int64_t>(blockIdx.x) * PASS_THREADS + threadIdx.x) * 4;
  if (idx >= 2 * outputs) return;
  const int which = idx >= outputs;
  const int64_t at = idx - which * outputs;  // in [B, S, KH, H]
  const int64_t row = at / H;                // (b, s, kh)
  const int h = static_cast<int>(at % H);
  const float* src = partial + which * outputs * G + row * G * H + h;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int gi = 1; gi < G; ++gi) {
    const float4 x = *reinterpret_cast<const float4*>(src + gi * H);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  uint2 out;
  out.x = pack_bf16(acc.x, acc.y);
  out.y = pack_bf16(acc.z, acc.w);
  *reinterpret_cast<uint2*>((which ? dv : dk) + at) = out;
}

// delta[b, n, t] = sum_h dO[b, t, n, h] * O[b, t, n, h] in f32; one warp a row.
__global__ void __launch_bounds__(PASS_THREADS)
    flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ dout, const __nv_bfloat16* __restrict__ out,
                           float* __restrict__ delta, int64_t rows, int T, int N, int H, int64_t o_sb,
                           int64_t o_st, int64_t o_sn) {
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * PASS_THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int n = static_cast<int>(r % N);
  const int t = static_cast<int>((r / N) % T);
  const int64_t b = r / (static_cast<int64_t>(N) * T);
  const __nv_bfloat16* d = dout + r * H;
  const __nv_bfloat16* o = out + b * o_sb + t * o_st + n * o_sn;
  float acc = 0.f;
  for (int c = lane; c < H / 8; c += 32) {
    const uint4 x = *reinterpret_cast<const uint4*>(d + c * 8);
    const uint4 y = *reinterpret_cast<const uint4*>(o + c * 8);
    const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(xs[i]);
      const float2 c2 = __bfloat1622float2(ys[i]);
      acc = fmaf(a.x, c2.x, acc);
      acc = fmaf(a.y, c2.y, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(b * N + n) * T + t] = acc;
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

template <int H>
constexpr int dq_smem() {
  return (2 * DQ_BLOCK_M + 2 * DQ_STAGES * DQ_BLOCK_N) * H * 2;
}
template <int H>
constexpr int dkv_smem() {
  return (2 * DKV_BLOCK_N + 2 * DKV_STAGES * DKV_BLOCK_M) * H * 2 + 2 * DKV_BLOCK_N * DKV_BLOCK_M * 2 +
         DKV_BLOCK_N * DKV_BLOCK_M * 4 + 2 * DKV_STAGES * DKV_BLOCK_M * 4;
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
cudaError_t prepare_dq() {
  static bool configured = false;
  return allow_smem(flash_bwd_dq_kernel<H>, dq_smem<H>(), &configured);
}
template <int H>
cudaError_t prepare_dkv() {
  static bool configured = false;
  return allow_smem(flash_bwd_dkv_kernel<H>, dkv_smem<H>(), &configured);
}

template <int H>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  cudaError_t err = prepare_dq<H>();
  if (err != cudaSuccess) return err;
  dim3 grid((p.T + DQ_BLOCK_M - 1) / DQ_BLOCK_M, p.N, p.B);
  flash_bwd_dq_kernel<H><<<grid, NUM_THREADS, dq_smem<H>(), stream>>>(p);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  cudaError_t err = prepare_dkv<H>();
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + DKV_BLOCK_N - 1) / DKV_BLOCK_N, p.N, p.B);
  flash_bwd_dkv_kernel<H><<<grid, DKV_THREADS, dkv_smem<H>(), stream>>>(p);
  return cudaGetLastError();
}

// Registers, local (spill) bytes, dynamic shared memory and resident blocks
// per SM of one compiled kernel.
template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, int threads, int smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = smem;
  out[3] = blocks;
  return cudaSuccess;
}

template <int H>
cudaError_t info(int which, int* out) {
  cudaError_t err = which == 0 ? prepare_dq<H>() : prepare_dkv<H>();
  if (err != cudaSuccess) return err;
  return which == 0 ? kernel_info(flash_bwd_dq_kernel<H>, NUM_THREADS, dq_smem<H>(), out)
                    : kernel_info(flash_bwd_dkv_kernel<H>, DKV_THREADS, dkv_smem<H>(), out);
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
  p.partial = nullptr;
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

// partial: f32 scratch [2, B, S, N, H] when N > KH (then the group-sum pass
// must follow), else null and dk, dv are written directly.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* mask, const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv, void* partial,
                                       int B, int T, int S, int N, int KH, int H, long long q_sb,
                                       long long q_st, long long q_sn, long long k_sb,
                                       long long k_st, long long k_sn, long long v_sb,
                                       long long v_st, long long v_sn, long long m_sb,
                                       long long m_st, float scale, void* stream) {
  if ((partial == nullptr) != (N == KH)) return cudaErrorInvalidValue;
  Params p = make_params(q, k, v, mask, dout, lse, delta, B, T, S, N, KH, q_sb, q_st, q_sn, k_sb,
                         k_st, k_sn, v_sb, v_st, v_sn, m_sb, m_st, scale);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.partial = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 256) return launch_dkv<256>(p, s);
  if (H == 128) return launch_dkv<128>(p, s);
  return cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_group_sum(const void* partial, void* dk, void* dv, int B,
                                             int S, int KH, int G, int H, void* stream) {
  if (H % 4) return cudaErrorInvalidValue;
  const int64_t outputs = static_cast<int64_t>(B) * S * KH * H;
  const int64_t blocks = (2 * outputs / 4 + PASS_THREADS - 1) / PASS_THREADS;
  flash_bwd_group_sum_kernel<<<static_cast<unsigned>(blocks), PASS_THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), outputs, G, H);
  return cudaGetLastError();
}

extern "C" int flash_attention_bwd_delta(const void* dout, const void* out, void* delta, int B,
                                         int T, int N, int H, long long o_sb, long long o_st,
                                         long long o_sn, void* stream) {
  if (H % 8) return cudaErrorInvalidValue;
  const int64_t rows = static_cast<int64_t>(B) * T * N;
  const int64_t blocks = (rows * 32 + PASS_THREADS - 1) / PASS_THREADS;
  flash_bwd_delta_kernel<<<static_cast<unsigned>(blocks), PASS_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dout), static_cast<const __nv_bfloat16*>(out),
      static_cast<float*>(delta), rows, T, N, H, o_sb, o_st, o_sn);
  return cudaGetLastError();
}

// out[0..3] = registers a thread, local bytes a thread (spills), dynamic
// shared memory bytes and resident blocks per SM of the dQ (which = 0) or
// dK/dV (which = 1) kernel at head dim H.
extern "C" int flash_attention_bwd_info(int which, int H, int* out) {
  if (H == 256) return info<256>(which, out);
  if (H == 128) return info<128>(which, out);
  return cudaErrorInvalidValue;
}
