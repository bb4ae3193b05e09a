// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out + f32 lse.
//
// Replaces the Pallas TPU kernel lap_tpu/ops/flash_attention.py:53
// _fwd_kernel (launched by _flash_forward). It computes the same function:
//   s   = (q . k^T) * scale in f32, masked to -2.3819763e38 where mask == 0
//   out = softmax(s) . v, lse = logsumexp(s) per query row
// with GQA through kv head n / (N / K), and zeros plus lse = -2.3819763e38
// for a query row whose keys are all masked.
//
// What bounds it on the H100. Only the unmasked (query, key) pairs need the
// two products: 4 * N * H flops a pair. At the LAP-3B prefill (B=1, T=S=692,
// N=8, K=1, H=256, 552 live tokens) that is 2.5 GFLOP on ~6.9 MB, at the
// training call (B=8, T=692 of 708-row tensors, S=708) 24.6 GFLOP on ~57 MB:
// far above the card's ~295 flop/byte ridge, so bound by tensor-core
// operations (3.2 and 24.8 us at 989 TFLOP/s). What keeps a kernel from that
// bound at these sizes is the work around the products: few blocks at batch
// 1, copies and mask reads on the critical path, per-tile barriers, and
// tensor cores left idle while the softmax runs.
//
// Design. A block owns 128 query rows of one (query head, batch) and walks
// 64-key tiles; it has three warpgroups (384 threads, one block an SM):
// - Producer warpgroup (40 registers a thread after setmaxnreg). Thread 0
//   brings each tile's K and V by TMA: 2 x H / 64 boxes of 64 keys x 128
//   bytes, written in the 128-byte swizzle that wgmma reads, zeros past S,
//   counted in bytes at the stage's `full` barrier. Every thread copies one
//   row of the tile's int8 mask with 16-byte cp.async copies (a mask row is
//   not 16-byte aligned in general: the training mask's rows are 708 bytes
//   apart, so each row's window starts at the 16-byte boundary below the
//   tile's first column, 5 copies a row, bytes past S and rows past T
//   zero-filled by the copy). The producer then classifies the tile by a
//   vote over its rows: for each consumer warpgroup whether any entry is
//   unmasked, and whether every entry is; and arrives on `full`. A ring of
//   2 stages (Q 64 KB + 2 x (32 + 32 + 10) KB = 212 KB at H = 256): the
//   producer fills a stage again once the 8 consumer warps have arrived on
//   its `empty` barrier, so tile i + 1 is in flight while tile i computes.
// - Two consumer warpgroups (232 registers a thread): warpgroup w owns rows
//   64 w .. 64 w + 63 and keeps their 64 x H f32 output in registers. Q is
//   copied to shared memory once a block and stays there. Per tile:
//   S = Q K^T by 16 (H = 256) wgmma.m64n64k16 with Q and K from shared
//   memory; the online softmax in f32 in base 2 (logits times scale *
//   log2 e: one FFMA and one ex2 an entry); P rounded to bf16 in registers
//   as the A operand of 4 wgmma.m64n256k16 (m64n128k16 at H = 128) with V
//   from shared memory through the descriptor's transpose bit. Tiles that
//   are all false for a warpgroup's rows are skipped, all-true tiles skip
//   the per-element select, mixed tiles read the mask from shared memory;
//   the rescale of the running output is skipped by a warp when no row's
//   max changed. The warpgroups meet no block-wide barrier in the loop, so
//   one's softmax runs while the other's products do.
// - The grid: one block a 128-row tile of one (query head, batch), walking
//   every key tile; it writes bf16 out and lse directly (the output staged
//   through the Q tile, 16-byte stores). At the LAP-3B prefill that is 48
//   blocks on 132 SMs (40 with live rows), each walking 9 live key tiles
//   with its two warpgroups overlapping; at the training shape 384 blocks in
//   2.9 waves. Cutting the keys of a row tile
//   into splits that the tile's last block merges (an arrival counter per
//   tile) filled the card at batch 1 but measured no faster there: the
//   merge (the partials' store, the counter, one block reading them back)
//   cost what the shorter walk saved (PERF.md), so the kernel has no split.
// - P is rounded to bf16 for the P . V product (the Pallas kernel keeps P
//   in f32); row sums are taken in f32 before the rounding.
// Registers, spills and resident blocks are read by flash_attention_fwd_info.
// Head dims 128 and 256 are compiled; the wrapper raises on any other.

#include <cuda.h>  // CUtensorMap and its encoder's signature; the encoder comes from the runtime

#include "flash_attention_common.cuh"

namespace {

constexpr int FWD_WARPS = 8;  // consumer warps: two warpgroups
constexpr int FWD_CONSUMERS = FWD_WARPS / 4;
constexpr int CONSUMER_THREADS = FWD_WARPS * 32;
constexpr int FWD_THREADS = CONSUMER_THREADS + 128;  // and the producer warpgroup
// Registers a thread after the role split (setmaxnreg): 128 x 40 + 256 x 232 <= 64 K.
constexpr int FWD_PRODUCER_REGS = 40, FWD_CONSUMER_REGS = 232;
constexpr int FWD_BLOCK_M = 16 * FWD_WARPS;  // query rows a block
constexpr int FWD_BLOCK_N = 64;              // keys a tile
constexpr int FWD_STAGES = 2;
constexpr int MASK_LD = FWD_BLOCK_N + 16;    // bytes of a mask row's window
constexpr int MASK_CHUNKS = MASK_LD / 16;
constexpr float LN2 = 0.6931471805599453f;

constexpr int SMEM_ALIGN = 1024;  // the 128-byte swizzle repeats every 8 rows of 128 bytes

// Q, the stages (K, V, mask), 64 bytes of votes, classes and barriers, and
// room to align the tiles to 1024 bytes.
template <int H>
constexpr int fwd_smem() {
  return FWD_BLOCK_M * H * 2 + FWD_STAGES * (2 * FWD_BLOCK_N * H * 2 + FWD_BLOCK_M * MASK_LD) + 64 + SMEM_ALIGN;
}

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const uint8_t* mask;
  __nv_bfloat16* out;    // [B, T, N, H] contiguous
  float* lse;            // [B, N, T]
  int B, T, S, N, KH;
  int64_t q_sb, q_st, q_sn, k_sb, k_st, k_sn, v_sb, v_st, v_sn, m_sb, m_st;
  float scale;
};

// Offset, in 16-byte chunks, of chunk c of row r of a bf16 tile of ROWS rows
// in wgmma's K-major layout with the 128-byte swizzle: H / 64 column blocks
// of [ROWS][128 bytes], each row's chunk c % 8 XOR-ed with the row % 8.
template <int ROWS>
__device__ __forceinline__ int wswz(int r, int c) {
  return (c >> 3) * ROWS * 8 + r * 8 + ((c & 7) ^ (r & 7));
}

// Async copy of ROWS rows of a [rows, H] bf16 matrix with row stride
// `stride` (elements) into a tile of that layout; rows past `rows` are zeros.
template <int H, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_w(uint4* tile, const __nv_bfloat16* base, int64_t stride, int rows) {
  constexpr int CHUNKS = H / 8;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    const bool valid = r < rows;
    cp_async_16(smem_addr(tile + wswz<ROWS>(r, c)), valid ? base + r * stride + c * 8 : base, valid ? 16 : 0);
  }
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at shared
// address `addr` (1024-byte aligned atoms): `lbo` and `sbo` in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
// Adds `bytes` to the barrier's expected transaction count (no arrival).
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// One arrival (release: the thread's earlier writes are visible to the waiters).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
// Waits until phase `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
// TMA: box (c0, c1, c2, c3) of a 4-d tensor map into shared memory at
// `dst`, counted in bytes at the barrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, uint64_t map, uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d += a . b^T for a 64 x 16 A tile and a 64 x 16 B tile, both K-major in
// shared memory (descriptors), f32 accumulators.
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[8][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

// d += a . b for a 64 x 16 A tile in registers (mma.sync A fragments, one
// warp's 16 rows each) and a 16 x 128 B tile, N-major in shared memory
// (descriptor, transposed), f32 accumulators.
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[16][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a . b for a 64 x 16 A tile in registers (mma.sync A fragments, one
// warp's 16 rows each) and a 16 x 256 B tile, N-major in shared memory
// (descriptor, transposed), f32 accumulators.
__device__ __forceinline__ void wgmma_m64n256_rs(float (&d)[32][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]), "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]), "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]), "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]), "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]), "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int H>
__device__ __forceinline__ void wgmma_pv(float (&d)[H / 8][4], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (H == 256) {
    wgmma_m64n256_rs(d, a, b);
  } else {
    wgmma_m64n128_rs(d, a, b);
  }
}

// 2^x (ex2.approx: 2 ulp; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The value, opaque to the compiler: keeps a descriptor base from being
// hoisted out of the tile loop with all its offsets (16 registers each).
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("mov.b64 %0, %0;\n" : "+l"(x));
  return x;
}

// Bytes [lo, hi) of a 64-bit word, 0 <= lo, hi <= 8.
__device__ __forceinline__ uint64_t byte_range(int lo, int hi) {
  const uint64_t below_hi = hi >= 8 ? ~0ull : (1ull << (8 * hi)) - 1;
  const uint64_t below_lo = lo >= 8 ? ~0ull : (1ull << (8 * lo)) - 1;
  return lo >= hi ? 0ull : below_hi & ~below_lo;
}

template <int H>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    flash_fwd_kernel(const Params p, const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map) {
  extern __shared__ uint4 smem_raw[];
  constexpr int CHUNKS = H / 8;
  constexpr int BM = FWD_BLOCK_M, BN = FWD_BLOCK_N;
  constexpr int TILE = BN * CHUNKS;  // uint4s of a K or V tile
  uint4* smem = smem_raw + ((SMEM_ALIGN - (smem_addr(smem_raw) & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1)) / 16;
  uint4* sQ = smem;
  uint4* sKV = sQ + BM * CHUNKS;  // [STAGES][K, V][TILE]
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sKV + FWD_STAGES * 2 * TILE);  // [STAGES][BM][MASK_LD]
  uint8_t* sVote = sMask + FWD_STAGES * BM * MASK_LD;  // [STAGES][4 producer warps], then [STAGES] tile classes
  uint8_t* sClass = sVote + FWD_STAGES * 4;
  const uint32_t full = smem_addr(sClass + 8);  // [STAGES] mbarriers: tile landed and classified
  const uint32_t empty = full + 8 * FWD_STAGES;  // [STAGES] mbarriers: every consumer warp is done with it

  const int m0 = blockIdx.x * BM;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / (p.N / p.KH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;

  const int num = (p.S + BN - 1) / BN;  // key tiles

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < FWD_STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, FWD_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_tile_w<H, BM, FWD_THREADS>(sQ, p.q + b * p.q_sb + n * p.q_sn + m0 * p.q_st, p.q_st, p.T - m0);
  cp_async_commit();
  cp_async_wait<0>();
  // Q arrived by cp.async (generic proxy); wgmma reads it through the async proxy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (wg == FWD_CONSUMERS) {
    // The producer warpgroup: K and V of each tile by TMA (thread 0: 2 x H /
    // 64 boxes of 64 keys x 128 bytes in the 128-byte swizzle, zeros past S),
    // the mask by cp.async (thread r copies the 16-byte aligned window of
    // row r), then the tile's class, then the tile's full barrier.
    setmaxnreg_dec<FWD_PRODUCER_REGS>();
    const int r = threadIdx.x - FWD_CONSUMERS * 128;
    const uint8_t* m_row = p.mask + b * p.m_sb + static_cast<int64_t>(min(m0 + r, p.T - 1)) * p.m_st;
    const int m_off = static_cast<int>(reinterpret_cast<uintptr_t>(m_row) & 15);
    const uint8_t* m_win = m_row - m_off;  // the row's aligned window at key 0
    const bool m_live = m0 + r < p.T;
    const uint32_t m_dst = smem_addr(sMask + r * MASK_LD);
    for (int i = 0; i < num; ++i) {
      const int stage = i % FWD_STAGES;
      const int n0 = i * BN;
      if (i >= FWD_STAGES) mbar_wait(empty + 8 * stage, (i / FWD_STAGES - 1) & 1);
      if (r == 0) {
        const uint32_t kd = smem_addr(sKV + (2 * stage) * TILE);
        mbar_expect_tx(full + 8 * stage, 2 * TILE * 16);
#pragma unroll
        for (int hb = 0; hb < H / 64; ++hb) {
          tma_load(kd + hb * BN * 128, reinterpret_cast<uint64_t>(&k_map), full + 8 * stage, 64 * hb, n0, kvh, b);
          tma_load(kd + TILE * 16 + hb * BN * 128, reinterpret_cast<uint64_t>(&v_map), full + 8 * stage, 64 * hb, n0,
                   kvh, b);
        }
      }
#pragma unroll
      for (int c = 0; c < MASK_CHUNKS; ++c) {
        const int64_t left = p.S - (n0 + 16 * c - m_off);  // bytes of the row from the copy's start
        const int bytes = !m_live || left <= 0 ? 0 : left >= 16 ? 16 : static_cast<int>(left);
        cp_async_16(m_dst + stage * BM * MASK_LD + 16 * c, m_win + n0 + 16 * c, bytes);
      }
      cp_async_commit();
      cp_async_wait<0>();
      // Vote: bytes [lo, hi) of copy c are the tile's columns of row r.
      bool any = false, all = true;
      const uint8_t* src = sMask + stage * BM * MASK_LD + r * MASK_LD;
#pragma unroll
      for (int c = 0; c < MASK_CHUNKS; ++c) {
        const int lo = m_off - 16 * c, hi = BN + m_off - 16 * c;
        const uint4 words = *reinterpret_cast<const uint4*>(src + 16 * c);
        const uint64_t in0 = byte_range(max(0, min(8, lo)), max(0, min(8, hi)));
        const uint64_t in1 = byte_range(max(0, min(8, lo - 8)), max(0, min(8, hi - 8)));
        const uint64_t w0 = (static_cast<uint64_t>(words.y) << 32 | words.x) & in0;
        const uint64_t w1 = (static_cast<uint64_t>(words.w) << 32 | words.z) & in1;
        any |= (w0 | w1) != 0;  // bool bytes are 0 or 1
        all &= w0 == (0x0101010101010101ull & in0) && w1 == (0x0101010101010101ull & in1);
      }
      any = __any_sync(0xffffffff, any);
      all = __all_sync(0xffffffff, all);
      const int pw = r / 32;  // producer warps 0, 1 hold rows of consumer warpgroup 0; 2, 3 of 1
      if (lane == 0) sVote[stage * 4 + pw] = static_cast<uint8_t>(any | (all << 1));
      named_barrier(1, 128);  // every row's mask and vote is in
      if (r == 0) {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(sVote + stage * 4);
        const bool any0 = (v & 0x0101u) != 0, any1 = (v & 0x01010000u) != 0;
        const bool every = (v & 0x02020202u) == 0x02020202u;
        sClass[stage] = static_cast<uint8_t>(any0 | (any1 << 1) | (every << 2));
        mbar_arrive(full + 8 * stage);
      }
    }
  } else {
    // The consumer warpgroups: warpgroup wg owns query rows 64 wg .. 64 wg + 63,
    // warp (warp % 4) of it 16 of them.
    setmaxnreg_inc<FWD_CONSUMER_REGS>();
    const int g = lane >> 2;  // row within an 8-row group of a fragment
    const int t = lane & 3;   // column pair within a fragment
    // Offsets of this thread's fragment rows g and g + 8 into their mask windows.
    int moff[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int64_t row = min(m0 + warp * 16 + g + hr * 8, p.T - 1);
      moff[hr] = static_cast<int>(reinterpret_cast<uintptr_t>(p.mask + b * p.m_sb + row * p.m_st) & 15);
    }
    // wgmma descriptors: Q and K K-major (A and B of S = Q K^T; chunks of
    // 16 k a k-step), V N-major (B of O += P V, transposed: its 64-column
    // blocks are BN * 128 bytes apart, LBO; 8-key groups 1024, SBO).
    const uint32_t q_base = smem_addr(sQ) + wg * 64 * 128;
    const uint32_t kv_base = smem_addr(sKV);
    float o[H / 8][4];
#pragma unroll
    for (int i = 0; i < H / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    float row_max[2] = {-INFINITY, -INFINITY};  // in units of log2 (logit * scale * log2 e)
    const float scale_log2 = p.scale * LOG2E;
    float row_sum[2] = {0.f, 0.f};

    for (int i = 0; i < num; ++i) {
      const int stage = i % FWD_STAGES;
      mbar_wait(full + 8 * stage, (i / FWD_STAGES) & 1);  // K, V, the mask and the class of tile i
      const int cls = sClass[stage];
      if (!((cls >> wg) & 1)) {  // all false for this warpgroup's rows
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * stage);
        continue;
      }
      // Mixed tile: bit (hr * 16 + c * 2 + e) is the mask of row g + 8 hr,
      // column 8 c + 2 t + e.
      uint32_t bits = 0xffffffffu;
      if (!(cls & 4)) {
        bits = 0;
        const uint8_t* ms = sMask + stage * BM * MASK_LD;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const uint8_t* row = ms + (warp * 16 + g + hr * 8) * MASK_LD + moff[hr] + 2 * t;
#pragma unroll
          for (int c = 0; c < BN / 8; ++c)
#pragma unroll
            for (int e = 0; e < 2; ++e) bits |= static_cast<uint32_t>(row[c * 8 + e] != 0) << (hr * 16 + c * 2 + e);
        }
      }

      const uint32_t k_at = kv_base + stage * 2 * TILE * 16;
      const uint32_t v_at = k_at + TILE * 16;
      float s[BN / 8][4];
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.f;
      // Descriptors advance in their address field (16-byte units): k-step kk
      // reads column block kk / 4 (rows x 128 bytes each), bytes 32 (kk % 4).
      const uint64_t qd = opaque(smem_desc(q_base, 16, 1024));
      const uint64_t kd = opaque(smem_desc(k_at, 16, 1024));
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        wgmma_m64n64_ss(s, qd + (((kk / 4) * BM * 128 + (kk % 4) * 32) >> 4),
                        kd + (((kk / 4) * BN * 128 + (kk % 4) * 32) >> 4));
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);

      // Mask, online softmax in base 2 (logits times scale * log2 e, so one
      // FFMA and one ex2 an entry); s becomes the unnormalised probabilities.
      float corr[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float tile_max = -INFINITY;
#pragma unroll
        for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool keep = (bits >> (hr * 16 + c * 2 + e)) & 1u;
            const float x = keep ? s[c][hr * 2 + e] * scale_log2 : -INFINITY;
            s[c][hr * 2 + e] = x;
            tile_max = fmaxf(tile_max, x);
          }
        }
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffff, tile_max, 1));
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffff, tile_max, 2));
        const float new_max = fmaxf(row_max[hr], tile_max);
        const float use_max = new_max == -INFINITY ? 0.f : new_max;
        corr[hr] = fast_exp2(row_max[hr] - use_max);
        row_max[hr] = new_max;
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pr = fast_exp2(s[c][hr * 2 + e] - use_max);
            s[c][hr * 2 + e] = pr;
            sum += pr;
          }
        }
        row_sum[hr] = row_sum[hr] * corr[hr] + sum;
      }
      if (__any_sync(0xffffffff, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int c = 0; c < H / 8; ++c) {
          o[c][0] *= corr[0];
          o[c][1] *= corr[0];
          o[c][2] *= corr[1];
          o[c][3] *= corr[1];
        }
      }

      const uint64_t vd = opaque(smem_desc(v_at, BN * 128, 1024));
      uint32_t pa[BN / 16][4];  // P in bf16, the A fragments of the four k-steps
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) c_to_a(pa[kk], s, kk);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_pv<H>(o, pa[kk], vd + ((kk * 16 * 128) >> 4));
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);  // this warp is done with the stage
    }

    float l[2], lse[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] = row_sum[hr];
      l[hr] += __shfl_xor_sync(0xffffffff, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffff, l[hr], 2);
      lse[hr] = l[hr] == 0.f ? MASK_VALUE : (row_max[hr] + log2f(l[hr])) * LN2;
      l[hr] = l[hr] == 0.f ? 0.f : 1.f / l[hr];  // now the inverse
    }

    named_barrier(2, CONSUMER_THREADS);  // every warpgroup's products are done with sQ
    // Normalise; stage this warp's 16 rows in sQ (row-major, swizzled).
    __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(sQ);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = warp * 16 + g + hr * 8;
#pragma unroll
      for (int c = 0; c < H / 8; ++c) {
        // Column c*8 + t*2 lies in chunk c, element t*2.
        const __nv_bfloat162 val = __floats2bfloat162_rn(o[c][hr * 2] * l[hr], o[c][hr * 2 + 1] * l[hr]);
        *reinterpret_cast<__nv_bfloat162*>(stage + swz<H>(row, c) * 8 + t * 2) = val;
      }
      if (t == 0 && m0 + row < p.T) p.lse[(static_cast<int64_t>(b) * p.N + n) * p.T + m0 + row] = lse[hr];
    }
    __syncwarp();
    for (int idx = lane; idx < 16 * CHUNKS; idx += 32) {
      const int r = warp * 16 + idx / CHUNKS;
      const int c = idx % CHUNKS;
      if (m0 + r < p.T) {
        *reinterpret_cast<uint4*>(p.out + ((static_cast<int64_t>(b) * p.T + m0 + r) * p.N + n) * H + c * 8) =
            sQ[swz<H>(r, c)];
      }
    }
  }
}

template <int H>
cudaError_t prepare() {
  static bool configured = false;  // the attribute is per kernel, set once
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         fwd_smem<H>());
  configured = err == cudaSuccess;
  return err;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no link to libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// Tensor map of K or V [B, S, KH, H] (element strides sb, st, sn, 1): boxes of
// 64 columns x 64 keys in the 128-byte swizzle, zeros past S.
cudaError_t kv_map(CUtensorMap* map, const __nv_bfloat16* base, const Params& p, int H, int64_t sb, int64_t st,
                   int64_t sn) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(p.S), static_cast<cuuint64_t>(p.KH),
                              static_cast<cuuint64_t>(p.B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st) * 2, static_cast<cuuint64_t>(sn) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, FWD_BLOCK_N, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<__nv_bfloat16*>(base), dims, strides,
                            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int H>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  CUtensorMap k_map, v_map;
  cudaError_t err = kv_map(&k_map, p.k, p, H, p.k_sb, p.k_st, p.k_sn);
  if (err == cudaSuccess) err = kv_map(&v_map, p.v, p, H, p.v_sb, p.v_st, p.v_sn);
  if (err != cudaSuccess) return err;
  err = prepare<H>();
  if (err != cudaSuccess) return err;
  dim3 grid((p.T + FWD_BLOCK_M - 1) / FWD_BLOCK_M, p.N, p.B);
  flash_fwd_kernel<H><<<grid, FWD_THREADS, fwd_smem<H>(), stream>>>(p, k_map, v_map);
  return cudaGetLastError();
}

template <int H>
cudaError_t info(int* out) {
  cudaError_t err = prepare<H>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, flash_fwd_kernel<H>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_fwd_kernel<H>, FWD_THREADS, fwd_smem<H>());
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = fwd_smem<H>();
  out[3] = blocks;
  return cudaSuccess;
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                   void* out, void* lse, int B, int T, int S, int N, int KH, int H,
                                   long long q_sb, long long q_st, long long q_sn, long long k_sb, long long k_st,
                                   long long k_sn, long long v_sb, long long v_st, long long v_sn, long long m_sb,
                                   long long m_st, float scale, void* stream) {
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

// out[0..3] = registers a thread, local bytes a thread (spills), dynamic
// shared memory bytes and resident blocks per SM of the kernel at head dim H.
extern "C" int flash_attention_fwd_info(int H, int* out) {
  if (H == 256) return info<256>(out);
  if (H == 128) return info<128>(out);
  return cudaErrorInvalidValue;
}
