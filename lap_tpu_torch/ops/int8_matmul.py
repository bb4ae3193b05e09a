"""Weight-only int8 dequant matmul: a hand-written CUDA kernel and its plain version.

Replaces the Pallas TPU kernel of ``lap_tpu/ops/int8_matmul.py`` (``_kernel``,
launched from ``int8_matmul``) by ``lap_tpu_torch/csrc/int8_matmul.cu``; the
source's header gives the design.

Quantization is symmetric per output channel: ``scale[n] = absmax_k / 127``
(1.0 for an all-zero column), ``w_i8 = clip(round(w / scale), -127, 127)``
with round half to even, so ``w ~= w_i8 * scale``. The scale is computed as
``absmax * float32(1 / 127)``: that is how XLA compiles JAX's
``absmax / 127.0`` under ``jit``, where the JAX package builds its quantized
weights (eager JAX divides, and ~4% of the scales then differ by one ulp).
The product is ``(x @ w_i8) * scale`` with the sum in float32 and the scale
applied once to the float32 sum, cast to the dtype of ``x``.

The wrapper takes the plain version only for CPU tensors. On a CUDA tensor it
launches the kernel or raises: the kernel takes bfloat16 activations only.
This module also holds what the int8 and int4 kernels share: the launch plan
(``launch_plan``, mirroring ``csrc/dequant_matmul_common.cuh``), the launch
(``launch_kernel``) and the split-K arrival counters (``splitk_counters``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

SOURCE = "int8_matmul.cu"

# Launches of the CUDA kernel since the last reset (``launches = 0``).
launches = 0

# Launch geometry of both dequant kernels; mirrors the constants of
# ``csrc/dequant_matmul_common.cuh`` (``kernel_info`` reads the compiled
# kernels' own figures on the card).
CHUNK_ROWS = 64  # weight rows of one ring stage
BLOCK_N = 128  # weight bytes of a stage row: the columns of one block
STAGES = 4
THREADS = 512  # 16 warps: 4 column groups x 4 parts of a chunk's rows
# Resident blocks an SM the plan counts on: __launch_bounds__(512, 2) keeps a
# thread at 64 registers, so two blocks fit the register file.
MIN_BLOCKS_PER_SM = 2
ROW_BYTES = BLOCK_N + 16  # a padded stage row, for the weight and for x
W_STAGE_BYTES = CHUNK_ROWS * ROW_BYTES
SCALE_STAGE_BYTES = 2 * BLOCK_N * 4  # int4: the scale rows of the low and the high half
# Weight bytes the plan keeps in flight on each SM (or the whole weight, if
# smaller): 3.35 TB/s over 132 SMs at ~1 us of loaded latency needs ~25 KB.
IN_FLIGHT_PER_SM = 40 * 1024
# Hopper: shared memory of an SM (the runtime reserves 1 KB of it for each
# resident block), and the most one block may take.
SM_SHARED_BYTES = 228 * 1024
BLOCK_RESERVED_SHARED = 1024
BLOCK_SHARED_MAX = 227 * 1024
H100_SMS = 132
# Arrival counters of the in-kernel split-K sum, one int per (row tile,
# column block) of a call; one zeroed buffer per device, shared by both
# kernels (their launches on one stream never overlap), left zero by each call.
COUNTER_SLOTS = 1 << 16

_COUNTERS: dict = {}

_SIGNATURE = {
    "int8_matmul": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "int8_matmul_info": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
}


def float32_reciprocal(c: float) -> torch.Tensor:
    """float32(1 / c), the constant XLA multiplies by in place of ``/ c``."""
    return torch.tensor(1.0 / c, dtype=torch.float32)


def quantize_int8(w: torch.Tensor, axis: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 quantization of a 2-D weight matrix.

    Returns ``(w_i8, scales)`` with ``w ~= w_i8 * scales``; ``scales`` has one
    float32 entry per output channel (``axis`` is the contraction axis).
    """
    if w.dim() != 2:
        raise ValueError(f"expected 2-D weights, got {tuple(w.shape)}")
    wf = w.float()
    absmax = wf.abs().amax(dim=axis, keepdim=True)
    scales = torch.where(absmax > 0, absmax * float32_reciprocal(127.0), torch.ones_like(absmax))
    w_i8 = torch.clamp(torch.round(wf / scales), -127, 127).to(torch.int8)
    return w_i8, scales.squeeze(axis)


def int8_matmul_plain(x: torch.Tensor, w_i8: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (``int8_matmul_reference`` of the JAX package):
    ``(x.f32 @ w_i8.f32) * scale`` cast to the dtype of ``x``."""
    y = x.float() @ w_i8.float()
    return (y * scales.float()[None, :]).to(x.dtype)


def _check_shapes(x, w_i8, scales):
    if x.dim() != 2 or w_i8.dim() != 2:
        raise ValueError(f"x must be [M, K] and w [K, N], got {tuple(x.shape)} and {tuple(w_i8.shape)}")
    if x.shape[1] != w_i8.shape[0] or tuple(scales.shape) != (w_i8.shape[1],):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, w {tuple(w_i8.shape)}, scales {tuple(scales.shape)}")
    if w_i8.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError("w must be int8 and scales float32")
    if not (x.device == w_i8.device == scales.device):
        raise ValueError("x, w and scales must be on one device")


@functools.lru_cache(maxsize=None)
def launch_plan(kind: str, m: int, k: int, n: int, group: int | None = None, sms: int = H100_SMS) -> dict:
    """Launch geometry of the ``kind`` ("int8" or "int4") dequant kernel for
    x [m, k] and a weight of n columns (int4: ``group`` contraction rows a
    scale): a block for each row tile (8 or 16 rows), 128 columns and split
    of the weight's rows (int4: packed rows, K/2) into runs of 64-row
    chunks; two blocks are resident on an SM. It takes the fewest splits (a
    divisor of the chunks that leaves a split at least STAGES - 1 chunks, so
    that its ring fills) with which the blocks keep ``IN_FLIGHT_PER_SM``
    bytes of weight in flight on every SM, or the whole weight if that is
    smaller. Raises ValueError on shapes the kernel cannot take."""
    if kind not in ("int8", "int4"):
        raise ValueError(f"kind must be int8 or int4, got {kind!r}")
    if m < 1 or n < 1 or n % 16:
        raise ValueError(f"the CUDA kernel takes M >= 1 and N % 16 == 0; got M={m}, N={n}")
    if kind == "int8":
        if k < 1 or k % CHUNK_ROWS:
            raise ValueError(f"the int8 kernel takes K % {CHUNK_ROWS} == 0, got K={k}")
        weight_rows = k
    else:
        if group is None or group < CHUNK_ROWS or group % CHUNK_ROWS:
            raise ValueError(f"the int4 kernel takes groups of a multiple of {CHUNK_ROWS} rows, got {group}")
        if k < 1 or k % 2 or (k // 2) % group:
            raise ValueError(f"the int4 kernel takes K with K/2 a multiple of the group {group}, got K={k}")
        weight_rows = k // 2
    rows_per_tile = 8 if m <= 8 else 16
    row_tiles, col_blocks = -(-m // rows_per_tile), -(-n // BLOCK_N)
    halves = 2 if kind == "int4" else 1
    stage = W_STAGE_BYTES + halves * rows_per_tile * ROW_BYTES + (SCALE_STAGE_BYTES if kind == "int4" else 0)
    smem = STAGES * stage
    blocks_per_sm = min(MIN_BLOCKS_PER_SM, SM_SHARED_BYTES // (smem + BLOCK_RESERVED_SHARED))
    chunks = weight_rows // CHUNK_ROWS
    tiles = row_tiles * col_blocks
    chunk_bytes = CHUNK_ROWS * BLOCK_N
    want = min(sms * IN_FLIGHT_PER_SM, tiles * chunks * chunk_bytes)

    def in_flight(splits):
        resident = min(tiles * splits, sms * blocks_per_sm)
        return resident * min(STAGES - 1, chunks // splits) * chunk_bytes

    candidates = [d for d in range(1, chunks + 1) if chunks % d == 0 and (d == 1 or chunks // d >= STAGES - 1)]
    splits = next((d for d in candidates if in_flight(d) >= want), candidates[-1])
    counter_slots = tiles if splits > 1 else 0
    if counter_slots > COUNTER_SLOTS:
        raise ValueError(f"{counter_slots} tiles need more split-K counters than the {COUNTER_SLOTS} there are")
    return dict(
        rows_per_tile=rows_per_tile, grid=(row_tiles, col_blocks, splits), splits=splits, chunks=chunks,
        chunks_per_split=chunks // splits, smem=smem, blocks_per_sm=blocks_per_sm,
        in_flight_per_sm=in_flight(splits) / sms, counter_slots=counter_slots,
        partial_shape=(splits, m, n) if splits > 1 else None,
    )


def splitk_counters(device) -> torch.Tensor:
    """The zeroed arrival counters of ``device``, allocated on first use.
    ``cuda`` names the current card, so it keys the same counters as
    ``cuda:<index>``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _COUNTERS:
        _COUNTERS[device] = torch.zeros(COUNTER_SLOTS, dtype=torch.int32, device=device)
    return _COUNTERS[device]


def check_cuda_operands(x, *weights) -> None:
    """What both dequant kernels need of CUDA operands; raises otherwise."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bfloat16 activations, got {x.dtype}")
    for t in (x, *weights):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("x, weights and scales must be contiguous and 16-byte aligned")


def launch_kernel(source, signature, kind, x, weights, n, group=None):
    """Plan, build (at first use), allocate and launch the ``kind`` dequant
    kernel of ``source`` on x and its weight operands; returns out [M, N]
    bf16. Raises on what the kernel cannot take."""
    from lap_tpu_torch import cuda_build

    check_cuda_operands(x, *weights)
    m, k = x.shape
    plan = launch_plan(kind, m, k, n, group, torch.cuda.get_device_properties(x.device).multi_processor_count)
    fn = getattr(cuda_build.load(source, signature), f"{kind}_matmul")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    partial = None if plan["partial_shape"] is None else torch.empty(
        plan["partial_shape"], dtype=torch.float32, device=x.device)
    err = fn(
        x.data_ptr(), *(t.data_ptr() for t in weights), None if partial is None else partial.data_ptr(),
        out.data_ptr(), splitk_counters(x.device).data_ptr(), m, n, k,
        *(() if group is None else (group,)), plan["rows_per_tile"], plan["splits"],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{kind}_matmul launch failed with cudaError {err}")
    return out


def kernel_info(source, signature, kind, rows_per_tile) -> dict:
    """Registers and local (spill) bytes a thread, dynamic shared memory and
    resident blocks per SM of the compiled ``kind`` kernel for 8 or 16 rows
    a tile, on the current card."""
    from lap_tpu_torch import cuda_build

    lib = cuda_build.load(source, signature)
    out = (ctypes.c_int * 4)()
    err = getattr(lib, f"{kind}_matmul_info")(rows_per_tile, out)
    if err != 0:
        raise RuntimeError(f"{kind}_matmul_info failed with cudaError {err}")
    return dict(registers=out[0], local_bytes=out[1], smem=out[2], blocks_per_sm=out[3])


def info(rows_per_tile: int) -> dict:
    """``kernel_info`` of the int8 kernel."""
    return kernel_info(SOURCE, _SIGNATURE, "int8", rows_per_tile)


def _launch(x, w_i8, scales):
    global launches
    out = launch_kernel(SOURCE, _SIGNATURE, "int8", x.contiguous(), (w_i8, scales), w_i8.shape[1])
    launches += 1
    return out


def int8_matmul(x: torch.Tensor, w_i8: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``x @ (w_i8 * scales)``. x: [M, K]; w_i8: [K, N] int8; scales: [N]
    float32. Returns [M, N] in x's dtype."""
    _check_shapes(x, w_i8, scales)
    if x.is_cuda:
        return _launch(x, w_i8, scales)
    return int8_matmul_plain(x, w_i8, scales)
