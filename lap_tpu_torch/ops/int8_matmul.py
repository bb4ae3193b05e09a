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
"""

from __future__ import annotations

import ctypes
import math

import torch

SOURCE = "int8_matmul.cu"
# Contraction rows one block of the kernel covers at least (4 warps x 64).
K_UNIT = 256

# Launches of the CUDA kernel since the last reset (``launches = 0``).
launches = 0

_SIGNATURE = {"int8_matmul": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]}


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


def split_k(m_chunks: int, n_blocks: int, k_units: int, sms: int) -> int:
    """How many blocks share the contraction axis: the smallest divisor of
    ``k_units`` that gives at least two blocks per SM, or ``k_units``."""
    want = math.ceil(2 * sms / (m_chunks * n_blocks))
    for d in range(1, k_units + 1):
        if k_units % d == 0 and d >= want:
            return d
    return k_units


def rows_per_block(m: int) -> int:
    """Rows of x one block computes: one 8-row mma tile up to 8 rows, else two."""
    return 8 if m <= 8 else 16


def check_cuda_operands(x, k_multiple: int, n_multiple: int, *weights) -> None:
    """What both dequant kernels need of CUDA operands; raises otherwise."""
    m, k = x.shape
    n = weights[0].shape[-1]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bfloat16 activations, got {x.dtype}")
    if m == 0 or k % k_multiple or n % n_multiple:
        raise ValueError(f"the CUDA kernel takes M >= 1, K % {k_multiple} == 0 and N % {n_multiple} == 0; "
                         f"got M={m}, K={k}, N={n}")
    if x.data_ptr() % 4:
        raise ValueError("x must be 4-byte aligned")
    for t in weights:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("weights and scales must be contiguous and 16-byte aligned")


def _launch(x, w_i8, scales):
    global launches
    x = x.contiguous()
    check_cuda_operands(x, K_UNIT, 16, w_i8, scales)
    m, k = x.shape
    n = w_i8.shape[1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = split_k(math.ceil(m / rows_per_block(m)), math.ceil(n / 128), k // K_UNIT, sms)
    from lap_tpu_torch import cuda_build

    lib = cuda_build.load(SOURCE, _SIGNATURE)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    partial = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    err = lib.int8_matmul(
        x.data_ptr(), w_i8.data_ptr(), scales.data_ptr(), partial.data_ptr(), out.data_ptr(),
        m, n, k, splits, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int8_matmul launch failed with cudaError {err}")
    launches += 1
    return out


def int8_matmul(x: torch.Tensor, w_i8: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``x @ (w_i8 * scales)``. x: [M, K]; w_i8: [K, N] int8; scales: [N]
    float32. Returns [M, N] in x's dtype."""
    _check_shapes(x, w_i8, scales)
    if x.is_cuda:
        return _launch(x, w_i8, scales)
    return int8_matmul_plain(x, w_i8, scales)
