"""Weight-only int4 dequant matmul: a hand-written CUDA kernel and its plain version.

Replaces the Pallas TPU kernel of ``lap_tpu/ops/int4_matmul.py`` (``_kernel``,
launched from ``int4_matmul``) by ``lap_tpu_torch/csrc/int4_matmul.cu``; the
source's header gives the design.

Quantization is group-wise and symmetric: the contraction axis is cut into
groups of ``group_size`` rows, and each (group, output channel) pair gets the
scale ``absmax / 7`` (1.0 for an all-zero group); values are rounded half to
even and clipped to [-7, 7]. Packing: the K rows split into a low half
``[0, K/2)`` and a high half ``[K/2, K)``; byte ``packed[i, n]`` holds row
``i`` in its low nibble and row ``K/2 + i`` in its high nibble. Scales are
``[K / group_size, N]`` float32. As for int8, the scale is
``absmax * float32(1 / 7)``, as XLA compiles JAX's ``absmax / 7.0``. The
product is ``sum_g (x_g @ w_g) * scale_g`` in float32, cast to the dtype of
``x``.

The wrapper takes the plain version only for CPU tensors. On a CUDA tensor it
launches the kernel or raises: the kernel takes bfloat16 activations only.
"""

from __future__ import annotations

import ctypes

import torch

from lap_tpu_torch.ops.int8_matmul import float32_reciprocal, kernel_info, launch_kernel

SOURCE = "int4_matmul.cu"

# Launches of the CUDA kernel since the last reset (``launches = 0``).
launches = 0

_SIGNATURE = {
    "int4_matmul": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "int4_matmul_info": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
}


def unpack_nibbles(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 [Kp, N] -> (lo, hi) int32 values in [-8, 7], each nibble read as
    a two's-complement 4-bit number."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    return lo, hi


def quantize_int4(w: torch.Tensor, group_size: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-wise symmetric int4 quantization of a 2-D weight matrix.

    Returns ``(packed, scales)``: ``packed`` int8 [K/2, N] (low half of K in
    the low nibble), ``scales`` float32 [K/group_size, N]. Requires
    ``K % (2 * group_size) == 0``.
    """
    if w.dim() != 2:
        raise ValueError(f"expected 2-D weights, got {tuple(w.shape)}")
    k, n = w.shape
    if group_size <= 0 or k % (2 * group_size):
        raise ValueError(f"K={k} must be a multiple of 2*group_size={2 * group_size}")
    wf = w.float().reshape(k // group_size, group_size, n)
    absmax = wf.abs().amax(dim=1, keepdim=True)
    scales = torch.where(absmax > 0, absmax * float32_reciprocal(7.0), torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scales), -7, 7).to(torch.int32).reshape(k, n)
    lo, hi = q[: k // 2], q[k // 2 :]
    b = ((hi & 0xF) << 4) | (lo & 0xF)
    packed = torch.where(b >= 128, b - 256, b).to(torch.int8)
    return packed, scales.reshape(k // group_size, n)


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (``int4_matmul_reference`` of the JAX package):
    unpack, scale each group, one float32 product, cast to x's dtype."""
    k = 2 * packed.shape[0]
    g = k // scales.shape[0]
    lo, hi = unpack_nibbles(packed)
    w = torch.cat([lo, hi], dim=0).float()
    sc = torch.repeat_interleave(scales.float(), g, dim=0)
    return (x.float() @ (w * sc)).to(x.dtype)


def _check_shapes(x, packed, scales):
    if x.dim() != 2 or packed.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"x must be [M, K], packed [K/2, N] and scales [K/G, N]; got "
                         f"{tuple(x.shape)}, {tuple(packed.shape)}, {tuple(scales.shape)}")
    kp, n = packed.shape
    groups = scales.shape[0]
    if x.shape[1] != 2 * kp or scales.shape[1] != n:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)}")
    if groups < 2 or groups % 2 or kp % (groups // 2):
        raise ValueError(f"scales rows ({groups}) must be even and divide K/2={kp}")
    if packed.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError("packed must be int8 and scales float32")
    if not (x.device == packed.device == scales.device):
        raise ValueError("x, packed and scales must be on one device")


def info(rows_per_tile: int) -> dict:
    """Registers, spills, shared memory and resident blocks per SM of the
    compiled kernel (``int8_matmul.kernel_info``)."""
    return kernel_info(SOURCE, _SIGNATURE, "int4", rows_per_tile)


def _launch(x, packed, scales):
    global launches
    group = x.shape[1] // scales.shape[0]
    out = launch_kernel(SOURCE, _SIGNATURE, "int4", x.contiguous(), (packed, scales), packed.shape[1], group)
    launches += 1
    return out


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(packed, scales)``. x: [M, K]; packed: [K/2, N] int8;
    scales: [K/G, N] float32. Returns [M, N] in x's dtype."""
    _check_shapes(x, packed, scales)
    if x.is_cuda:
        return _launch(x, packed, scales)
    return int4_matmul_plain(x, packed, scales)
