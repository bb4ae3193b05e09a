"""Flash-attention forward: a hand-written CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``lap_tpu/ops/flash_attention.py:_fwd_kernel``
(launched from ``_flash_forward``, public ``flash_attention``). Source:
``lap_tpu_torch/csrc/flash_attention_fwd.cu``; see its header for the design.

Semantics held from the Pallas kernel: logits in float32, scaled, masked to
-2.3819763e38; online softmax in float32; GQA through kv head ``n // (N/K)``
without repeating K/V; a fully masked query row gives zeros and
``lse = -2.3819763e38`` (the kernel's mask constant). The CUDA kernel rounds
P to bf16 for its tensor-core PV product, where the Pallas kernel keeps P in
float32; ``flash_attention_plain`` keeps P in float32 like the Pallas kernel.

The wrapper takes the plain version only for CPU tensors. On a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

MASK_VALUE = -2.3819763e38
SUPPORTED_HEAD_DIMS = (128, 256)
SOURCE = "flash_attention_fwd.cu"

# Launches of the CUDA kernel since the last reset (``launches = 0``).
launches = 0

_I64 = ctypes.c_longlong
_SIGNATURE = {
    "flash_attention_fwd": [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 6
    + [_I64] * 11
    + [ctypes.c_float, ctypes.c_void_p]
}


def flash_attention_plain(q, k, v, mask, *, scale: float | None = None):
    """Plain PyTorch version. q: [B,T,N,H]; k,v: [B,S,K,H]; mask [B,T,S].

    Returns (out [B,T,N,H] in q's dtype, lse [B,N,T] float32).
    """
    b, t, n, h = q.shape
    kh = k.shape[2]
    if scale is None:
        scale = h**-0.5
    g = n // kh
    qf = q.float().reshape(b, t, kh, g, h)
    s = torch.einsum("btkgh,bskh->bkgts", qf, k.float()) * scale
    m = mask[:, None, None, :, :]
    s = torch.where(m, s, MASK_VALUE)
    row_max = s.amax(dim=-1, keepdim=True)
    dead = row_max <= MASK_VALUE / 2
    safe_max = torch.where(dead, 0.0, row_max)
    p = torch.where(m, torch.exp(s - safe_max), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, 1.0, denom)
    out = torch.einsum("bkgts,bskh->btkgh", p, v.float()) / denom.permute(0, 3, 1, 2, 4)
    lse = torch.where(dead, MASK_VALUE, row_max + torch.log(denom))[..., 0]
    return out.reshape(b, t, n, h).to(q.dtype), lse.reshape(b, n, t)


def _check_operand(name, x, rank=4):
    if x.dim() != rank:
        raise ValueError(f"{name} must have rank {rank}, got shape {tuple(x.shape)}")
    if x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:-1]) or x.data_ptr() % 16:
        raise ValueError(
            f"{name} needs a unit stride on the head dim, other strides that are "
            f"multiples of 8 and 16-byte alignment; got strides {x.stride()}"
        )


def _launch(q, k, v, mask, scale):
    global launches
    b, t, n, h = q.shape
    _, s, kh, _ = k.shape
    if h not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash kernel supports head dims {SUPPORTED_HEAD_DIMS}, got {h}")
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise ValueError("flash kernel takes bfloat16 q, k and v")
    if n % kh or k.shape != v.shape or k.shape[0] != b or tuple(mask.shape) != (b, t, s):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} mask {tuple(mask.shape)}")
    if not (k.device == v.device == mask.device == q.device):
        raise ValueError("q, k, v and mask must be on one device")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x)
    if mask.dtype != torch.bool or mask.stride(-1) != 1:
        raise ValueError("mask must be bool with a unit stride on its last axis")
    from lap_tpu_torch import cuda_build

    lib = cuda_build.load(SOURCE, _SIGNATURE)
    out = torch.empty((b, t, n, h), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, t), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        b, t, s, n, kh, h,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        mask.stride(0), mask.stride(1),
        float(scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed with cudaError {err}")
    launches += 1
    return out, lse


def flash_attention_forward(q, k, v, mask, *, scale: float | None = None):
    """Flash attention returning (out [B,T,N,H], lse [B,N,T] float32).

    q: [B,T,N,H]; k, v: [B,S,K,H] with N a multiple of K; mask: [B,T,S] bool,
    True = may attend; scale defaults to H**-0.5.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return _launch(q, k, v, mask, scale)
    return flash_attention_plain(q, k, v, mask, scale=scale)


def flash_attention(q, k, v, mask, *, scale: float | None = None) -> torch.Tensor:
    """Flash attention output only ([B,T,N,H] in q's dtype)."""
    return flash_attention_forward(q, k, v, mask, scale=scale)[0]
