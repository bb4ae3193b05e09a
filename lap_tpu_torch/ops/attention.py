"""Attention dispatch (port of ``lap_tpu/ops/attention.py``).

- ``xla``: plain einsum attention, float32 logits and softmax, mask constant
  -2.3819763e38, probabilities cast to the K/V dtype before the PV product.
- ``flash``: the hand-written CUDA flash-attention kernels, forward and
  backward (``flash_attention.py``); their plain PyTorch versions on CPU
  tensors.

``auto`` takes the kernel for CUDA tensors with at least 192 queries and a
head dim that is a multiple of 128 (the JAX rule, with "CUDA tensor" where
JAX reads "TPU backend"), and the einsum path otherwise.
"""

from __future__ import annotations

import torch

from lap_tpu_torch.ops.flash_attention import flash_attention

BIG_NEG = -2.3819763e38


def xla_attention(q, k, v, mask, *, scale: float | None = None) -> torch.Tensor:
    """q: [B,T,N,H]; k,v: [B,S,K,H]; mask [B,T,S] bool. Returns [B,T,N,H]."""
    b, t, n, h = q.shape
    _, s, kh, _ = k.shape
    if scale is None:
        scale = h**-0.5
    g = n // kh
    q = q.reshape(b, t, kh, g, h)
    logits = torch.einsum("btkgh,bskh->bkgts", q.float(), k.float())
    logits = logits * scale
    logits = torch.where(mask[:, None, None, :, :], logits, BIG_NEG)
    probs = torch.softmax(logits, dim=-1).to(k.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v)
    return out.reshape(b, t, n, h)


def use_flash(q: torch.Tensor) -> bool:
    """The ``auto`` rule."""
    return q.is_cuda and q.shape[1] >= 192 and q.shape[-1] % 128 == 0


def attention(q, k, v, mask, *, scale: float | None = None, impl: str = "auto") -> torch.Tensor:
    """Multi-head (GQA) attention with a boolean mask (True = attend)."""
    if impl == "auto":
        impl = "flash" if use_flash(q) else "xla"
    if impl == "flash":
        return flash_attention(q, k, v, mask, scale=scale)
    if impl == "xla":
        return xla_attention(q, k, v, mask, scale=scale)
    raise ValueError(f"unknown attention impl: {impl}")
