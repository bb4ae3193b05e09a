"""Rotary position embeddings (port of ``lap_tpu/ops/rope.py``).

Timescales ``base ** (2i / H)``; the two halves of the head dim are rotated
in float32 and the result is cast back to the input dtype.
"""

from __future__ import annotations

import torch


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, base: float = 10_000.0) -> torch.Tensor:
    """x: [B, T, N, H] with H even; positions: [B, T] ints."""
    h = x.shape[-1]
    half = h // 2
    freq_exponents = (2.0 / h) * torch.arange(half, dtype=torch.float32, device=x.device)
    timescale = base**freq_exponents
    radians = positions[..., None].to(torch.float32) / timescale[None, None, :]
    radians = radians[..., None, :]  # [B, T, 1, half]
    sin, cos = torch.sin(radians), torch.cos(radians)
    x32 = x.to(torch.float32)
    x1, x2 = x32[..., :half], x32[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)
