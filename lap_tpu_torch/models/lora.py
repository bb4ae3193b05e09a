"""Einsum and gated-GELU FeedForward layers (port of ``lap_tpu/models/lora.py``).

Weights keep the JAX checkpoint shapes (``w``; ``gating_einsum`` [2, D, F],
``linear`` [F, D]); quantized serving and LoRA adapters are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Einsum(nn.Module):
    """y = einsum(eqn, x, w), computed in the dtype of ``x``.

    ``fan_in`` is the size of the contracted weight axes (for random init).
    """

    def __init__(self, shape: tuple[int, ...], fan_in: int, *, device=None, dtype=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(shape, device=device, dtype=dtype))
        self.fan_in = fan_in

    def forward(self, eqn: str, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eqn, x, self.w.to(x.dtype))

    def random_init_(self, gen: torch.Generator) -> None:
        self.w.normal_(0.0, self.fan_in**-0.5, generator=gen)


class FeedForward(nn.Module):
    """Gemma gated-GELU MLP: (gelu_tanh(x @ w0) * (x @ w1)) @ w2."""

    def __init__(self, features: int, hidden_dim: int, *, device=None, dtype=None):
        super().__init__()
        self.gating_einsum = nn.Parameter(
            torch.empty((2, features, hidden_dim), device=device, dtype=dtype)
        )
        self.linear = nn.Parameter(torch.empty((hidden_dim, features), device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.gating_einsum.to(x.dtype)
        act = F.gelu(x @ w[0], approximate="tanh") * (x @ w[1])
        return act @ self.linear.to(x.dtype)

    def random_init_(self, gen: torch.Generator) -> None:
        self.gating_einsum.normal_(0.0, self.gating_einsum.shape[1] ** -0.5, generator=gen)
        self.linear.normal_(0.0, self.linear.shape[0] ** -0.5, generator=gen)
