"""SigLIP vision transformer (port of ``lap_tpu/models/siglip.py``).

Conv patchify, learned position embeddings, pre-LN encoder blocks with
bidirectional attention, the encoder LayerNorm, and the ``head`` Dense to the
LLM width. Flax ``LayerNorm`` uses eps 1e-6 (PyTorch's default is 1e-5) and
flax ``gelu`` the tanh approximation. Images come in as [B, H, W, 3] in
[-1, 1], as in JAX.

Activations run in ``compute_dtype`` (the parameters' dtype unless given);
every layer casts its weights at use, so float32 parameters can sit under
bf16 activations as in JAX training. With gradients enabled each encoder block
is recomputed in the backward pass, matching the remat-scanned JAX encoder.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from lap_tpu_torch.ops.attention import attention

LAYER_NORM_EPS = 1e-6


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` with the weights cast to the dtype of ``x``."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def _layer_norm(layer: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(
        x, layer.normalized_shape, layer.weight.to(x.dtype), layer.bias.to(x.dtype), layer.eps
    )


@dataclasses.dataclass(frozen=True)
class SiglipConfig:
    width: int
    depth: int
    mlp_dim: int
    num_heads: int
    patch_size: int = 14
    head_dim_out: int | None = None  # project to the LLM width
    head_bias: bool = True


_VARIANTS = {
    "So400m/14": dict(width=1152, depth=27, mlp_dim=4304, num_heads=16, patch_size=14),
    "dummy": dict(width=64, depth=2, mlp_dim=128, num_heads=4, patch_size=14),
}


def get_config(variant: str, **overrides) -> SiglipConfig:
    if variant not in _VARIANTS:
        raise ValueError(f"Unknown siglip variant: {variant}")
    return SiglipConfig(**{**_VARIANTS[variant], **overrides})


class SelfAttention(nn.Module):
    """Bidirectional multi-head attention; query/key/value/out Linears."""

    def __init__(self, width: int, num_heads: int, *, attn_impl="auto", device=None, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        kw = dict(device=device, dtype=dtype)
        self.query = nn.Linear(width, width, **kw)
        self.key = nn.Linear(width, width, **kw)
        self.value = nn.Linear(width, width, **kw)
        self.out = nn.Linear(width, width, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = d // self.num_heads
        q = _linear(self.query, x).view(b, t, self.num_heads, h)
        k = _linear(self.key, x).view(b, t, self.num_heads, h)
        v = _linear(self.value, x).view(b, t, self.num_heads, h)
        mask = torch.ones((b, t, t), dtype=torch.bool, device=x.device)
        out = attention(q, k, v, mask, scale=h**-0.5, impl=self.attn_impl)
        return _linear(self.out, out.reshape(b, t, d))


class EncoderBlock(nn.Module):
    def __init__(self, width: int, mlp_dim: int, num_heads: int, *, attn_impl="auto",
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln0 = nn.LayerNorm(width, eps=LAYER_NORM_EPS, **kw)
        self.attn = SelfAttention(width, num_heads, attn_impl=attn_impl, **kw)
        self.ln1 = nn.LayerNorm(width, eps=LAYER_NORM_EPS, **kw)
        self.mlp0 = nn.Linear(width, mlp_dim, **kw)
        self.mlp1 = nn.Linear(mlp_dim, width, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(_layer_norm(self.ln0, x))
        y = _linear(self.mlp1, F.gelu(_linear(self.mlp0, _layer_norm(self.ln1, x)), approximate="tanh"))
        return x + y


class SigLIP(nn.Module):
    """ViT image encoder emitting a token sequence (no pooling)."""

    def __init__(self, config: SiglipConfig, *, image_size: tuple[int, int] = (224, 224),
                 attn_impl="auto", compute_dtype: torch.dtype | None = None, remat: bool = True,
                 device=None, dtype=None):
        super().__init__()
        self.config = config
        self.compute_dtype = compute_dtype
        self.remat = remat
        kw = dict(device=device, dtype=dtype)
        p = config.patch_size
        n_patches = (image_size[0] // p) * (image_size[1] // p)
        self.embedding = nn.Conv2d(3, config.width, p, stride=p, **kw)
        self.pos_embedding = nn.Parameter(torch.empty((1, n_patches, config.width), **kw))
        self.blocks = nn.ModuleList(
            [
                EncoderBlock(config.width, config.mlp_dim, config.num_heads, attn_impl=attn_impl, **kw)
                for _ in range(config.depth)
            ]
        )
        self.encoder_norm = nn.LayerNorm(config.width, eps=LAYER_NORM_EPS, **kw)
        self.head = None
        if config.head_dim_out:
            self.head = nn.Linear(config.width, config.head_dim_out, bias=config.head_bias, **kw)

    def set_attn_impl(self, impl: str) -> None:
        for block in self.blocks:
            block.attn.attn_impl = impl

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, H, W, 3] in [-1, 1]. Returns [B, tokens, width_out]."""
        dtype = self.compute_dtype or self.embedding.weight.dtype
        x = images.to(dtype).permute(0, 3, 1, 2)
        conv = self.embedding
        x = F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype), stride=conv.stride)  # [B, D, gh, gw]
        x = x.flatten(2).transpose(1, 2)  # [B, gh*gw, D], row-major over the grid
        x = x + self.pos_embedding.to(x.dtype)
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                x = checkpoint(block, x, use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x)
        x = _layer_norm(self.encoder_norm, x)
        if self.head is not None:
            x = _linear(self.head, x)
        return x

    def random_init_(self, gen: torch.Generator) -> None:
        self.pos_embedding.normal_(0.0, self.config.width**-0.5, generator=gen)
