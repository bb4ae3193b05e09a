"""Multi-expert Gemma3 decoder (port of ``lap_tpu/models/gemma3.py``).

The Gemma backbone of ``gemma.py`` with Gemma3's differences, each held
from the JAX module:

- five local layers to one global (``sliding_window_pattern``): a local
  layer ANDs a sliding window into the mask, built from the queries' RoPE
  positions against the keys' cache **slots** (``k_pos = arange(kv_len)``),
  as JAX builds it; the window and the RoPE bases are the VLM's
  (``configs[0]``), the action expert's own window is never read;
- image-bidirectional attention: ``image_mask`` ORs (image query, image key)
  pairs into the mask, the key side padded with False (or cut) to the keys'
  length;
- interleaved-pair RoPE with a base chosen per layer (10k local, 1M global);
- ``QKRMSNorm`` on the concatenated queries and keys: a direct ``scale``
  (not ``1 + scale``), the variance and the product in f32;
- post-attention and post-FFW RMSNorms on expert 0 only (adaRMS gates on
  both experts' residuals as in Gemma);
- the transposed gating layout ``gating_einsum`` [2, hidden, width]
  (JAX's ``"...F,GHF->...GH"``), quantized as [width, 2 * hidden];
- LoRA through a config's ``lora_configs`` (no named variant sets it, as in
  JAX): the attention einsums as in ``gemma.py``, and the MLP's
  ``gating_lora_a`` [2, F, r], ``gating_lora_b`` [2, r, H],
  ``linear_lora_a`` [H, r], ``linear_lora_b`` [r, F]; an adapted MLP
  recomputes its hidden activation with the adapted gates and projects that
  (JAX's order of operations);
- a 262,144-row vocabulary. ``Module.embed`` clamps token ids into the
  table, as JAX's jitted gather does: ``GEMMA3_END_IMAGE_TOKEN`` (262144) is
  one past the table and every Gemma3 prompt holds it, so it reads row
  262143, and (as the gather's transpose drops the update) passes no
  gradient to it.

The layers are per layer (JAX's ``scan_layers=False``) with the KV cache,
the in-place single-token update, remat and quantized copies as in
``gemma.py``. Tensor and sequence parallelism enter each block as in
``gemma.py`` (``parallel/tp.py``); the q/k norms sum their gradients over tp.
The GPipe branch of the JAX module is not ported here (ROADMAP queue A item
13b).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lap_tpu_torch.models import gemma as _gemma
from lap_tpu_torch.models.gemma import RMSNorm, _expert_list, _gated_residual, _sp_grad
from lap_tpu_torch.models.lora import (
    QUANT_MAX_ROWS,
    LoRAConfig,
    QuantWeights,
    _add_mlp_lora,
    _rows,
    mlp_lora_init_,
    quant_matmul,
)
from lap_tpu_torch.parallel.tp import TPContext, grad_sum, region_in, region_out

GEMMA3_VOCAB_SIZE = 262_144


@dataclasses.dataclass(frozen=True)
class Config:
    width: int
    hidden_dim: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    num_layers: int
    sliding_window_size: int = 1024
    sliding_window_pattern: int = 6  # every 6th layer is global
    rope_local_base_freq: float = 10_000.0
    rope_global_base_freq: float = 1_000_000.0
    use_qk_norm: bool = True
    use_post_attn_norm: bool = True
    use_post_ffw_norm: bool = True
    vocab_size: int = GEMMA3_VOCAB_SIZE
    lora_configs: dict[str, LoRAConfig] = dataclasses.field(default_factory=dict)

    @property
    def depth(self) -> int:
        """``num_layers`` under ``gemma.Config``'s name (``gemma.Module`` reads it)."""
        return self.num_layers

    def get_attention_type(self, layer_idx: int) -> str:
        return "global" if (layer_idx + 1) % self.sliding_window_pattern == 0 else "local"

    def is_global(self, layer_idx: int) -> bool:
        return self.get_attention_type(layer_idx) == "global"


_VARIANTS = {
    # (width, hidden, heads, kv, head_dim, layers, window)
    "gemma3_1b": (1152, 6 * 1152, 4, 1, 256, 26, 512),
    "gemma3_4b": (2560, 2560 * 4, 8, 4, 256, 34, 1024),
    "gemma3_12b": (3840, 4 * 3840, 16, 8, 256, 48, 1024),
    "gemma3_27b": (5376, 5376 * 4, 32, 16, 128, 62, 1024),
    "gemma3_300m": (768, 768 * 4, 8, 4, 256, 34, 512),
    "gemma3_300m_26": (768, 768 * 4, 4, 1, 256, 26, 512),
    "gemma3_300m_48": (768, 768 * 4, 16, 8, 256, 48, 512),
    "gemma3_300m_62": (768, 768 * 4, 32, 16, 128, 62, 512),
    "gemma3_dummy": (64, 128, 4, 2, 16, 6, 4),
}


def get_config(variant: str) -> Config:
    if variant not in _VARIANTS:
        raise ValueError(f"Unknown gemma3 variant: {variant}")
    w, h, n, k, hd, layers, window = _VARIANTS[variant]
    return Config(width=w, hidden_dim=h, num_heads=n, num_kv_heads=k, head_dim=hd,
                  num_layers=layers, sliding_window_size=window)


class QKRMSNorm(nn.Module):
    """Query/key RMSNorm over the head dim with a direct ones-init scale."""

    def __init__(self, head_dim: int, *, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(head_dim, device=device, dtype=dtype))

    # Under tp: the context over which the scale's gradient sums (each rank
    # normalises its own heads).
    tp_grad: TPContext | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        scale = grad_sum(self.scale, self.tp_grad)
        return (x32 * torch.rsqrt(var + 1e-6) * scale.float()).to(x.dtype)

    def random_init_(self, gen: torch.Generator) -> None:
        self.scale.normal_(1.0, 0.1, generator=gen)


def apply_rope_interleaved(x: torch.Tensor, positions: torch.Tensor, base_frequency: float) -> torch.Tensor:
    """Rotate interleaved (even, odd) channel pairs of x [B, T, N, H] by the
    angles ``positions`` [B, T] times ``base ** -(i / (H/2))``; f32 math, the
    result in the dtype of x."""
    pairs = x.shape[-1] // 2
    freq_seq = torch.arange(pairs, dtype=torch.float32, device=x.device) / pairs
    inv_freq = 1.0 / torch.pow(torch.tensor(base_frequency, dtype=torch.float32, device=x.device), freq_seq)
    angles = positions.to(torch.float32)[:, :, None] * inv_freq[None, None, :]
    sin, cos = torch.sin(angles)[:, :, None, :], torch.cos(angles)[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


class FeedForward(QuantWeights):
    """GeGLU MLP with Gemma3's transposed gating: ``gating_einsum`` [2, H, F]
    (F = width, H = hidden), ``linear`` [H, F]."""

    def __init__(self, features: int, hidden_dim: int, *, lora_config: LoRAConfig | None = None,
                 device=None, dtype=None):
        super().__init__()
        self.gating_einsum = nn.Parameter(torch.empty((2, hidden_dim, features), device=device, dtype=dtype))
        self.linear = nn.Parameter(torch.empty((hidden_dim, features), device=device, dtype=dtype))
        self.lora_config = lora_config
        if lora_config is not None:
            r = lora_config.rank
            _add_mlp_lora(self, (2, features, r), (2, r, hidden_dim), hidden_dim, features, device=device,
                          dtype=dtype)

    def quant_targets(self):
        # [2, H, F] -> [F, 2H]: contraction-major, both projections in one matmul.
        return [("gating_", self.gating_einsum, (2, 0, 1), 1), ("linear_", self.linear, (0, 1), 1)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows_ok = _rows(x, x.dim() - 1) <= QUANT_MAX_ROWS
        hidden = self.gating_einsum.shape[1]
        gating = self.quantized("gating_")
        if gating is not None and rows_ok:
            gates = quant_matmul(x, *gating, (*x.shape[:-1], 2, hidden))
            gate_pre, up = gates[..., 0, :], gates[..., 1, :]
        else:
            w = self.gating_einsum.to(x.dtype)
            gate_pre, up = x @ w[0].T, x @ w[1].T
        cfg = self.lora_config
        if cfg is not None:
            # JAX's order: the adapted gates give a second hidden activation,
            # which alone reaches the output.
            a, b = self.gating_lora_a.to(x.dtype), self.gating_lora_b.to(x.dtype)
            gate_pre = gate_pre + cfg.scaling_value * ((x @ a[0]) @ b[0])
            up = up + cfg.scaling_value * ((x @ a[1]) @ b[1])
        act = F.gelu(gate_pre, approximate="tanh") * up
        linear = self.quantized("linear_")
        if linear is not None and rows_ok:
            return quant_matmul(act, *linear, (*x.shape[:-1], self.linear.shape[-1]))
        out = act @ self.linear.to(x.dtype)
        if cfg is not None:
            out = out + cfg.scaling_value * ((act @ self.linear_lora_a.to(x.dtype)) @ self.linear_lora_b.to(x.dtype))
        return out

    def random_init_(self, gen: torch.Generator) -> None:
        self.gating_einsum.normal_(0.0, self.gating_einsum.shape[2] ** -0.5, generator=gen)
        self.linear.normal_(0.0, self.linear.shape[0] ** -0.5, generator=gen)
        mlp_lora_init_(self, gen)


def effective_mask(attn_mask, positions, kv_len: int, *, is_global: bool, window: int, image_mask=None):
    """The mask attention is given: on a local layer ``attn_mask`` AND the
    sliding window ``k_slot <= q_pos < k_slot + window`` (q_pos the query's
    RoPE position, k_slot the key's cache slot); then, with ``image_mask``,
    OR every (image query, image key) pair."""
    mask = attn_mask
    if not is_global:
        q_pos = positions[:, :, None]
        k_pos = torch.arange(kv_len, device=positions.device)[None, None, :]
        mask = mask & (k_pos <= q_pos) & ((q_pos - k_pos) < window)
    if image_mask is not None:
        k_img = image_mask
        if k_img.shape[1] < kv_len:
            k_img = F.pad(k_img, (0, kv_len - k_img.shape[1]))
        else:
            k_img = k_img[:, :kv_len]
        mask = mask | (image_mask[:, :, None] & k_img[:, None, :])
    return mask


class Attention(_gemma.Attention):
    """``gemma.Attention`` with Gemma3's QK-RMSNorm, interleaved RoPE at the
    layer's base and the layer's effective mask."""

    def __init__(self, configs: Sequence[Config], *, stop_action_to_vlm_grad: bool = False,
                 cache_dtype=None, attn_impl="auto", device=None, dtype=None):
        super().__init__(configs, stop_action_to_vlm_grad=stop_action_to_vlm_grad, cache_dtype=cache_dtype,
                         attn_impl=attn_impl, device=device, dtype=dtype)
        if configs[0].use_qk_norm:
            self.q_rmsnorm = QKRMSNorm(configs[0].head_dim, device=device, dtype=dtype)
            self.k_rmsnorm = QKRMSNorm(configs[0].head_dim, device=device, dtype=dtype)

    def forward(self, xs, positions, attn_mask, kv_cache, want_cache: bool = True, *, is_global: bool,
                image_mask=None):
        """The call shapes of ``gemma.Attention.forward``; ``is_global`` picks
        the layer's RoPE base and whether the sliding window applies."""
        cfg0 = self.configs[0]
        q, k, v = self._project(xs)
        if cfg0.use_qk_norm:
            q = self.q_rmsnorm(q)
            k = self.k_rmsnorm(k)
        base = cfg0.rope_global_base_freq if is_global else cfg0.rope_local_base_freq
        q = apply_rope_interleaved(q, positions, base)
        k = apply_rope_interleaved(k, positions, base)
        q = q * cfg0.head_dim ** -0.5
        idx, k, v = self._cache(xs, k, v, attn_mask, kv_cache, want_cache)
        mask = effective_mask(attn_mask, positions, k.shape[1], is_global=is_global,
                              window=cfg0.sliding_window_size, image_mask=image_mask)
        encoded = self._attend(xs, q, k, v, mask, kv_cache)
        return self._project_out(xs, encoded), ((idx, k, v) if want_cache else None)


class Block(nn.Module):
    def __init__(self, configs: Sequence[Config], use_adarms: Sequence[bool], *,
                 stop_action_to_vlm_grad: bool = False, cache_dtype=None, attn_impl="auto",
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        n, cfg0 = len(configs), configs[0]
        self.pre_attention_norm = _expert_list(lambda i: RMSNorm(configs[i].width, adaptive=use_adarms[i], **kw), n)
        self.attn = Attention(configs, stop_action_to_vlm_grad=stop_action_to_vlm_grad,
                              cache_dtype=cache_dtype, attn_impl=attn_impl, **kw)
        self.pre_ffw_norm = _expert_list(lambda i: RMSNorm(configs[i].width, adaptive=use_adarms[i], **kw), n)
        self.mlp = _expert_list(
            lambda i: FeedForward(configs[i].width, configs[i].hidden_dim,
                                  lora_config=configs[i].lora_configs.get("ffn"), **kw), n)
        # Expert 0 only, plain (no adaRMS), as in JAX.
        self.post_attention_norm = RMSNorm(cfg0.width, **kw) if cfg0.use_post_attn_norm else None
        self.post_ffw_norm = RMSNorm(cfg0.width, **kw) if cfg0.use_post_ffw_norm else None

    @staticmethod
    def _post_norm(norm, outs, tp):
        if norm is None or outs[0] is None:
            return outs
        return [norm(outs[0], None, _sp_grad(tp, 0))[0], *outs[1:]]

    def forward(self, xs, kv_cache, positions, attn_mask, adarms_cond, want_cache: bool = True, *,
                is_global: bool, image_mask=None, tp: TPContext | None = None):
        """``tp``: the tensor-parallel context, as ``gemma.Block``'s; the
        post norms follow the row-parallel sums."""
        pre, gates = [], []
        for i, x in enumerate(xs):
            gate = None
            if x is not None:
                x, gate = self.pre_attention_norm[i](x, adarms_cond[i], _sp_grad(tp, i))
            pre.append(region_in(x, tp, i))
            gates.append(gate)
        post, kv_cache = self.attn(pre, positions, attn_mask, kv_cache, want_cache, is_global=is_global,
                                   image_mask=image_mask)
        post = [region_out(y, tp, i) for i, y in enumerate(post)]
        post = self._post_norm(self.post_attention_norm, post, tp)
        xs = [_gated_residual(x, y, g) for x, y, g in zip(xs, post, gates, strict=True)]

        outs, gates = [], []
        for i, x in enumerate(xs):
            gate = None
            if x is not None:
                x, gate = self.pre_ffw_norm[i](x, adarms_cond[i], _sp_grad(tp, i))
                x = region_out(self.mlp[i](region_in(x, tp, i)), tp, i)
            outs.append(x)
            gates.append(gate)
        outs = self._post_norm(self.post_ffw_norm, outs, tp)
        xs = [_gated_residual(x, y, g) for x, y, g in zip(xs, outs, gates, strict=True)]
        return xs, kv_cache


class Module(_gemma.Module):
    """``gemma.Module`` with Gemma3's blocks (every ``sliding_window_pattern``-th
    global), its vocabulary, and the image mask [B, T] passed to every layer
    (None: no image-bidirectional pairs)."""

    BLOCK = Block

    def __init__(self, configs: Sequence[Config], **kwargs):
        super().__init__(configs, vocab_size=configs[0].vocab_size, **kwargs)
        self.is_global = tuple(configs[0].is_global(i) for i in range(configs[0].num_layers))

    def _block_kwargs(self, layer: int, image_mask=None) -> dict:
        return {"is_global": self.is_global[layer], "image_mask": image_mask}

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Embed ids as JAX's jitted gather does: an id outside the table
        reads its nearest row, and its gradient is dropped (the scatter of
        the gather's transpose drops out-of-bounds updates)."""
        vocab = self.embedder.input_embedding.shape[0]
        outside = (tokens < 0) | (tokens >= vocab)
        x = self.embedder.encode(tokens.clamp(0, vocab - 1))
        if torch.is_grad_enabled() and bool(outside.any()):
            x = torch.where(outside[..., None], x.detach(), x)
        return x.to(self.embed_dtype)
