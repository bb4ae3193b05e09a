"""LAP flow-matching policy model (port of ``lap_tpu/models/lap_model.py``).

SigLIP + a two-expert Gemma (the VLM and the action expert) with pi0.5
adaRMS time conditioning. This slice ports inference by flow matching:
``embed_prefix``, ``embed_suffix`` and ``sample_actions`` (prefix prefill,
then Euler steps of the action expert against the KV cache).

Numerics held from JAX: ``action_in_proj``, the time MLP and
``action_out_proj`` are flax ``Dense`` layers without ``dtype``, so they
compute in the promoted type, f32 on f32 inputs even with bf16 weights; the
Euler loop accumulates time in f32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lap_tpu_torch.device import resolve_device
from lap_tpu_torch.models import gemma as _gemma
from lap_tpu_torch.models import siglip as _siglip
from lap_tpu_torch.models.init import random_init_
from lap_tpu_torch.models.preprocessing import preprocess_observation
from lap_tpu_torch.models.types import IMAGE_KEYS, IMAGE_RESOLUTION, CoTObservation, fake_obs
from lap_tpu_torch.ops.masks import make_attn_mask


@dataclasses.dataclass(frozen=True)
class LAPConfig:
    """The fields of ``lap_tpu``'s LAPConfig that the flow path reads."""

    dtype: str = "bfloat16"
    paligemma_variant: str = "gemma_2b"
    action_expert_variant: str = "gemma_300m"
    siglip_variant: str = "So400m/14"

    action_dim: int = 7
    action_horizon: int = 16
    max_token_len: int = 220

    pi05: bool = True
    enable_action_training: bool = False

    # Attention implementation ("auto" / "flash" / "xla").
    attn_impl: str = "auto"
    image_resolution: tuple[int, int] = IMAGE_RESOLUTION

    @property
    def image_keys(self) -> tuple[str, ...]:
        return IMAGE_KEYS

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def fake_obs(self, batch_size: int = 1, device=None) -> CoTObservation:
        return fake_obs(
            batch_size=batch_size,
            image_keys=self.image_keys,
            action_dim=self.action_dim,
            max_token_len=self.max_token_len,
            resolution=self.image_resolution,
            device=device,
        )


def posemb_sincos(pos: torch.Tensor, embedding_dim: int, min_period: float, max_period: float):
    """Sine-cosine time embedding in f32 (openpi pi0 semantics)."""
    if embedding_dim % 2 != 0:
        raise ValueError("embedding_dim must be even")
    fraction = torch.linspace(0.0, 1.0, embedding_dim // 2, dtype=torch.float32, device=pos.device)
    period = min_period * (max_period / min_period) ** fraction
    angles = pos.to(torch.float32)[:, None] * (1.0 / period * 2 * math.pi)[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def _dense_promoted(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A flax ``Dense`` without ``dtype``: computes in the promoted type."""
    dtype = torch.promote_types(x.dtype, layer.weight.dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class LAP(nn.Module):
    """Flow-matching action policy on a two-expert Gemma.

    Parameters are created on ``device`` (``cuda`` unless given) in the
    config's dtype. With ``init_seed`` they are filled with seeded random
    values (every one non-zero); with ``init_seed=None`` they are left
    uninitialised for ``convert.load_jax_params``.
    """

    def __init__(self, config: LAPConfig, *, device=None, init_seed: int | None = 0):
        super().__init__()
        if not config.enable_action_training:
            raise ValueError("the flow policy needs enable_action_training=True (the action expert)")
        if not config.pi05:
            raise NotImplementedError("only the pi0.5 (adaRMS) branch is ported")
        device = resolve_device(device)
        self.config = config
        dtype = config.torch_dtype
        pali = _gemma.get_config(config.paligemma_variant)
        action = _gemma.get_config(config.action_expert_variant)
        self._action_width = action.width
        with torch.device("meta"):
            kw = dict(dtype=dtype)
            self.img = _siglip.SigLIP(
                _siglip.get_config(config.siglip_variant, head_dim_out=pali.width),
                image_size=config.image_resolution,
                attn_impl=config.attn_impl,
                **kw,
            )
            self.llm = _gemma.Module(
                [pali, action],
                use_adarms=[False, True],
                embed_dtype=dtype,
                cache_dtype=dtype,
                attn_impl=config.attn_impl,
                **kw,
            )
            self.action_in_proj = nn.Linear(config.action_dim, action.width, **kw)
            self.time_mlp_in = nn.Linear(action.width, action.width, **kw)
            self.time_mlp_out = nn.Linear(action.width, action.width, **kw)
            self.action_out_proj = nn.Linear(action.width, config.action_dim, **kw)
        self.to_empty(device=device)
        if init_seed is not None:
            random_init_(self, init_seed)

    @property
    def device(self) -> torch.device:
        return self.action_out_proj.weight.device

    def set_attn_impl(self, impl: str) -> None:
        self.img.set_attn_impl(impl)
        self.llm.set_attn_impl(impl)

    # ------------------------------------------------------------------

    def embed_prefix(self, obs: CoTObservation):
        """Image tokens (all cameras in one ViT pass) + prompt embeddings."""
        names = list(obs.images.keys())
        b = obs.state.shape[0]
        stacked = torch.cat([obs.images[n] for n in names], dim=0)
        per_cam = self.img(stacked).split(b, dim=0)

        tokens, input_mask, ar_mask = [], [], []
        for name, img_tokens in zip(names, per_cam, strict=True):
            s = img_tokens.shape[1]
            tokens.append(img_tokens)
            input_mask.append(obs.image_masks[name][:, None].expand(b, s))
            ar_mask.append(torch.zeros((b, s), dtype=torch.bool, device=stacked.device))

        tokens.append(self.llm.embed(obs.tokenized_prompt))
        input_mask.append(obs.tokenized_prompt_mask.to(torch.bool))
        if obs.tokenized_langact_mask is not None:
            ar_mask.append(obs.tokenized_langact_mask.to(torch.bool))
        else:
            ar_mask.append(torch.zeros(obs.tokenized_prompt.shape, dtype=torch.bool, device=stacked.device))
        return torch.cat(tokens, dim=1), torch.cat(input_mask, dim=1), torch.cat(ar_mask, dim=1)

    def embed_suffix(self, obs: CoTObservation, noisy_actions: torch.Tensor, timestep: torch.Tensor):
        """Action-expert tokens and the adaRMS time conditioning (pi0.5)."""
        cfg = self.config
        action_tokens = _dense_promoted(self.action_in_proj, noisy_actions)
        time_emb = posemb_sincos(timestep, self._action_width, min_period=4e-3, max_period=4.0)
        y = F.silu(_dense_promoted(self.time_mlp_in, time_emb))
        adarms_cond = F.silu(_dense_promoted(self.time_mlp_out, y))
        input_mask = torch.ones(action_tokens.shape[:2], dtype=torch.bool, device=action_tokens.device)
        # The first action token starts a new AR segment; the chunk is
        # bidirectional within itself.
        ar = torch.zeros(cfg.action_horizon, dtype=torch.bool, device=action_tokens.device)
        ar[0] = True
        return action_tokens, input_mask, ar, adarms_cond

    @torch.inference_mode()
    def sample_actions(self, observation: CoTObservation, *, num_steps: int = 10, noise=None,
                       generator: torch.Generator | None = None) -> torch.Tensor:
        """Prefill the prefix, then Euler-integrate the flow from t=1 to 0."""
        cfg = self.config
        observation = preprocess_observation(
            observation, image_keys=cfg.image_keys, image_resolution=cfg.image_resolution
        )
        device = self.device
        dt = np.float32(-1.0 / num_steps)
        batch_size = observation.state.shape[0]
        if noise is None:
            noise = torch.randn(
                (batch_size, cfg.action_horizon, cfg.action_dim),
                generator=generator, device=device, dtype=torch.float32,
            )
        noise = noise.to(device=device, dtype=torch.float32)

        prefix_tokens, prefix_mask, prefix_ar_mask = self.embed_prefix(observation)
        prefix_attn_mask = make_attn_mask(prefix_mask, prefix_ar_mask)
        positions = torch.cumsum(prefix_mask, dim=1) - 1
        _, kv_cache = self.llm([prefix_tokens, None], positions, prefix_attn_mask, [None, None])

        prefix_len = prefix_mask.sum(dim=-1)
        x_t, time = noise, np.float32(1.0)
        for _ in range(num_steps):
            timestep = torch.full((batch_size,), float(time), dtype=torch.float32, device=device)
            suffix_tokens, suffix_mask, suffix_ar, adarms_cond = self.embed_suffix(observation, x_t, timestep)
            suffix_attn = make_attn_mask(suffix_mask, suffix_ar[None].expand_as(suffix_mask))
            prefix_attn = prefix_mask[:, None, :].expand(batch_size, suffix_tokens.shape[1], prefix_mask.shape[1])
            full_mask = torch.cat([prefix_attn, suffix_attn], dim=-1)
            pos = prefix_len[:, None] + torch.cumsum(suffix_mask, dim=-1) - 1
            (_, suffix_out), _ = self.llm(
                [None, suffix_tokens], pos, full_mask, [None, adarms_cond], kv_cache=kv_cache
            )
            v_t = _dense_promoted(
                self.action_out_proj, suffix_out[:, -cfg.action_horizon :].to(torch.float32)
            )
            x_t = x_t + float(dt) * v_t
            time = np.float32(time + dt)  # f32 accumulation, as in JAX
        return x_t
