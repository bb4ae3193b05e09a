"""LAPGemma3: LAP on a Gemma3 backbone (port of ``lap_tpu/models/lap_gemma3.py``).

The prompt carries the images inline: ``Gemma3Tokenizer`` writes 256
``GEMMA3_IMAGE_TOKEN`` placeholders per camera, which ``embed_prefix``
replaces after the embedding by the camera's SigLIP tokens (Gemma3's SigLIP:
soft-embedding norm, pooling to 256 tokens, a bias-free head to the VLM
width). ``image_mask`` marks the placeholders and makes the image blocks
bidirectional in every layer (``gemma3.effective_mask``). The prefix is the
prompt: its length is ``max_token_len``.

Flow matching, AR decode, quantized serving and the training loss are
``LAP``'s, through its hooks: the prefix call gets ``image_mask``, the AR
prefill right-aligns with ``left_to_right_align_with_image_mask`` (which
shifts by the last valid index + 1, not by the count of valid tokens, and
rolls the image mask along), and ``compute_loss`` pads the image mask with
False over the action tokens.

Held from the reference, as it is:

- Ids outside the 262,144-row table are clamped by the embedding
  (``gemma3.Module.embed``); ``GEMMA3_END_IMAGE_TOKEN`` (262144) in every
  prompt reads row 262143.
- The language loss's label gather gives NaN for a label outside the table
  (JAX's ``take_along_axis`` fills), and the masked sum drops it (a select,
  as JAX's product with a boolean mask); the placeholders (262145) and the
  END_IMAGE id are such labels.
- The sliding window compares RoPE positions with cache slots: in the
  right-aligned AR prefill, valid queries below ``prefix_start`` see no key
  on a local layer (dead rows: the einsum path averages V over every key,
  the flash path gives zeros), and decode steps and flow suffix queries do
  not see their own keys on local layers once the prompt has a window's
  worth of padding.

The pi0 branch (``pi05=False``) and the VLM-only model
(``enable_action_training=False``) are ``LAP``'s, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lap_tpu_torch.models import gemma3 as _gemma3
from lap_tpu_torch.models import siglip as _siglip
from lap_tpu_torch.models.lap_model import LAP, LAPConfig
from lap_tpu_torch.models.tokenizer import (
    GEMMA3_BEGIN_IMAGE_TOKEN,
    GEMMA3_BOS_TOKEN,
    GEMMA3_END_IMAGE_TOKEN,
    GEMMA3_EOS_TOKEN,
    GEMMA3_IMAGE_TOKEN,
    GEMMA3_NEWLINE_TOKEN,
)
from lap_tpu_torch.models.types import CoTObservation

SIGLIP_PATCH_SIZE = 14


def image_tokens_per_camera(config: LAPConfig) -> int:
    """SigLIP tokens a camera gives (the placeholders it needs): the patch
    grid, pooled to at most 256."""
    h, w = config.image_resolution
    return min(256, (h // SIGLIP_PATCH_SIZE) * (w // SIGLIP_PATCH_SIZE))


def image_prompt_head(config: LAPConfig) -> list[int]:
    """BOS, then each camera's block as ``Gemma3Tokenizer`` writes it (BOI,
    the placeholders, END_IMAGE, newline): the head of a synthetic prompt."""
    block = [GEMMA3_BEGIN_IMAGE_TOKEN, *[GEMMA3_IMAGE_TOKEN] * image_tokens_per_camera(config),
             GEMMA3_END_IMAGE_TOKEN, GEMMA3_NEWLINE_TOKEN]
    return [GEMMA3_BOS_TOKEN, *block * len(config.image_keys)]


def left_to_right_align_with_image_mask(x, input_mask, attn_mask, image_mask):
    """Roll each row left by its last valid index + 1, so that the valid
    tokens end at the right edge, with the image mask rolled along; padded
    keys and queries stay masked."""
    size = x.shape[1]
    iota = torch.arange(size, device=x.device)
    seqlen = (input_mask.long() * iota[None, :]).max(dim=1).values + 1
    idx = (iota[None, :] + seqlen[:, None]) % size
    b = x.shape[0]
    x_al = torch.gather(x, 1, idx[..., None].expand(b, size, x.shape[-1]))
    mask_al = torch.gather(input_mask, 1, idx)
    img_al = torch.gather(image_mask, 1, idx)
    attn_al = torch.gather(attn_mask, 1, idx[:, :, None].expand(b, size, attn_mask.shape[-1]))
    attn_al = torch.gather(attn_al, 2, idx[:, None, :].expand(b, size, size))
    attn_al = attn_al & mask_al[:, None, :] & mask_al[:, :, None]
    return x_al, mask_al, attn_al, img_al


class LAPGemma3(LAP):
    """LAP on a Gemma3 two-expert backbone with inline image tokens."""

    EOS_TOKEN: int = GEMMA3_EOS_TOKEN
    VOCAB_SIZE: int = _gemma3.GEMMA3_VOCAB_SIZE
    IMAGE_TOKEN: int = GEMMA3_IMAGE_TOKEN

    def _build(self, config: LAPConfig, kw: dict) -> int:
        if "gemma3" not in config.paligemma_variant or "gemma3" not in config.action_expert_variant:
            raise ValueError("LAPGemma3 requires gemma3 variants for both experts")
        dtype = config.torch_dtype
        experts, adarms, width = self._experts(config, _gemma3.get_config)
        pali = experts[0]
        self.llm = _gemma3.Module(
            experts,
            use_adarms=adarms,
            embed_dtype=dtype,
            cache_dtype=dtype,
            attn_impl=config.attn_impl,
            stop_action_to_vlm_grad=config.stop_action_to_vlm_grad,
            remat_policy=config.remat_policy,
            **kw,
        )
        self._image_tokens_per_cam = image_tokens_per_camera(config)
        self.img = _siglip.SigLIP(
            _siglip.get_config(
                config.siglip_variant,
                pool_to_tokens=self._image_tokens_per_cam,
                head_dim_out=pali.width,
                head_bias=False,
                soft_embedding_norm=True,
            ),
            image_size=config.image_resolution,
            attn_impl=config.attn_impl,
            compute_dtype=dtype,
            **kw,
        )
        return width

    # ------------------------------------------------------------------

    def _embed_images(self, obs: CoTObservation):
        """All cameras' SigLIP tokens [B, n_cams * 256, D] and their masks."""
        names = list(obs.images.keys())
        b = obs.state.shape[0]
        per_cam = self.img(torch.cat([obs.images[n] for n in names], dim=0)).split(b, dim=0)
        masks = [obs.image_masks[n][:, None].expand(b, tok.shape[1]) for n, tok in zip(names, per_cam, strict=True)]
        return torch.cat(per_cam, dim=1), torch.cat(masks, dim=1)

    def _replace_placeholders(self, token_embeddings, token_mask, token_ar_mask, tokenized,
                              image_embeddings, image_mask):
        """The i-th placeholder of a row takes the row's i-th image token
        (clipped to the last one) and its camera's mask, and is not AR."""
        is_placeholder = tokenized == self.IMAGE_TOKEN
        b = token_embeddings.shape[0]
        n_patches = image_mask.shape[1]
        placeholder_idx = (torch.cumsum(is_placeholder.long(), dim=1) - 1).clamp(0, n_patches - 1)
        batch_idx = torch.arange(b, device=tokenized.device)[:, None]
        sel_emb = image_embeddings[batch_idx, placeholder_idx]
        sel_mask = image_mask[batch_idx, placeholder_idx]
        out_emb = torch.where(is_placeholder[..., None], sel_emb.to(token_embeddings.dtype), token_embeddings)
        out_mask = torch.where(is_placeholder, sel_mask, token_mask)
        out_ar = torch.where(is_placeholder, False, token_ar_mask)
        return out_emb, out_mask, out_ar

    def embed_prefix(self, obs: CoTObservation):
        """(tokens, input mask, ar mask, image mask) of the prompt with the
        image tokens in place of the placeholders."""
        prompt = obs.tokenized_prompt
        token_embeddings = self.llm.embed(torch.where(prompt == self.IMAGE_TOKEN, 0, prompt))
        token_mask = obs.tokenized_prompt_mask.to(torch.bool)
        if obs.tokenized_langact_mask is not None:
            token_ar_mask = obs.tokenized_langact_mask.to(torch.bool)
        else:
            token_ar_mask = torch.zeros_like(token_mask)
        image_embeddings, siglip_mask = self._embed_images(obs)
        tokens, mask, ar = self._replace_placeholders(
            token_embeddings, token_mask, token_ar_mask, prompt, image_embeddings, siglip_mask
        )
        return tokens, mask, ar, prompt == self.IMAGE_TOKEN

    def _prefix_inputs(self, obs: CoTObservation):
        tokens, mask, ar, image_mask = self.embed_prefix(obs)
        return tokens, mask, ar, {"image_mask": image_mask}

    def _embed_prefix_for_loss(self, obs: CoTObservation, suffix: dict):
        tokens, mask, ar, extra = self._prefix_inputs(obs)
        if suffix is not None:
            extra["image_mask"] = F.pad(extra["image_mask"], (0, suffix["suffix_tokens"].shape[1]))
        return tokens, mask, ar, extra

    @staticmethod
    def _right_align(tokens, input_mask, attn_mask, extra: dict):
        *aligned, image_mask = left_to_right_align_with_image_mask(tokens, input_mask, attn_mask, extra["image_mask"])
        return (*aligned, {**extra, "image_mask": image_mask})

    def _build_prefix_action_mask(self, prefix_mask, obs):
        """The images sit inside the prompt: no offset before the langact mask."""
        if obs.tokenized_langact_mask is None:
            return prefix_mask
        return prefix_mask & ~obs.tokenized_langact_mask.to(torch.bool)

    def _token_logp_and_pred(self, pre_logits, labels, *, need_pred: bool):
        """``LAP``'s, with JAX's fill for labels outside the table: their
        log-prob is NaN (the gather reads a clamped row, whose value is
        replaced, so no gradient reaches it)."""
        vocab = self.llm.embedder.input_embedding.shape[0]
        inside = (labels >= 0) & (labels < vocab)
        logp, pred = super()._token_logp_and_pred(pre_logits, labels.clamp(0, vocab - 1), need_pred=need_pred)
        return torch.where(inside, logp, float("nan")), pred
