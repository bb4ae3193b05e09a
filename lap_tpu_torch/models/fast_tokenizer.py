"""FAST-style action tokenization (DCT + quantize) and its transforms (copy of
``lap_tpu/models/fast_tokenizer.py``, its imports pointed at the port).

Capability parity with lihzha/lap ``tokenizer.py:563-879`` (FASTTokenizerMixin
/ FASTTokenizer / Gemma3FASTTokenizer): continuous action chunks are encoded
as discrete tokens appended to the prompt, trained with the standard LM loss,
and decoded back with ``extract_actions``.

The reference downloads the trained ``physical-intelligence/fast`` HF
processor (a DCT + learned-BPE codec). We implement the full pipeline:
DCT -> quantize -> learned BPE (``lap_tpu_torch.models.bpe.IntBPE``; trainable
offline, or loaded from a released processor export with
``IntBPE.from_hf_export`` -- byte-compatibility with a real export is
env-gated in tests since no HF assets ship in this image). Action tokens
live at the TAIL of the text vocabulary via ``vocab - 1 - skip - token``
(reference mapping, tokenizer.py:563-584), so checkpoints trained either
way use the same id range.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.fft import dct, idct

from lap_tpu_torch.models.tokenizer import Gemma3Tokenizer, PaligemmaTokenizer


@dataclasses.dataclass(frozen=True)
class FASTActionCodec:
    """DCT-quantization (+ optional learned BPE) codec over normalized
    [-1, 1] action chunks.

    With ``bpe`` set (an ``lap_tpu_torch.models.bpe.IntBPE`` trained over the
    quantized-DCT symbol stream, or loaded from a physical-intelligence/fast
    export via ``IntBPE.from_hf_export``), the pipeline matches the released
    FAST processor: DCT -> quantize -> BPE-compress."""

    num_bins: int = 1024
    # DCT coefficients are scaled before rounding; higher = finer.
    scale: float = 64.0
    bpe: "object | None" = None  # IntBPE; alphabet_size must equal num_bins

    @property
    def vocab_size(self) -> int:
        """Number of distinct action-token ids this codec emits."""
        return self.bpe.vocab_size if self.bpe is not None else self.num_bins

    def quantize(self, actions: np.ndarray) -> list[int]:
        """[H, D] continuous -> flat list of ints in [0, num_bins)."""
        actions = np.asarray(actions, dtype=np.float32)
        coeffs = dct(actions, axis=0, norm="ortho")
        q = np.round(coeffs * self.scale).astype(np.int64)
        q = np.clip(q + self.num_bins // 2, 0, self.num_bins - 1)
        return q.flatten().tolist()

    def encode(self, actions: np.ndarray) -> list[int]:
        symbols = self.quantize(actions)
        if self.bpe is not None:
            return self.bpe.encode(symbols)
        return symbols

    def decode(self, tokens: list[int], *, action_horizon: int, action_dim: int) -> np.ndarray:
        if self.bpe is not None:
            tokens = self.bpe.decode(list(tokens))
        want = action_horizon * action_dim
        arr = np.asarray(tokens[:want], dtype=np.int64)
        if arr.size < want:
            arr = np.pad(arr, (0, want - arr.size), constant_values=self.num_bins // 2)
        q = arr.reshape(action_horizon, action_dim) - self.num_bins // 2
        coeffs = q.astype(np.float32) / self.scale
        return idct(coeffs, axis=0, norm="ortho")


class FASTTokenizerMixin:
    """Maps action-token ints into the tail of the text vocab and back."""

    codec: FASTActionCodec
    # Tokens reserved at the very end of the vocab (specials etc.).
    skip_tokens: int = 128

    def _action_token_to_vocab(self, token: int) -> int:
        return self._tokenizer.vocab_size() - 1 - self.skip_tokens - token

    def _vocab_to_action_token(self, vocab_id: int) -> int:
        return self._tokenizer.vocab_size() - 1 - self.skip_tokens - vocab_id

    def encode_actions(self, actions: np.ndarray) -> list[int]:
        return [self._action_token_to_vocab(t) for t in self.codec.encode(actions)]

    def extract_actions(self, tokens: np.ndarray, action_horizon: int, action_dim: int) -> np.ndarray:
        """Pull action tokens out of a generated sequence and decode them."""
        vocab = self._tokenizer.vocab_size()
        lo = vocab - 1 - self.skip_tokens - (self.codec.vocab_size - 1)
        hi = vocab - 1 - self.skip_tokens
        ids = [int(t) for t in np.asarray(tokens).flatten() if lo <= int(t) <= hi]
        action_ints = [self._vocab_to_action_token(t) for t in ids]
        return self.codec.decode(action_ints, action_horizon=action_horizon, action_dim=action_dim)


class FASTTokenizer(PaligemmaTokenizer, FASTTokenizerMixin):
    """PaliGemma prompt + FAST action tokens (reference tokenizer.py:794-879)."""

    def __init__(self, *args, codec: FASTActionCodec | None = None, skip_tokens: int = 128, **kwargs):
        super().__init__(*args, **kwargs)
        self.codec = codec or FASTActionCodec()
        self.skip_tokens = skip_tokens

    def tokenize_with_actions(self, prompt: str, state, actions: np.ndarray | None, **kwargs):
        """Returns (tokens, attn_mask, action_mask, loss_mask)."""
        fmt = self._resolve_format(kwargs.get("is_vqa_sample", False), kwargs.get("is_prediction_sample", False))
        formatted = fmt.format_prompt(prompt, state, None)
        prefix = self._tokenizer.encode(formatted, add_bos=True)
        action_toks: list[int] = []
        if actions is not None:
            action_toks = self.encode_actions(actions) + [self._tokenizer.eos_id()]
        tokens = prefix + action_toks
        action_start, action_end = len(prefix), len(tokens)
        tokens = tokens[: self._max_len]
        n = len(tokens)
        pad_id = max(self._tokenizer.pad_id(), 0)
        attn = np.zeros(self._max_len, bool)
        attn[:n] = True
        action_mask = np.zeros(self._max_len, bool)
        action_mask[min(action_start, self._max_len) : min(action_end, self._max_len)] = True
        loss_mask = action_mask.copy()
        tokens = tokens + [pad_id] * (self._max_len - n)
        return np.asarray(tokens, np.int32), attn, action_mask, loss_mask


class Gemma3FASTTokenizer(Gemma3Tokenizer, FASTTokenizerMixin):
    """Gemma3 chat prompt + FAST action tokens (reference tokenizer.py:653-791).

    As in the JAX package it has no ``tokenize_with_actions``, so
    ``TokenizeFASTInputs`` over it raises ``AttributeError`` (the
    ``fast_gemma3_4b`` config's input transform)."""

    def __init__(self, *args, codec: FASTActionCodec | None = None, skip_tokens: int = 128, **kwargs):
        super().__init__(*args, **kwargs)
        self.codec = codec or FASTActionCodec()
        self.skip_tokens = skip_tokens


def make_fast_tokenizer(model_config, *, prompt_format="lap", prediction_format="default", gemma3_tokenizer_path=None):
    if "gemma3" in model_config.paligemma_variant:
        import os

        if gemma3_tokenizer_path:
            os.environ.setdefault("LAP_TPU_GEMMA3_TOKENIZER_MODEL", gemma3_tokenizer_path)
        return Gemma3FASTTokenizer(
            max_len=model_config.max_token_len,
            num_images=len(model_config.image_keys),
            prompt_format=prompt_format,
            prediction_format=prediction_format,
        )
    return FASTTokenizer(
        max_len=model_config.max_token_len,
        prompt_format=prompt_format,
        prediction_format=prediction_format,
    )


@dataclasses.dataclass(frozen=True)
class TokenizeFASTInputs:
    tokenizer: FASTTokenizer
    discrete_state_input: bool = True
    state_dropout: float = 0.0

    def __call__(self, data: dict) -> dict:
        prompt = data.pop("prompt", None)
        if prompt is None:
            raise ValueError("Prompt is required")
        if not isinstance(prompt, str):
            prompt = prompt.item() if hasattr(prompt, "item") else str(prompt)
        state = data.get("state") if self.discrete_state_input else None
        actions = data.pop("actions", None)
        tokens, attn, action_mask, loss_mask = self.tokenizer.tokenize_with_actions(
            prompt, state, actions
        )
        return {
            **data,
            "tokenized_prompt": tokens,
            "tokenized_prompt_mask": attn,
            "tokenized_langact_mask": action_mask,
            "token_loss_mask": loss_mask,
        }


@dataclasses.dataclass(frozen=True)
class ExtractFASTActions:
    tokenizer: FASTTokenizer
    action_horizon: int
    action_dim: int

    def __call__(self, data: dict) -> dict:
        if "tokens" not in data:
            return data
        actions = self.tokenizer.extract_actions(
            np.asarray(data["tokens"]), self.action_horizon, self.action_dim
        )
        return {**data, "actions": actions}
