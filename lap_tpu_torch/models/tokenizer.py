"""Chain-of-thought tokenizers.

Capability parity with lihzha/lap ``src/lap/models/tokenizer.py``: the
BaseTokenizer mask machinery (attention / reasoning / loss masks, reasoning
dropout, number+direction masks via piece checkers), the PaliGemma
sentencepiece tokenizer with LAP prompt formats, and the Gemma3 IT chat
format with per-image placeholder blocks.

Backend: our from-scratch sentencepiece codec (``lap_tpu_torch.models.spm``). The
real PaliGemma model file is used when present (``LAP_TPU_TOKENIZER_MODEL``
env var or the asset cache); otherwise a deterministic built-in test
vocabulary keeps the full pipeline runnable offline.

Copied from ``lap_tpu/models/tokenizer.py``; its imports point at the port's
copies.
"""

from __future__ import annotations

import logging
import os
from abc import ABC, abstractmethod
from pathlib import Path

import numpy as np

from lap_tpu_torch.models import spm
from lap_tpu_torch.models.prompts import (
    DEFAULT_VQA_PROMPT_FORMAT,
    PREDICTION_PROMPT_FORMAT_REGISTRY,
    PROMPT_FORMAT_REGISTRY,
    PromptFormat,
    is_number,
)

logger = logging.getLogger(__name__)

# Reference model asset (gs://big_vision/paligemma_tokenizer.model); place a
# local copy at this env var to get byte-identical tokenization.
TOKENIZER_MODEL_ENV = "LAP_TPU_TOKENIZER_MODEL"
GEMMA3_TOKENIZER_MODEL_ENV = "LAP_TPU_GEMMA3_TOKENIZER_MODEL"

# Gemma3 special tokens (tokenizer.py:22-34 in the reference).
GEMMA3_BEGIN_IMAGE_TOKEN = 255999
GEMMA3_END_IMAGE_TOKEN = 262144
GEMMA3_IMAGE_TOKEN = 262145
GEMMA3_EOS_TOKEN = 1
GEMMA3_BOS_TOKEN = 2
GEMMA3_START_OF_TURN_TOKEN = 106
GEMMA3_END_OF_TURN_TOKEN = 107
GEMMA3_USER_TOKEN = 1645
GEMMA3_MODEL_TOKEN = 2516
GEMMA3_NEWLINE_TOKEN = 108
GEMMA3_IMAGE_PLACEHOLDER_LEN = 256


def _load_processor(env_var: str) -> spm.SentencePieceProcessor:
    path = os.environ.get(env_var)
    if path and Path(path).exists():
        proc = spm.SentencePieceProcessor(model_file=path)
        proc.is_test_vocab = False
        return proc
    logger.warning(
        "%s not set or missing; using the built-in deterministic test "
        "vocabulary (NOT byte-compatible with released checkpoints).",
        env_var,
    )
    proc = spm.build_test_processor()
    proc.is_test_vocab = True
    return proc


def _resolve_prompt_format(fmt) -> PromptFormat:
    if isinstance(fmt, str):
        if fmt not in PROMPT_FORMAT_REGISTRY:
            raise ValueError(f"Unknown prompt format: {fmt}")
        return PROMPT_FORMAT_REGISTRY[fmt]
    return fmt


def _resolve_prediction_format(fmt) -> PromptFormat:
    if isinstance(fmt, str):
        if fmt not in PREDICTION_PROMPT_FORMAT_REGISTRY:
            raise ValueError(f"Unknown prediction format: {fmt}")
        return PREDICTION_PROMPT_FORMAT_REGISTRY[fmt]
    return fmt


class BaseTokenizer(ABC):
    """Mask construction shared by all CoT tokenizers."""

    def _init_formats(self, prompt_format, prediction_format, reasoning_mask_prob):
        self.reasoning_mask_prob = reasoning_mask_prob
        self._prompt_format = _resolve_prompt_format(prompt_format)
        self._prediction_format = _resolve_prediction_format(prediction_format)
        self._vqa_format = DEFAULT_VQA_PROMPT_FORMAT

    def _resolve_format(self, is_vqa_sample, is_prediction_sample) -> PromptFormat:
        if is_prediction_sample:
            return self._prediction_format
        if is_vqa_sample:
            return self._vqa_format
        return self._prompt_format

    def _create_base_masks(self, token_count, reasoning_start, reasoning_end, has_reasoning):
        attn_mask = np.zeros(self._max_len, dtype=bool)
        token_loss_mask = np.ones(self._max_len, dtype=bool)
        attn_mask[:token_count] = True
        if not has_reasoning:
            return attn_mask, None, token_loss_mask
        reasoning_mask = np.zeros(self._max_len, dtype=bool)
        start = max(0, min(self._max_len, reasoning_start))
        end = max(0, min(self._max_len, reasoning_end))
        if end > start:
            reasoning_mask[start:end] = True
        return attn_mask, reasoning_mask, token_loss_mask

    def _apply_reasoning_dropout(self, token_loss_mask, reasoning_mask, is_vqa_sample):
        if not 0.0 <= self.reasoning_mask_prob <= 1.0:
            raise ValueError("reasoning_mask_prob must be in [0, 1]")
        if self.reasoning_mask_prob <= 0.0 or is_vqa_sample:
            return token_loss_mask
        idx = np.where(reasoning_mask)[0]
        if len(idx) == 0:
            return token_loss_mask
        drop = np.random.rand(len(idx)) < self.reasoning_mask_prob
        token_loss_mask[idx[drop]] = False
        return token_loss_mask

    def _build_number_direction_masks(self, tokens, reasoning_mask, fmt, is_vqa_sample):
        number_mask = np.zeros(self._max_len, dtype=bool)
        direction_mask = np.zeros(self._max_len, dtype=bool)
        if is_vqa_sample:
            return number_mask, direction_mask
        for i in np.where(reasoning_mask)[0]:
            piece = self._get_token_piece(tokens[i])
            if piece:
                if is_number(piece):
                    number_mask[i] = True
                if fmt.direction_token_checker and fmt.direction_token_checker(piece):
                    direction_mask[i] = True
        return number_mask, direction_mask

    @abstractmethod
    def _get_token_piece(self, token_id: int) -> str: ...

    @abstractmethod
    def decode(self, tokens) -> str: ...

    @abstractmethod
    def encode(self, text, add_bos=False, add_eos=False): ...


class PaligemmaTokenizer(BaseTokenizer):
    """PaliGemma sentencepiece tokenizer + LAP prompt/mask construction
    (reference tokenizer.py:221-330)."""

    def __init__(
        self,
        max_len: int = 48,
        prompt_format="lap",
        prediction_format="default",
        reasoning_mask_prob: float = 0.0,
    ):
        self._tokenizer = _load_processor(TOKENIZER_MODEL_ENV)
        self._max_len = max_len
        self._init_formats(prompt_format, prediction_format, reasoning_mask_prob)

    def _get_token_piece(self, token_id: int) -> str:
        return self._tokenizer.id_to_piece(token_id)

    def tokenize(
        self,
        prompt: str,
        reasoning: str | None = None,
        state: np.ndarray | None = None,
        state_type: str | None = None,
        *,
        is_vqa_sample: bool = False,
        is_prediction_sample: bool = False,
        time_horizon_seconds: float | None = None,
        frame_description: str = "robot base frame",
        state_dropout: float = 0.0,
    ):
        """Returns (tokens, attn_mask, reasoning_mask, number_mask,
        direction_mask, token_loss_mask), each padded to max_len."""
        fmt = self._resolve_format(is_vqa_sample, is_prediction_sample)
        formatted = fmt.format_prompt(
            prompt,
            state,
            state_type,
            time_horizon_seconds=None if is_vqa_sample else time_horizon_seconds,
            frame_description=frame_description,
            state_dropout=state_dropout,
        )
        pad_id = self._tokenizer.pad_id()
        if pad_id < 0:
            pad_id = 0
        tokens = self._tokenizer.encode(formatted, add_bos=True, add_eos=False)
        reasoning_start = len(tokens)
        if reasoning is not None:
            clean = reasoning.strip().replace("_", " ").replace("\n", " ")
            tokens = tokens + self._tokenizer.encode(clean, add_bos=False, add_eos=True)
        reasoning_end = len(tokens)
        if len(tokens) > self._max_len:
            tokens = tokens[: self._max_len]
            reasoning_end = min(reasoning_end, self._max_len)

        attn_mask, reasoning_mask, token_loss_mask = self._create_base_masks(
            len(tokens), reasoning_start, reasoning_end, reasoning is not None
        )
        if reasoning is None:
            number_mask = direction_mask = None
        else:
            token_loss_mask = self._apply_reasoning_dropout(
                token_loss_mask, reasoning_mask, is_vqa_sample
            )
            number_mask, direction_mask = self._build_number_direction_masks(
                tokens, reasoning_mask, fmt, is_vqa_sample
            )
        tokens = tokens + [pad_id] * (self._max_len - len(tokens))
        return (
            np.asarray(tokens, dtype=np.int32),
            attn_mask,
            reasoning_mask,
            number_mask,
            direction_mask,
            token_loss_mask,
        )

    def decode(self, tokens) -> str:
        if not isinstance(tokens, list):
            tokens = np.asarray(tokens).tolist()
        vocab = self._tokenizer.vocab_size()
        return self._tokenizer.decode([t for t in tokens if 0 <= t < vocab]).strip()

    def encode(self, text, add_bos=False, add_eos=False):
        return self._tokenizer.encode(text, add_bos=add_bos, add_eos=add_eos)


class Gemma3Tokenizer(BaseTokenizer):
    """Gemma3 IT chat-format tokenizer with image placeholder blocks
    (reference tokenizer.py:333-560)."""

    DEFAULT_SYSTEM_MESSAGE = "You are a helpful robot assistant."

    def __init__(
        self,
        max_len: int = 800,
        num_images: int = 2,
        prompt_format="lap",
        prediction_format="default",
        reasoning_mask_prob: float = 0.0,
        system_message: str | None = None,
    ):
        self._tokenizer = _load_processor(GEMMA3_TOKENIZER_MODEL_ENV)
        self._max_len = max_len
        self._num_images = num_images
        self._system_message = system_message or self.DEFAULT_SYSTEM_MESSAGE
        self._init_formats(prompt_format, prediction_format, reasoning_mask_prob)

    def _get_token_piece(self, token_id: int) -> str:
        if token_id >= self._tokenizer.vocab_size():
            return ""
        return self._tokenizer.id_to_piece(token_id)

    def _build_image_placeholder(self) -> list[int]:
        """[BOI] + 256 x [IMG] + [EOI] + newline."""
        return (
            [GEMMA3_BEGIN_IMAGE_TOKEN]
            + [GEMMA3_IMAGE_TOKEN] * GEMMA3_IMAGE_PLACEHOLDER_LEN
            + [GEMMA3_END_IMAGE_TOKEN, GEMMA3_NEWLINE_TOKEN]
        )

    def _build_gemma3_prefix(self, formatted_prompt: str, num_images: int) -> list[int]:
        """<bos><start_of_turn>user\\n[sys]\\n\\n[images][prompt]<end_of_turn>\\n
        <start_of_turn>model\\n"""
        toks = [GEMMA3_BOS_TOKEN, GEMMA3_START_OF_TURN_TOKEN, GEMMA3_USER_TOKEN,
                GEMMA3_NEWLINE_TOKEN]
        toks += self._tokenizer.encode(self._system_message)
        toks += [GEMMA3_NEWLINE_TOKEN, GEMMA3_NEWLINE_TOKEN]
        for _ in range(num_images):
            toks += self._build_image_placeholder()
        toks += self._tokenizer.encode(formatted_prompt)
        toks += [GEMMA3_END_OF_TURN_TOKEN, GEMMA3_NEWLINE_TOKEN,
                 GEMMA3_START_OF_TURN_TOKEN, GEMMA3_MODEL_TOKEN, GEMMA3_NEWLINE_TOKEN]
        return toks

    def tokenize(
        self,
        prompt: str,
        reasoning: str | None = None,
        state: np.ndarray | None = None,
        state_type: str | None = None,
        *,
        is_vqa_sample: bool = False,
        is_prediction_sample: bool = False,
        time_horizon_seconds: float | None = None,
        frame_description: str = "robot base frame",
        state_dropout: float = 0.0,
        num_images: int | None = None,
    ):
        fmt = self._resolve_format(is_vqa_sample, is_prediction_sample)
        formatted = fmt.format_prompt(
            prompt,
            state,
            state_type,
            time_horizon_seconds=None if is_vqa_sample else time_horizon_seconds,
            frame_description=frame_description,
            state_dropout=state_dropout,
        )
        tokens = self._build_gemma3_prefix(
            formatted, self._num_images if num_images is None else num_images
        )
        reasoning_start = len(tokens)
        if reasoning is not None:
            clean = reasoning.strip().replace("_", " ").replace("\n", " ")
            tokens = tokens + self._tokenizer.encode(clean) + [
                GEMMA3_END_OF_TURN_TOKEN,
                GEMMA3_EOS_TOKEN,
            ]
        reasoning_end = len(tokens)
        if len(tokens) > self._max_len:
            tokens = tokens[: self._max_len]
            reasoning_end = min(reasoning_end, self._max_len)

        attn_mask, reasoning_mask, token_loss_mask = self._create_base_masks(
            len(tokens), reasoning_start, reasoning_end, reasoning is not None
        )
        if reasoning is None:
            number_mask = direction_mask = None
        else:
            token_loss_mask = self._apply_reasoning_dropout(
                token_loss_mask, reasoning_mask, is_vqa_sample
            )
            number_mask, direction_mask = self._build_number_direction_masks(
                tokens, reasoning_mask, fmt, is_vqa_sample
            )
        tokens = tokens + [0] * (self._max_len - len(tokens))
        return (
            np.asarray(tokens, dtype=np.int32),
            attn_mask,
            reasoning_mask,
            number_mask,
            direction_mask,
            token_loss_mask,
        )

    def decode(self, tokens) -> str:
        if not isinstance(tokens, list):
            tokens = np.asarray(tokens).tolist()
        vocab = self._tokenizer.vocab_size()
        specials = {
            GEMMA3_BEGIN_IMAGE_TOKEN, GEMMA3_END_IMAGE_TOKEN, GEMMA3_IMAGE_TOKEN,
            GEMMA3_START_OF_TURN_TOKEN, GEMMA3_END_OF_TURN_TOKEN,
        }
        return self._tokenizer.decode(
            [t for t in tokens if 0 <= t < vocab and t not in specials]
        ).strip()

    def encode(self, text, add_bos=False, add_eos=False):
        return self._tokenizer.encode(text, add_bos=add_bos, add_eos=add_eos)
