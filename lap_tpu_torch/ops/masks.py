"""Attention-mask construction (port of ``lap_tpu/ops/masks.py``).

Boolean masks, True = may attend; the flash kernel reads the same masks.
"""

from __future__ import annotations

import torch


def make_attn_mask(input_mask: torch.Tensor, mask_ar: torch.Tensor) -> torch.Tensor:
    """[B, T, T] prefix-LM mask from per-token metadata.

    ``mask_ar[i]`` True starts a new segment at token i: tokens of one segment
    attend bidirectionally, each segment attends causally to all earlier ones,
    and padding (``input_mask`` False) is never attended to.
    """
    cumsum = torch.cumsum(mask_ar.to(torch.int32), dim=-1)
    attn = cumsum[:, None, :] <= cumsum[:, :, None]
    return attn & input_mask.to(torch.bool)[:, None, :]


def sliding_window_mask(
    q_positions: torch.Tensor, kv_positions: torch.Tensor, window: int
) -> torch.Tensor:
    """[B, T, S] mask allowing keys with ``q_pos - window < kv_pos``."""
    diff = q_positions[:, :, None] - kv_positions[:, None, :]
    return diff < window


def bidirectional_block_mask(q_flags: torch.Tensor, kv_flags: torch.Tensor) -> torch.Tensor:
    """[B, T, S] mask True where both tokens carry the flag."""
    return q_flags[:, :, None] & kv_flags[:, None, :]


def combine_masks(*masks: torch.Tensor | None) -> torch.Tensor | None:
    """AND together masks, skipping Nones."""
    out = None
    for m in masks:
        if m is None:
            continue
        out = m if out is None else (out & m)
    return out
