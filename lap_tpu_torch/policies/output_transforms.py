"""CoTOutputs: model outputs -> robot actions.

Capability parity with lihzha/lap ``policies/transforms/output_transforms.py``:
parse generated reasoning to numeric deltas (standard) or VLA-0 integer grids
with unnormalization (bounds_q99 / bounds / normal).

Copied from ``lap_tpu/policies/output_transforms.py``; its imports point at
the port's copies.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

from lap_tpu_torch.policies.lang_action_formats import (
    LanguageActionFormat,
    VLA0ActionFormat,
    get_language_action_format,
)


def _stat(stats, name):
    if stats is None:
        return None
    if isinstance(stats, dict):
        val = stats.get(name)
    else:
        val = getattr(stats, name, None)
    return None if val is None else np.asarray(val)


def _blend_tail(unnormed, actions, dim):
    if actions.shape[-1] > dim:
        return np.concatenate([unnormed, actions[..., dim:]], axis=-1)
    return unnormed


def unnormalize(actions: np.ndarray, stats, normalization_type: str) -> np.ndarray:
    """Invert the normalization applied at training time."""
    if stats is None:
        return actions
    if normalization_type == "bounds_q99":
        q01, q99 = _stat(stats, "q01"), _stat(stats, "q99")
        if q01 is None or q99 is None:
            return actions
        dim = min(q01.shape[-1], actions.shape[-1])
        out = (actions[..., :dim] + 1.0) / 2.0 * (q99[..., :dim] - q01[..., :dim] + 1e-6) + q01[..., :dim]
        return _blend_tail(out, actions, dim)
    if normalization_type == "bounds":
        lo, hi = _stat(stats, "min"), _stat(stats, "max")
        if lo is None or hi is None:
            return actions
        dim = min(lo.shape[-1], actions.shape[-1])
        out = (actions[..., :dim] + 1.0) / 2.0 * (hi[..., :dim] - lo[..., :dim] + 1e-8) + lo[..., :dim]
        return _blend_tail(out, actions, dim)
    if normalization_type == "normal":
        mean, std = _stat(stats, "mean"), _stat(stats, "std")
        if mean is None or std is None:
            return actions
        dim = min(mean.shape[-1], actions.shape[-1])
        out = actions[..., :dim] * (std[..., :dim] + 1e-6) + mean[..., :dim]
        return _blend_tail(out, actions, dim)
    return actions


@dataclasses.dataclass(frozen=True)
class CoTOutputs:
    language_action_format: LanguageActionFormat | str | None = None
    norm_stats: dict | None = None
    normalization_type: str = "bounds_q99"
    transform_strategy: Literal["standard", "vla0"] = "standard"

    def __post_init__(self):
        fmt = self.language_action_format
        if fmt is not None and not isinstance(fmt, LanguageActionFormat):
            object.__setattr__(self, "language_action_format", get_language_action_format(fmt))

    def __call__(self, data: dict) -> dict:
        if "reasoning" not in data:
            return {"actions": np.asarray(data["actions"]), "reasoning": None}
        reasoning = data["reasoning"]
        fmt = self.language_action_format
        if fmt is None or reasoning is None:
            raise ValueError("reasoning output requires a language_action_format")

        if self.transform_strategy == "vla0" and isinstance(fmt, VLA0ActionFormat):
            actions = fmt.parse_to_full_actions(reasoning)
            stats = (self.norm_stats or {}).get("actions") if self.norm_stats else None
            actions = unnormalize(actions, stats, self.normalization_type)
            return {"actions": actions, "reasoning": reasoning}

        initial_state = None
        if fmt.use_eef_frame and "raw_state" in data:
            initial_state = np.asarray(data["raw_state"])
        movement, gripper = fmt.parse_language_to_deltas(reasoning, initial_state=initial_state)
        action = movement if gripper is None else np.concatenate([movement, [gripper]])
        return {"actions": action, "reasoning": reasoning}
