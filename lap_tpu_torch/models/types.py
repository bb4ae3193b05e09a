"""Observation containers (port of ``lap_tpu/models/types.py``).

Dataclasses of tensors: per-camera images and validity masks, the state, the
tokenized prompt with its masks, and the chain-of-thought extras.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

IMAGE_RESOLUTION = (224, 224)
IMAGE_KEYS = ("base_0_rgb", "left_wrist_0_rgb")


@dataclasses.dataclass(frozen=True)
class Observation:
    """A single (batched) model input."""

    images: dict[str, Any]
    image_masks: dict[str, Any]
    state: Any
    tokenized_prompt: Any = None
    tokenized_prompt_mask: Any = None
    token_ar_mask: Any = None
    token_loss_mask: Any = None

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    @classmethod
    def from_dict(cls, data: dict, *, device=None):
        return cls(**_base_fields_from_dict(data, device=device))


_COT_KEYS = (
    "tokenized_langact_mask",
    "critical_token_mask",
    "number_token_mask",
    "direction_token_mask",
    "sample_mask",
    "tokenized_dataset_name",
    "is_vqa_sample",
    "is_prediction_sample",
    "vqa_dataset_id",
)


@dataclasses.dataclass(frozen=True)
class CoTObservation(Observation):
    """Observation with chain-of-thought (language-action) extras."""

    tokenized_langact_mask: Any = None
    critical_token_mask: Any = None
    number_token_mask: Any = None
    direction_token_mask: Any = None
    sample_mask: Any = None
    tokenized_dataset_name: Any = None
    is_vqa_sample: Any = None
    is_prediction_sample: Any = None
    vqa_dataset_id: Any = None

    @classmethod
    def from_dict(cls, data: dict, *, device=None):
        fields = _base_fields_from_dict(data, device=device)
        cot_src = data.get("extras", {}).get("cot", {})
        extras = {k: _tensor(data.get(k, cot_src.get(k)), device) for k in _COT_KEYS}
        return cls(**fields, **extras)


def _tensor(x, device):
    """numpy / scalar / tensor -> tensor on ``device`` (None passes)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device)
    arr = np.array(x)  # a writable copy
    if arr.dtype.kind in "USO":  # strings (e.g. dataset names) stay on the host
        return arr
    return torch.from_numpy(arr).to(device)


def _to_float_image(img: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1]; float images pass through."""
    if not torch.is_floating_point(img):
        return img.to(torch.float32) / 127.5 - 1.0
    return img


def _base_fields_from_dict(data: dict, *, device=None) -> dict:
    # Images travel to the device as uint8 (4x fewer bytes) and are converted
    # there.
    return dict(
        images={k: _to_float_image(_tensor(v, device)) for k, v in data["image"].items()},
        image_masks={k: _tensor(v, device) for k, v in data.get("image_mask", {}).items()},
        state=_tensor(data["state"], device),
        tokenized_prompt=_tensor(data.get("tokenized_prompt"), device),
        tokenized_prompt_mask=_tensor(data.get("tokenized_prompt_mask"), device),
        token_ar_mask=_tensor(data.get("token_ar_mask"), device),
        token_loss_mask=_tensor(data.get("token_loss_mask"), device),
    )


def fake_obs(
    *,
    batch_size: int = 1,
    image_keys: tuple[str, ...] = IMAGE_KEYS,
    action_dim: int = 7,
    max_token_len: int = 48,
    resolution: tuple[int, int] = IMAGE_RESOLUTION,
    device=None,
) -> CoTObservation:
    """A zero observation matching the model input spec."""
    h, w = resolution
    kw = dict(device=device)
    return CoTObservation(
        images={k: torch.zeros((batch_size, h, w, 3), dtype=torch.float32, **kw) for k in image_keys},
        image_masks={k: torch.ones((batch_size,), dtype=torch.bool, **kw) for k in image_keys},
        state=torch.zeros((batch_size, action_dim), dtype=torch.float32, **kw),
        tokenized_prompt=torch.zeros((batch_size, max_token_len), dtype=torch.int32, **kw),
        tokenized_prompt_mask=torch.ones((batch_size, max_token_len), dtype=torch.bool, **kw),
        tokenized_langact_mask=torch.zeros((batch_size, max_token_len), dtype=torch.bool, **kw),
        token_loss_mask=torch.zeros((batch_size, max_token_len), dtype=torch.bool, **kw),
        sample_mask=torch.ones((batch_size,), dtype=torch.bool, **kw),
    )
