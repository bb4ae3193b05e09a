"""Dataset registry.

Parity with lihzha/lap ``datasets/registry.py``: decorator-driven exact-name
+ pattern registration with priority, per-dataset DatasetConfig (wrist
rotation, image size, action bounds, bimanual/navigation flags), and
auto-assigned VQA dataset IDs (0 reserved for non-VQA).

Copied from ``lap_tpu/data/registry.py``; its imports point at the port's
copies.
"""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Callable


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    name: str
    standardize_fn: Callable | None = None
    image_obs_keys: dict | None = None  # canonical -> raw key
    state_obs_keys: tuple[str, ...] = ()
    needs_wrist_rotation: bool = False
    tfds_version: str | None = None
    action_bounds: tuple[float, float] | None = None
    image_size: tuple[int, int] = (224, 224)
    is_bimanual: bool = False
    is_navigation: bool = False
    is_vqa: bool = False
    # Proprio flavor for norm-stats grouping (reference helpers.py:40-55):
    # "pos_euler" (eef pose), "joint", or "none" (no usable proprio).
    state_encoding: str = "pos_euler"
    control_frequency: float = 5.0
    sampling_weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class _Entry:
    matcher: str
    config: DatasetConfig
    exact: bool
    priority: int


_REGISTRY: list[_Entry] = []
VQA_DATASET_ID_MAP: dict[str, int] = {}
VQA_DATASET_ID_TO_NAME: dict[int, str] = {}
_NEXT_VQA_ID = [1]  # 0 reserved for non-VQA


def register_dataset(
    name_or_pattern: str,
    *,
    exact: bool = True,
    priority: int = 0,
    **config_kwargs,
):
    """Register a DatasetConfig under an exact name or regex pattern."""

    def wrap(standardize_fn):
        cfg = DatasetConfig(
            name=name_or_pattern, standardize_fn=standardize_fn, **config_kwargs
        )
        _REGISTRY.append(_Entry(name_or_pattern, cfg, exact, priority))
        if cfg.is_vqa:
            vqa_id = _NEXT_VQA_ID[0]
            _NEXT_VQA_ID[0] += 1
            VQA_DATASET_ID_MAP[name_or_pattern] = vqa_id
            VQA_DATASET_ID_TO_NAME[vqa_id] = name_or_pattern
        return standardize_fn

    return wrap


def get_dataset_config(name: str) -> DatasetConfig:
    candidates = []
    for entry in _REGISTRY:
        if entry.exact and entry.matcher == name:
            candidates.append((2, entry.priority, entry))
        elif not entry.exact and re.search(entry.matcher, name):
            candidates.append((1, entry.priority, entry))
    if not candidates:
        raise KeyError(f"dataset {name!r} not registered")
    candidates.sort(key=lambda c: (c[0], c[1]), reverse=True)
    entry = candidates[0][2]
    return dataclasses.replace(entry.config, name=name)


def needs_wrist_rotation(name: str) -> bool:
    try:
        return get_dataset_config(name).needs_wrist_rotation
    except KeyError:
        return False


def get_vqa_dataset_id(name: str) -> int:
    return VQA_DATASET_ID_MAP.get(name, 0)


def registered_names() -> list[str]:
    return [e.matcher for e in _REGISTRY]
