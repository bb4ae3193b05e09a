"""Model-side data transforms: tokenization, normalization, repacking.

Covers the surface of lihzha/lap ``src/lap/transforms.py`` plus the
``openpi.transforms`` primitives LAP consumes (Group, InjectDefaultPrompt,
ResizeImages, flatten/unflatten/apply_tree, pad_to_dim) and
``openpi.shared.normalize.NormStats``.

Copied from ``lap_tpu/policies/model_transforms.py``; its imports point at the
port's copies.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from lap_tpu_torch.data.helpers import NormalizationType
from lap_tpu_torch.models.tokenizer import BaseTokenizer

# ---------------------------------------------------------------------------
# Pytree-dict utilities (openpi.transforms parity)
# ---------------------------------------------------------------------------


def flatten_dict(tree: dict, parent: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{parent}/{k}" if parent else str(k)
        if isinstance(v, dict):
            out.update(flatten_dict(v, key))
        else:
            out[key] = v
    return out


def unflatten_dict(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def apply_tree(data: dict, spec: dict, fn, *, strict: bool = False) -> dict:
    """Apply fn(value, spec_leaf) for every spec path found in data."""
    flat_data = flatten_dict(data)
    flat_spec = flatten_dict(spec)

    def transform(k: str, v):
        if k in flat_spec:
            return fn(v, flat_spec[k])
        return v

    if strict:
        missing = set(flat_spec) - set(flat_data)
        if missing:
            raise ValueError(f"norm-stat keys missing from data: {missing}")
    return unflatten_dict({k: transform(k, v) for k, v in flat_data.items()})


def pad_to_dim(x, dim: int, axis: int = -1, value: float = 0.0):
    x = np.asarray(x)
    cur = x.shape[axis]
    if cur >= dim:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, dim - cur)
    return np.pad(x, pad, constant_values=value)


# ---------------------------------------------------------------------------
# Norm stats
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NormStats:
    mean: np.ndarray
    std: np.ndarray
    q01: np.ndarray | None = None
    q99: np.ndarray | None = None
    min: np.ndarray | None = None
    max: np.ndarray | None = None
    # Transition count backing these stats; weighs multi-dataset/multi-host
    # merges (reference ExtendedNormStats.num_transitions).
    num_transitions: int = 0

    def to_dict(self) -> dict:
        d = {
            k: (None if v is None else np.asarray(v).tolist())
            for k, v in dataclasses.asdict(self).items()
            if k != "num_transitions"
        }
        d["num_transitions"] = int(self.num_transitions)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "NormStats":
        def arr(x):
            return None if x is None else np.asarray(x, dtype=np.float32)

        return cls(
            **{k: arr(d.get(k)) for k in ("mean", "std", "q01", "q99", "min", "max")},
            num_transitions=int(d.get("num_transitions", 0) or 0),
        )


def _assert_quantile_stats(norm_stats) -> None:
    for key, stats in flatten_dict(norm_stats).items():
        if getattr(stats, "q01", None) is None or getattr(stats, "q99", None) is None:
            raise ValueError(f"quantile stats missing for {key}")


# ---------------------------------------------------------------------------
# Transform chaining
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Group:
    """Ordered input/output transform lists (openpi.transforms.Group)."""

    inputs: tuple = ()
    outputs: tuple = ()

    def push(self, *, inputs: tuple = (), outputs: tuple = ()) -> "Group":
        # inputs appended (applied after existing); outputs prepended.
        return Group(inputs=(*self.inputs, *inputs), outputs=(*outputs, *self.outputs))


def compose(transforms) -> Any:
    def run(data):
        for t in transforms:
            data = t(data)
        return data

    return run


@dataclasses.dataclass(frozen=True)
class InjectDefaultPrompt:
    prompt: str | None

    def __call__(self, data: dict) -> dict:
        if self.prompt is not None and "prompt" not in data:
            data = {**data, "prompt": np.asarray(self.prompt)}
        return data


@dataclasses.dataclass(frozen=True)
class ResizeImages:
    height: int
    width: int

    def __call__(self, data: dict) -> dict:
        from lap_tpu_torch.utils.image import resize_with_pad_np

        data["image"] = {
            k: resize_with_pad_np(v, self.height, self.width)
            for k, v in data["image"].items()
        }
        return data


@dataclasses.dataclass(frozen=True)
class SafeRepackTransform:
    """Remap flat source paths to a new structure, with fallback candidates."""

    structure: dict
    strict: bool = False

    def __call__(self, data: dict) -> dict:
        flat_data = flatten_dict(data)
        flat_struct = flatten_dict(self.structure)
        out, missing = {}, []
        for out_key, src_spec in flat_struct.items():
            candidates = src_spec if isinstance(src_spec, (list, tuple)) else [src_spec]
            for src in candidates:
                if src in flat_data:
                    out[out_key] = flat_data[src]
                    break
            else:
                missing.append((out_key, tuple(candidates)))
        if self.strict and missing:
            raise KeyError(f"Missing source paths: {missing}")
        return unflatten_dict(out)


# ---------------------------------------------------------------------------
# Tokenization transforms
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TokenizePromptAndReasoning:
    """Tokenize prompt (+ state) and language actions into model fields
    (reference transforms.py:27-109)."""

    tokenizer: BaseTokenizer
    discrete_state_input: bool = False
    dataset_name_pad_len: int = 100
    verbose_mode: bool = False
    state_dropout: float = 0.0

    def __call__(self, data: dict) -> dict:
        prompt = data.pop("prompt", None)
        if prompt is None:
            raise ValueError("Prompt is required")
        if not isinstance(prompt, str):
            prompt = prompt.item() if hasattr(prompt, "item") else str(prompt)

        state = None
        if self.discrete_state_input:
            state = data.get("state")
            if state is None:
                raise ValueError("State is required")

        language_actions = data.pop("language_actions", None)
        dataset_name = data.pop("dataset_name", None)
        frame_description = data.pop("frame_description", "robot base frame")

        pad_id = max(self.tokenizer._tokenizer.pad_id(), 0)
        if dataset_name is not None:
            name_toks = self.tokenizer._tokenizer.encode(str(dataset_name))
            name_toks = [pad_id] * (self.dataset_name_pad_len - len(name_toks)) + name_toks
        else:
            name_toks = [pad_id] * self.dataset_name_pad_len
        tokenized_dataset_name = np.asarray(name_toks, dtype=np.int32)

        tokens, pad_mask, reasoning_mask, numeric_mask, direction_mask, token_loss_mask = (
            self.tokenizer.tokenize(
                prompt,
                language_actions,
                state,
                is_vqa_sample=data.get("is_vqa_sample", False),
                is_prediction_sample=data.get("is_prediction_sample", False),
                time_horizon_seconds=data.pop("time_horizon_seconds", None),
                frame_description=frame_description,
                state_dropout=self.state_dropout,
            )
        )

        result = {
            **data,
            "tokenized_prompt": tokens,
            "tokenized_prompt_mask": pad_mask,
            "tokenized_langact_mask": reasoning_mask,
            "token_loss_mask": token_loss_mask,
            "tokenized_dataset_name": tokenized_dataset_name,
        }
        if self.verbose_mode and numeric_mask is not None:
            result["critical_token_mask"] = np.logical_or(numeric_mask, direction_mask)
            result["number_token_mask"] = numeric_mask
            result["direction_token_mask"] = direction_mask
        return result


@dataclasses.dataclass(frozen=True)
class DetokenizeReasoning:
    tokenizer: BaseTokenizer

    def __call__(self, data: dict) -> dict:
        if "tokens" in data:
            text = self.tokenizer.decode(np.asarray(data["tokens"]).squeeze().astype(np.int32))
            return {**data, "reasoning": text}
        return data


# ---------------------------------------------------------------------------
# Normalization transforms
# ---------------------------------------------------------------------------


def _resolve(nt) -> NormalizationType:
    return NormalizationType(nt) if isinstance(nt, str) else nt


@dataclasses.dataclass(frozen=True)
class Normalize:
    norm_stats: dict | None
    normalization_type: NormalizationType | str = NormalizationType.NORMAL
    strict: bool = False

    def __post_init__(self):
        if self.norm_stats is not None and _resolve(self.normalization_type) == NormalizationType.BOUNDS_Q99:
            _assert_quantile_stats(self.norm_stats)

    def __call__(self, data: dict) -> dict:
        if self.norm_stats is None:
            return data
        nt = _resolve(self.normalization_type)
        fn = {
            NormalizationType.NORMAL: self._normal,
            NormalizationType.BOUNDS: self._bounds,
            NormalizationType.BOUNDS_Q99: self._quantile,
        }[nt]
        return apply_tree(data, self.norm_stats, fn, strict=self.strict)

    @staticmethod
    def _normal(x, stats):
        d = x.shape[-1]
        return (x - stats.mean[..., :d]) / (stats.std[..., :d] + 1e-6)

    @staticmethod
    def _bounds(x, stats):
        d = x.shape[-1]
        lo, hi = stats.min[..., :d], stats.max[..., :d]
        scaled = np.clip(2.0 * (x - lo) / (hi - lo + 1e-8) - 1.0, -1.0, 1.0)
        zeros = np.equal(lo, hi)
        while zeros.ndim < x.ndim:
            zeros = zeros[None, ...]
        return np.where(zeros, 0.0, scaled)

    @staticmethod
    def _quantile(x, stats):
        d = x.shape[-1]
        q01, q99 = stats.q01[..., :d], stats.q99[..., :d]
        scaled = (x - q01) / (q99 - q01 + 1e-6) * 2.0 - 1.0
        zeros = np.equal(q01, q99)
        while zeros.ndim < x.ndim:
            zeros = zeros[None, ...]
        return np.where(zeros, 0.0, scaled)


@dataclasses.dataclass(frozen=True)
class Unnormalize:
    norm_stats: dict | None
    normalization_type: NormalizationType | str = NormalizationType.NORMAL

    def __post_init__(self):
        if self.norm_stats is not None and _resolve(self.normalization_type) == NormalizationType.BOUNDS_Q99:
            _assert_quantile_stats(self.norm_stats)

    def __call__(self, data: dict) -> dict:
        if self.norm_stats is None:
            return data
        nt = _resolve(self.normalization_type)
        fn = {
            NormalizationType.NORMAL: self._normal,
            NormalizationType.BOUNDS: self._bounds,
            NormalizationType.BOUNDS_Q99: self._quantile,
        }[nt]
        return apply_tree(data, self.norm_stats, fn, strict=False)

    @staticmethod
    def _normal(x, stats):
        mean = pad_to_dim(stats.mean, x.shape[-1], value=0.0)
        std = pad_to_dim(stats.std, x.shape[-1], value=1.0)
        return x * (std + 1e-6) + mean

    @staticmethod
    def _bounds(x, stats):
        lo = pad_to_dim(stats.min, x.shape[-1], value=-1.0)
        hi = pad_to_dim(stats.max, x.shape[-1], value=1.0)
        return (x + 1.0) / 2.0 * (hi - lo + 1e-8) + lo

    @staticmethod
    def _quantile(x, stats):
        q01, q99 = stats.q01, stats.q99
        d = q01.shape[-1]
        if d < x.shape[-1]:
            head = (x[..., :d] + 1.0) / 2.0 * (q99 - q01 + 1e-6) + q01
            return np.concatenate([head, x[..., d:]], axis=-1)
        return (x + 1.0) / 2.0 * (q99 - q01 + 1e-6) + q01


@dataclasses.dataclass(frozen=True)
class PadStates:
    model_action_dim: int

    def __call__(self, data: dict) -> dict:
        data["state"] = pad_to_dim(data["state"], self.model_action_dim)
        return data
