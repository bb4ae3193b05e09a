"""Inference policies (port of ``lap_tpu/policies/policy.py``): host
transforms around ``LAP.sample_actions`` (``Policy``) and ``LAP.sample_tokens``
(``ARPolicy``), with per-request timing.

Each request draws its flow noise or sampling noise from a
``torch.Generator`` on the model's device, seeded from ``(seed, request
step)``, so concurrent requests never reuse noise and a run is reproducible
from its seed.
"""

from __future__ import annotations

import threading
import time
from collections.abc import Sequence

import numpy as np
import torch

from lap_tpu_torch.models.types import CoTObservation
from lap_tpu_torch.policies.model_transforms import compose

# Fields whose trailing axis is the (end-padded) token axis: the only ones
# prompt-length bucketing may slice.
_TOKEN_AXIS_KEYS = (
    "tokenized_prompt",
    "tokenized_prompt_mask",
    "token_ar_mask",
    "token_loss_mask",
    "tokenized_langact_mask",
    "critical_token_mask",
    "number_token_mask",
    "direction_token_mask",
)


def _trim_token_pad(batch: dict, multiple: int) -> dict:
    """Slice trailing all-pad token positions down to the next multiple of
    ``multiple``. Valid tokens are contiguous from 0 and padded positions
    carry no attention weight, so the result is unchanged."""
    mask = batch.get("tokenized_prompt_mask")
    if mask is None:
        return batch
    mask = np.asarray(mask)
    t = mask.shape[-1]
    n = int(mask.sum(axis=-1).max()) if mask.size else t
    bucket = min(t, max(multiple, -(-n // multiple) * multiple))
    if bucket >= t:
        return batch
    out = dict(batch)
    for k in _TOKEN_AXIS_KEYS:
        v = out.get(k)
        if v is not None and getattr(v, "shape", ()) and v.shape[-1] == t:
            out[k] = v[..., :bucket]
    leftover = [
        k
        for k, v in out.items()
        if k not in _TOKEN_AXIS_KEYS
        and k != "tokenized_dataset_name"
        and getattr(v, "ndim", 0) >= 1
        and v.shape[-1] == t
    ]
    if leftover:
        raise ValueError(
            f"token_bucket: fields with token-length last axis not covered by _TOKEN_AXIS_KEYS: {leftover}"
        )
    return out


def _stack_batch(inputs_list: list[dict]) -> dict:
    """Stack K transformed-input dicts (nested dicts of arrays) into one batch."""
    first = inputs_list[0]
    if isinstance(first, dict):
        return {k: _stack_batch([x[k] for x in inputs_list]) for k in first}
    return np.stack([np.asarray(x) for x in inputs_list])


def request_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed for request ``step`` of a policy seeded ``seed``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(2, np.uint64)[0] >> np.uint64(1))


class BasePolicy:
    def __init__(self, *, metadata: dict | None = None):
        self._metadata = metadata or {}
        self._step_lock = threading.Lock()
        self._step = 0

    def _next_step(self) -> int:
        """Unique per-request counter (requests may arrive from several threads)."""
        with self._step_lock:
            self._step += 1
            return self._step

    @property
    def metadata(self) -> dict:
        return self._metadata

    def infer(self, obs: dict) -> dict:  # pragma: no cover - interface
        raise NotImplementedError


class _ModelPolicy(BasePolicy):
    """Host transform pipeline around one model call; subclasses define
    ``_sample`` and ``_row_outputs``."""

    def __init__(
        self,
        model,
        *,
        input_transforms: Sequence = (),
        output_transforms: Sequence = (),
        seed: int = 0,
        token_bucket: int | None = None,
        metadata: dict | None = None,
    ):
        super().__init__(metadata=metadata)
        self._model = model
        self._input = compose(input_transforms)
        self._output = compose(output_transforms)
        self._token_bucket = token_bucket
        self._seed = seed

    def infer(self, obs: dict) -> dict:
        t_start = time.monotonic()
        result = self._infer_prepared([self._prepare(obs)])[0]
        result["policy_timing"] = {"infer_ms": (time.monotonic() - t_start) * 1000.0}
        return result

    def _prepare(self, obs: dict) -> dict:
        return self._input(dict(obs))

    def _sample(self, observation: CoTObservation, generator: torch.Generator) -> torch.Tensor:
        raise NotImplementedError

    def _row_outputs(self, sampled: np.ndarray, i: int) -> dict:
        raise NotImplementedError

    def _infer_prepared(self, inputs_list: list[dict], n_results: int | None = None) -> list[dict]:
        """One batched model call over K prepared requests; each row draws its
        own noise from the request's generator."""
        batch = _stack_batch(inputs_list)
        if self._token_bucket:
            batch = _trim_token_pad(batch, self._token_bucket)
        device = self._model.device
        observation = CoTObservation.from_dict(batch, device=device)
        generator = torch.Generator(device=device).manual_seed(request_seed(self._seed, self._next_step()))
        sampled = self._sample(observation, generator).cpu().numpy()
        state = np.asarray(batch["state"])
        results = []
        for i, inputs in enumerate(inputs_list[:n_results]):
            outputs = {"state": state[i], **self._row_outputs(sampled, i)}
            if "raw_state" in inputs:
                outputs["raw_state"] = np.asarray(inputs["raw_state"])
            results.append(self._output(outputs))
        return results


class Policy(_ModelPolicy):
    """Flow-matching action-chunk policy."""

    def __init__(self, model, *, num_steps: int = 10, **kw):
        super().__init__(model, **kw)
        self._num_steps = num_steps

    def _sample(self, observation, generator):
        return self._model.sample_actions(observation, num_steps=self._num_steps, generator=generator)

    def _row_outputs(self, sampled, i):
        return {"actions": sampled[i]}


class ARPolicy(_ModelPolicy):
    """Autoregressive language-action policy: ``[1, T]`` int32 tokens per
    request. ``stop_on_eos=False`` decodes the whole budget."""

    def __init__(self, model, *, max_decoding_steps: int = 390, temperature: float = 0.0,
                 stop_on_eos: bool = True, **kw):
        super().__init__(model, **kw)
        self._max_decoding_steps = max_decoding_steps
        self._temperature = temperature
        self._stop_on_eos = stop_on_eos

    def _sample(self, observation, generator):
        return self._model.sample_tokens(
            observation, max_decoding_steps=self._max_decoding_steps, temperature=self._temperature,
            stop_on_eos=self._stop_on_eos, generator=generator,
        )

    def _row_outputs(self, sampled, i):
        return {"tokens": sampled[i : i + 1]}
