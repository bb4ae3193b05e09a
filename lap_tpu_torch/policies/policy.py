"""Inference policies (port of ``lap_tpu/policies/policy.py``): host
transforms around ``LAP.sample_actions`` (``Policy``) and ``LAP.sample_tokens``
(``ARPolicy``), with per-request timing, and ``PolicyRecorder``, which writes
every request and response to an ``.npz``.

Each request draws its flow noise or sampling noise from a
``torch.Generator`` on the model's device, seeded from ``(seed, request
step)``, so concurrent requests never reuse noise and a run is reproducible
from its seed.

Tensor-parallel serving (a model sharded by ``parallel.sharding.parallelize_``
over a tp group): only the group's first rank takes requests. Each model
call there, batched by ``BatchingPolicy`` or trimmed by the token bucket as
it may be, first broadcasts the prepared batch and its request step to the
group; the other ranks loop in ``serve_followers`` on those broadcasts, run
the same model call on their shards, and return at ``stop_followers``. The
calls of one policy are serialised, so every rank sees them in one order.
Policies built over the same ranks share their process group: serve one at
a time, and stop it before the next.
"""

from __future__ import annotations

import pathlib
import threading
import time
from collections.abc import Sequence

import numpy as np
import torch
import torch.distributed as dist

from lap_tpu_torch.models.types import CoTObservation
from lap_tpu_torch.parallel import mesh as mesh_lib
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
    """Stack K transformed-input dicts (nested dicts of arrays, bools and
    ints) into one batch. ``None`` stays ``None``, as an empty subtree does
    under ``jax.tree.map``."""
    first = inputs_list[0]
    if isinstance(first, dict):
        return {k: _stack_batch([x[k] for x in inputs_list]) for k in first}
    if first is None:
        return None
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
        par = getattr(model, "parallel", None)
        self._tp_group = None if par is None else mesh_lib.tp_group(par.mesh)
        self._tp_lock = threading.Lock()

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

    def _infer_prepared(self, inputs_list: list[dict]) -> list[dict]:
        """One batched model call over K prepared requests; each row draws its
        own noise from the request's generator."""
        batch = _stack_batch(inputs_list)
        if self._token_bucket:
            batch = _trim_token_pad(batch, self._token_bucket)
        if self._tp_group is None:
            sampled = self._run(batch, self._next_step())
        else:
            with self._tp_lock:
                step = self._next_step()
                _broadcast(self._tp_group, {"policy": type(self).__name__, "batch": batch, "step": step})
                sampled = self._run(batch, step)
        state = np.asarray(batch["state"])
        results = []
        for i, inputs in enumerate(inputs_list):
            outputs = {"state": state[i], **self._row_outputs(sampled, i)}
            if "raw_state" in inputs:
                outputs["raw_state"] = np.asarray(inputs["raw_state"])
            results.append(self._output(outputs))
        return results


    def _run(self, batch: dict, step: int) -> np.ndarray:
        """The model call of request ``step`` on a prepared batch."""
        device = self._model.device
        observation = CoTObservation.from_dict(batch, device=device)
        generator = torch.Generator(device=device).manual_seed(request_seed(self._seed, step))
        return self._sample(observation, generator).cpu().numpy()


def _broadcast(group, message):
    """``message`` from the group's first rank to the others (returned there)."""
    box = [message]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
    return box[0]


def model_policy(policy) -> "_ModelPolicy":
    """The model policy under ``BatchingPolicy``/``PolicyRecorder`` wrappers."""
    while not isinstance(policy, _ModelPolicy):
        policy = policy._policy
    return policy


def serve_followers(policy) -> int:
    """On a tp group's other ranks: run the model call of every request the
    first rank broadcasts, until ``stop_followers``; returns the number of
    calls run."""
    policy = model_policy(policy)
    if policy._tp_group is None or dist.get_rank(policy._tp_group) == 0:
        raise ValueError("serve_followers runs on the tp group's other ranks, of a tensor-parallel policy")
    calls = 0
    while True:
        message = _broadcast(policy._tp_group, None)
        if message is None:
            return calls
        if message["policy"] != type(policy).__name__:
            raise RuntimeError(f"a {message['policy']} request reached a {type(policy).__name__} follower: "
                               f"the first rank serves another policy over this tp group")
        policy._run(message["batch"], message["step"])
        calls += 1


def stop_followers(policy) -> None:
    """On a tp group's first rank: release the ranks in ``serve_followers``."""
    policy = model_policy(policy)
    if policy._tp_group is not None:
        with policy._tp_lock:
            _broadcast(policy._tp_group, None)


class Policy(_ModelPolicy):
    """Flow-matching action-chunk policy. A VLM-only model (no action
    expert) is refused: serve it with ``ARPolicy``."""

    def __init__(self, model, *, num_steps: int = 10, **kw):
        if not model.config.enable_action_training:
            raise ValueError(
                "the flow Policy needs the action expert: this model was built with enable_action_training=False "
                "(VLM-only); serve it with ARPolicy (create_trained_policy_ar)"
            )
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


def _escape_record_key(k: str) -> str:
    """'/' is the flattener's path separator, but it is also a legal request
    key character (openpi-style flat keys like 'observation/state'); escape
    it so such keys round-trip as themselves instead of as nesting."""
    return k.replace("%", "%25").replace("/", "%2F")


def _unescape_record_key(k: str) -> str:
    return k.replace("%2F", "/").replace("%25", "%")


def _flatten_record(prefix: str, tree: dict, out: dict) -> None:
    """Flatten a (possibly nested) request/response dict into npz-storable
    ``prefix/key/...`` entries, nested observation dicts included, so a
    recorded request can be replayed byte-identically."""
    for k, v in tree.items():
        key = f"{prefix}/{_escape_record_key(str(k))}"
        if isinstance(v, dict):
            _flatten_record(key, v, out)
        elif isinstance(v, (np.ndarray, np.number, int, float, str, bool)):
            out[key] = np.asarray(v)


def unflatten_record(flat: dict, prefix: str) -> dict:
    """Inverse of the recorder's flattening for one ``prefix`` subtree."""
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = [_unescape_record_key(p) for p in key[len(prefix) + 1 :].split("/")]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


class PolicyRecorder(BasePolicy):
    """Record every request/response pair to ``record_dir/step_NNNNNN.npz``
    (openpi PolicyRecorder; ``lap_tpu/policies/policy.py:272``)."""

    def __init__(self, policy: BasePolicy, record_dir: str):
        super().__init__(metadata=policy.metadata)
        self._policy = policy
        self._record_dir = pathlib.Path(record_dir)
        self._record_dir.mkdir(parents=True, exist_ok=True)

    def infer(self, obs: dict) -> dict:
        result = self._policy.infer(obs)
        # Concurrent clients (threaded server / batched serving) must not
        # reuse a record slot: the slot is the request counter's.
        path = self._record_dir / f"step_{self._next_step() - 1:06d}.npz"
        flat = {}
        for prefix, tree in (("obs", obs), ("out", result)):
            _flatten_record(prefix, tree, flat)
        np.savez(path, **flat)
        return result
