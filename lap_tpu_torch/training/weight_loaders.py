"""Weight loaders: released or trained weights merged into a fresh model (port
of ``lap_tpu/training/weight_loaders.py``).

- ``flatten``/``unflatten`` (``weight_loaders.py:36-55``) and
  ``merge_params`` (``:58``) work in **JAX-path space**: the model's
  parameters are laid out as the JAX flat params tree
  (``convert.jax_params_template``: ``llm/layers/attn/q_einsum/w``,
  ``img/Transformer_encoderblock/...``, stacked layers), so that a
  ``missing_regex`` such as ``.*lora.*`` means what it means in JAX. The
  merge returns the loaded leaves and ``None`` for a leaf that keeps the
  model's init (JAX returns the ``ShapeDtypeStruct`` placeholder); the caller
  fills the model with ``convert.load_jax_params(model, merged,
  partial=True)``. JAX casts each loaded leaf to the target dtype inside the
  merge; here the copy into the parameter casts it, with the same rounding.
- ``recover_dtype`` (``:118``): numpy has no bfloat16 without ``ml_dtypes``,
  which the card's host lacks. A 2-byte void leaf stays void, and the bridge
  (``convert._to_tensor``) views it as ``torch.bfloat16``.
- ``CheckpointWeightLoader`` (``:104``) reads a ``params/`` directory of a
  trained checkpoint: the port's ``model.pt``, or ``params.npz`` exported
  from a JAX orbax checkpoint by ``scripts/export_jax_params.py`` (the port
  reads no orbax). Every non-LoRA leaf must be present.
- ``PaliGemmaWeightLoader`` (``:130``, with ``_remap`` ``:153``) reads a
  big_vision PaliGemma / PaliGemma2 ``.npz`` into expert 0 and SigLIP.
- ``WeightLoaderChoice`` (``:165``); kind ``gemma3`` builds
  ``gemma3_weights.Gemma3ScanCompatibleWeightLoader``. ``NoOpWeightLoader``
  is left out: no choice builds it.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from pathlib import Path
from typing import Literal, Protocol

import numpy as np
import torch

from lap_tpu_torch.models import convert

logger = logging.getLogger(__name__)

NPZ_FILE = "params.npz"  # a JAX params tree exported by scripts/export_jax_params.py
SIGLIP_QUERY = "img/Transformer_encoderblock/MultiHeadDotProductAttention_0/query/kernel"


class WeightLoader(Protocol):
    def load(self, params_shape: dict) -> dict:
        """Return the partial params tree to merge (``None``: keep the init)."""


def flatten(tree: dict, parent: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{parent}/{k}" if parent else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def merge_params(loaded: dict, params_shape: dict, *, missing_regex: str = ".*") -> dict:
    """Merge loaded leaves over the model's JAX-path template.

    A template path absent from ``loaded`` must fully match
    ``missing_regex`` and comes back ``None`` (it keeps its init); a shape
    that differs raises; leaves the model does not have are logged and
    dropped (``weight_loaders.py:58-101``).
    """
    flat_shape = flatten(params_shape)
    flat_loaded = flatten(loaded)
    pattern = re.compile(missing_regex)
    out = {}
    for key, ref in flat_shape.items():
        if key in flat_loaded:
            val = flat_loaded[key]
            if tuple(val.shape) != tuple(ref.shape):
                raise ValueError(f"shape mismatch for {key}: loaded {tuple(val.shape)} vs model {tuple(ref.shape)}")
            out[key] = val
        elif pattern.fullmatch(key):
            out[key] = None
        else:
            raise ValueError(f"param {key} missing from checkpoint and not matched by {missing_regex!r}")
    extra = set(flat_loaded) - set(flat_shape)
    if extra:
        logger.warning("checkpoint has %d params not in model (e.g. %s)", len(extra), sorted(extra)[:5])
    return unflatten(out)


def recover_dtype(a: np.ndarray) -> np.ndarray:
    """``np.save`` stores bfloat16 as a 2-byte void dtype. Such a leaf is
    kept as it is (the bridge views it as ``torch.bfloat16``); a void of
    another size raises, as in JAX."""
    if hasattr(a, "dtype") and a.dtype.type is np.void and a.itemsize != 2:
        raise ValueError(f"unknown void dtype with itemsize {a.itemsize}")
    return a


def read_params_dir(params_dir: str | Path, *, siglip_heads: int) -> dict:
    """A ``params/`` directory as the JAX flat params tree: ``params.npz``
    (exported from JAX) or the port's ``model.pt``."""
    params_dir = Path(params_dir)
    npz = params_dir / NPZ_FILE
    if npz.exists():
        return {k: recover_dtype(v) for k, v in convert.read_params_npz(npz).items()}
    from lap_tpu_torch.training.checkpoints import PARAMS_FILE

    path = params_dir / PARAMS_FILE
    if not path.exists():
        raise FileNotFoundError(
            f"{params_dir}: neither {PARAMS_FILE} (the port's params file) nor {NPZ_FILE}; export a JAX "
            f"orbax params/ directory with scripts/export_jax_params.py"
        )
    state = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    return to_numpy_tree(convert.to_jax_params(state, siglip_heads=siglip_heads))


def to_numpy_tree(flat: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Torch leaves -> numpy, bfloat16 as 2-byte void (the npz encoding)."""
    out = {}
    for k, v in flat.items():
        v = v.detach().cpu().contiguous()
        if v.dtype == torch.bfloat16:
            out[k] = v.view(torch.int16).numpy().view(np.dtype("V2"))
        else:
            out[k] = v.numpy()
    return out


@dataclasses.dataclass(frozen=True)
class CheckpointWeightLoader:
    """A full trained checkpoint's ``params/`` directory. Non-LoRA params
    must all be present; LoRA params may be fresh (``weight_loaders.py:104``)."""

    params_path: str

    def load(self, params_shape: dict) -> dict:
        heads = flatten(params_shape)[SIGLIP_QUERY].shape[-2]
        loaded = read_params_dir(self.params_path, siglip_heads=heads)
        return merge_params(loaded, params_shape, missing_regex=".*lora.*")


@dataclasses.dataclass(frozen=True)
class PaliGemmaWeightLoader:
    """big_vision PaliGemma / PaliGemma2 ``.npz`` weights into expert 0 and
    SigLIP; everything else keeps its init (``weight_loaders.py:130``).
    PaliGemma2 exports store bfloat16 as 2-byte void (``recover_dtype``)."""

    npz_path: str

    def load(self, params_shape: dict) -> dict:
        loaded = {self._remap(k): recover_dtype(v) for k, v in convert.read_params_npz(self.npz_path).items()}
        return merge_params(unflatten(loaded), params_shape, missing_regex=".*")

    @staticmethod
    def _remap(key: str) -> str:
        # big_vision nests the Transformer scope; the model's SigLIP keeps the
        # scan-stacked module names.
        key = key.replace("img/Transformer/encoderblock/", "img/Transformer_encoderblock/")
        return key.replace("img/Transformer/encoder_norm/", "img/Transformer_encoder_norm/")


@dataclasses.dataclass(frozen=True)
class WeightLoaderChoice:
    """CLI-friendly weight-loader selector (``weight_loaders.py:165``)."""

    kind: Literal["none", "checkpoint", "paligemma", "paligemma2", "gemma3"] = "none"
    params_path: str | None = None

    def build(self) -> WeightLoader | None:
        if self.kind == "none":
            return None
        if self.kind == "checkpoint":
            if not self.params_path:
                raise ValueError("checkpoint loader requires params_path")
            return CheckpointWeightLoader(self.params_path)
        if self.kind in ("paligemma", "paligemma2"):
            if not self.params_path:
                raise ValueError(f"{self.kind} loader requires params_path (.npz)")
            return PaliGemmaWeightLoader(self.params_path)
        if self.kind == "gemma3":
            from lap_tpu_torch.training.gemma3_weights import Gemma3ScanCompatibleWeightLoader

            if not self.params_path:
                raise ValueError("gemma3 loader requires params_path")
            return Gemma3ScanCompatibleWeightLoader(self.params_path)
        raise ValueError(f"unknown weight loader kind: {self.kind}")


def load_into(model, loader: WeightLoader) -> None:
    """Merge ``loader``'s weights into ``model``'s parameters in place."""
    merged = loader.load(convert.jax_params_template(model))
    convert.load_jax_params(model, merged, partial=True)
