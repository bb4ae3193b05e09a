"""Checkpoint files of the port (port of the serving half of
``lap_tpu/training/checkpoints.py``).

- Norm stats: ``load_norm_stats``/``save_norm_stats`` read and write the JAX
  package's ``assets/<asset_id>/norm_stats.json`` layout
  (``lap_tpu/training/checkpoints.py:353``, ``lap_tpu/data/norm_stats.py:199``),
  so one assets directory serves both packages.
- Serving params: ``save_params(model, params_dir)`` writes
  ``params_dir/model.pt``, a ``torch.save`` of the model's parameters (the
  quantized copies are not saved: ``quantize_`` rebuilds them after a
  restore). ``restore_params(params_dir, model)`` loads it with
  ``weights_only=True, mmap=True`` and copies tensor by tensor into a model
  built with ``init_seed=None``: no weights are initialised first, and the
  host holds no second full copy (pages of the file are read as each tensor
  goes to its device). Values are cast to each parameter's dtype, so an f32
  file restores into a bf16 model.

ROADMAP item 12 extends this module with the train state (Adam moments, EMA,
step, data-loader state), resume, and a reader of the JAX package's orbax
``params/`` directory; it does not replace it.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
from torch import nn

PARAMS_FILE = "model.pt"


def save_norm_stats(path: str | Path, stats: dict, *, extra: dict | None = None) -> None:
    """Write ``{key: NormStats}`` as ``{"norm_stats": {...}}`` JSON."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"norm_stats": {k: v.to_dict() for k, v in stats.items()}}
    payload.update(extra or {})
    path.write_text(json.dumps(payload))


def load_norm_stats(assets_dir: str | Path, asset_id: str) -> dict | None:
    """Read ``{assets_dir}/{asset_id}/norm_stats.json`` into NormStats, or
    None when the file is absent."""
    from lap_tpu_torch.policies.model_transforms import NormStats

    path = Path(assets_dir) / asset_id / "norm_stats.json"
    if not path.exists():
        return None
    raw = json.loads(path.read_text())
    stats = raw.get("norm_stats", raw)
    return {k: NormStats.from_dict(v) for k, v in stats.items()}


def save_params(model: nn.Module, params_dir: str | Path) -> Path:
    """Write the parameters of ``model`` to ``params_dir/model.pt`` (host
    copies, in the parameters' dtype). Returns the file's path."""
    params_dir = Path(params_dir)
    params_dir.mkdir(parents=True, exist_ok=True)
    path = params_dir / PARAMS_FILE
    state = {name: p.detach().to("cpu") for name, p in model.named_parameters()}
    torch.save(state, path)
    return path


@torch.no_grad()
def restore_params(params_dir: str | Path, model: nn.Module) -> nn.Module:
    """Fill every parameter of ``model`` from ``params_dir/model.pt``.

    Raises if the file is missing, a parameter is left unfilled, an entry is
    left over, or a shape differs.
    """
    path = Path(params_dir) / PARAMS_FILE
    if not path.exists():
        raise FileNotFoundError(
            f"{path}: no port params file (a JAX orbax params/ directory is read by ROADMAP item 12, "
            "not yet ported)"
        )
    state = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError(f"params file mismatch: unfilled {missing}, unexpected {extra}")
    for name, param in own.items():
        value = state[name]
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(param.shape)}")
        param.copy_(value.to(dtype=param.dtype))
    return model
