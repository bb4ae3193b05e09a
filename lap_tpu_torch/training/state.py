"""Train state container (port of ``lap_tpu/training/state.py``)."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from lap_tpu_torch.training.optimizer import AdamWState


@dataclasses.dataclass
class TrainState:
    """The model's parameters are the state's params: they update in place.

    ``trainable`` names the parameters that take gradients; ``opt_state`` and
    ``ema_params`` are laid out over that subset only (partitioned freezing).
    """

    step: int
    model: nn.Module
    trainable: list[str]
    opt_state: AdamWState
    ema_params: dict[str, torch.Tensor] | None = None  # None when EMA is disabled

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def inference_params(state: TrainState) -> dict[str, torch.Tensor]:
    """The EMA view served and saved for inference.

    Under partitioned freezing the EMA holds only the trainable parameters
    (the EMA of a parameter that never changes is the parameter itself); the
    gaps are filled from the model here. With EMA disabled these are the
    parameters.
    """
    params = state.params
    if state.ema_params is None:
        return params
    return {name: state.ema_params.get(name, p) for name, p in params.items()}
