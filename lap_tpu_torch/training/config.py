"""Training configs (port of the fields of ``lap_tpu/training/config.py``
that the ported training path reads): the model, the schedule, the optimizer,
the per-device batch, ``param_dtype``, the EMA choice, ``freeze_vlm`` and the
seed. Data, checkpoints, meshes and logging back ends are not ported yet.
"""

from __future__ import annotations

import dataclasses
import difflib
import math

from lap_tpu_torch.models.lap_model import LAPConfig
from lap_tpu_torch.training import optimizer as _optimizer


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    name: str = "lap"

    model: LAPConfig = dataclasses.field(default_factory=LAPConfig)
    lr_schedule: _optimizer.CosineDecaySchedule = dataclasses.field(
        default_factory=lambda: _optimizer.CosineDecaySchedule(
            warmup_steps=5_000, peak_lr=1e-4, decay_steps=40_000, decay_lr=1e-5
        )
    )
    optimizer: _optimizer.AdamW = dataclasses.field(
        default_factory=lambda: _optimizer.AdamW(weight_decay=0.0001)
    )

    # The global batch of the published recipe; the trainer takes a per-device
    # batch as an argument.
    batch_size: int = 2048
    num_train_steps: int = 40_000
    log_interval: int = 50
    seed: int = 0

    ema_decay: float | None = 0.999
    ema_schedule_choice: _optimizer.EmaScheduleChoice = dataclasses.field(
        default_factory=lambda: _optimizer.EmaScheduleChoice(kind="cosine_delayed", start_step=5000)
    )

    param_dtype: str = "float32"
    freeze_vlm: bool = False

    def get_ema_decay_for_step(self, step: int) -> tuple[float, bool]:
        """(decay, enabled) at ``step``, including the cosine-delayed ramp."""
        if self.ema_schedule_choice.kind == "cosine_delayed":
            if self.ema_decay is None:
                return 0.0, False
            start = self.ema_schedule_choice.start_step
            duration = max(self.num_train_steps - start, 1)
            progress = min(max((step - start) / duration, 0.0), 1.0)
            decay = self.ema_decay * (1.0 - math.cos(math.pi * progress)) / 2.0
            return decay, step >= start
        schedule = self.ema_schedule_choice.build(decay=self.ema_decay)
        if schedule is not None:
            return schedule.get_decay_for_step(step)
        if self.ema_decay is None:
            return 0.0, False
        return self.ema_decay, True

    @property
    def has_ema(self) -> bool:
        return self.ema_decay is not None and self.ema_schedule_choice.kind != "disabled"


_CONFIGS = [
    TrainConfig(
        name="lap",
        model=LAPConfig(
            action_dim=7,
            action_horizon=16,
            max_token_len=180,
            enable_action_training=True,
            stop_action_to_vlm_grad=True,
        ),
        batch_size=2048,
    ),
    # Debug config: tiny model + synthetic data, runs anywhere.
    TrainConfig(
        name="debug",
        model=LAPConfig(
            dtype="float32",
            paligemma_variant="dummy",
            action_expert_variant="dummy",
            siglip_variant="dummy",
            action_dim=7,
            action_horizon=4,
            max_token_len=160,
            image_resolution=(56, 56),
            enable_action_training=True,
            enable_langact_training=True,
        ),
        lr_schedule=_optimizer.CosineDecaySchedule(
            warmup_steps=10, peak_lr=1e-3, decay_steps=100, decay_lr=1e-4
        ),
        batch_size=8,
        num_train_steps=20,
        log_interval=5,
        ema_decay=None,
    ),
]

_CONFIGS_DICT = {c.name: c for c in _CONFIGS}


def get_config(config_name: str) -> TrainConfig:
    if config_name in _CONFIGS_DICT:
        return _CONFIGS_DICT[config_name]
    closest = difflib.get_close_matches(config_name, _CONFIGS_DICT.keys(), n=3, cutoff=0.0)
    hint = f" Did you mean one of: {', '.join(map(repr, closest))}?" if closest else ""
    raise ValueError(f"Config {config_name!r} not found.{hint}")
