"""Optimizer and LR / EMA schedules (port of ``lap_tpu/training/optimizer.py``).

The JAX package builds its update from optax: ``clip_by_global_norm`` ->
``scale_by_adam`` -> ``add_decayed_weights`` -> ``scale_by_learning_rate``.
This module writes the same arithmetic by hand over a list of parameters, in
place, since optax differs from ``torch.optim.AdamW`` in small ways:

- the clip factor is ``clip / max(norm, clip)`` (no ``+ 1e-6``);
- the schedule is read at the count *before* the step;
- the warm-up starts at ``peak / (warmup + 1)``;
- weight decay is ``lr * wd * p`` added to the Adam update (not folded into
  the gradient, not applied before the moments);
- the moments take the parameter's dtype.

The update runs through ``torch._foreach_*`` in place and reuses the gradient
buffers as scratch, so it allocates nothing the size of the parameters; it is
nine passes over parameter-sized state, which a fused kernel could make one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch


@dataclasses.dataclass(frozen=True)
class CosineDecaySchedule:
    warmup_steps: int = 1_000
    peak_lr: float = 2.5e-5
    decay_steps: int = 30_000
    decay_lr: float = 2.5e-6

    def __call__(self, step: int) -> float:
        """optax ``warmup_cosine_decay_schedule``: linear from
        ``peak / (warmup + 1)`` to ``peak`` over ``warmup_steps``, then cosine
        to ``decay_lr`` at ``decay_steps``."""
        init = self.peak_lr / (self.warmup_steps + 1)
        if step < self.warmup_steps:
            return init + (self.peak_lr - init) * step / self.warmup_steps
        span = self.decay_steps - self.warmup_steps
        progress = min(step - self.warmup_steps, span) / span
        cosine = 0.5 * (1.0 + math.cos(math.pi * progress))
        return self.decay_lr + (self.peak_lr - self.decay_lr) * cosine


@dataclasses.dataclass(frozen=True)
class RsqrtDecaySchedule:
    warmup_steps: int = 1_000
    peak_lr: float = 5e-5
    timescale: float = 10_000

    def __call__(self, step: int) -> float:
        if step < self.warmup_steps:
            return self.peak_lr * (step + 1) / (self.warmup_steps + 1)
        return self.peak_lr * math.sqrt(
            (self.warmup_steps + self.timescale) / (max(step, self.warmup_steps) + self.timescale)
        )


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over a list of tensors, as a float32 scalar.

    On the card one fused launch takes the per-tensor norms. PyTorch's CPU
    reduction accumulates float32 in long serial runs and loses three digits
    on a tensor of millions of elements (the embedding table), so on the CPU
    the squares are summed in float64.
    """
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    if tensors[0].is_cuda:
        norms = torch.stack([n.to(torch.float32) for n in torch._foreach_norm(tensors)])
    else:
        norms = torch.stack([torch.linalg.vector_norm(t, dtype=torch.float64) for t in tensors])
    return torch.linalg.vector_norm(norms).to(torch.float32)


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 1e-10
    clip_gradient_norm: float = 1.0

    def init(self, params: list[torch.Tensor]) -> AdamWState:
        return AdamWState(
            count=0, mu=[torch.zeros_like(p) for p in params], nu=[torch.zeros_like(p) for p in params]
        )

    @torch.no_grad()
    def update_(self, params, grads, state: AdamWState, lr_schedule, grad_norm=None) -> None:
        """One step in place on ``params``, ``state`` and (as scratch) ``grads``."""
        params, grads = list(params), list(grads)
        if grad_norm is None:
            grad_norm = global_norm(grads)
        clip = self.clip_gradient_norm
        factor = clip / torch.clamp(grad_norm, min=clip)
        torch._foreach_mul_(grads, factor.to(grads[0].dtype))
        lr = lr_schedule(state.count)
        state.count += 1
        torch._foreach_lerp_(state.mu, grads, 1 - self.b1)
        torch._foreach_mul_(state.nu, self.b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1 - self.b2)
        # With c1 = 1 - b1^t and c2 = 1 - b2^t the Adam update
        # (mu / c1) / (sqrt(nu / c2) + eps) equals
        # (sqrt(c2) / c1) * mu / (sqrt(nu) + eps * sqrt(c2)): the bias
        # corrections fold into two scalars and save a pass over the state.
        c1, c2 = 1 - self.b1**state.count, 1 - self.b2**state.count
        torch._foreach_copy_(grads, state.nu)
        torch._foreach_sqrt_(grads)
        torch._foreach_add_(grads, self.eps * math.sqrt(c2))
        # p <- p - lr * (update + wd * p)
        torch._foreach_mul_(params, 1 - lr * self.weight_decay)
        torch._foreach_addcdiv_(params, state.mu, grads, value=-lr * math.sqrt(c2) / c1)


# ---------------------------------------------------------------------------
# EMA schedules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EmaStage:
    start_step: int
    end_step: int | None = None
    decay: float | None = None  # None disables EMA updates in this range

    def validate(self):
        if self.start_step < 0:
            raise ValueError("start_step must be >= 0")
        if self.end_step is not None and self.end_step <= self.start_step:
            raise ValueError("end_step must be > start_step")
        if self.decay is not None and not 0.0 < self.decay < 1.0:
            raise ValueError("decay must be in (0, 1)")


@dataclasses.dataclass(frozen=True)
class EmaSchedule:
    stages: tuple[EmaStage, ...]

    def __post_init__(self):
        if not self.stages:
            raise ValueError("EmaSchedule needs at least one stage")
        for s in self.stages:
            s.validate()
        for cur, nxt in zip(self.stages, self.stages[1:]):
            if cur.end_step is None:
                raise ValueError("only the last stage may have end_step=None")
            if nxt.start_step < cur.end_step:
                raise ValueError("EMA stages overlap")

    def get_decay_for_step(self, step: int) -> tuple[float, bool]:
        """(decay, enabled) at ``step``; a later stage wins, as in JAX."""
        decay, enabled = 0.0, False
        for stage in self.stages:
            if step >= stage.start_step and (stage.end_step is None or step < stage.end_step):
                decay = 0.0 if stage.decay is None else stage.decay
                enabled = stage.decay is not None
        return decay, enabled

    def has_ema(self) -> bool:
        return any(s.decay is not None for s in self.stages)

    def default_decay(self) -> float | None:
        for s in self.stages:
            if s.decay is not None:
                return s.decay
        return None


@dataclasses.dataclass(frozen=True)
class EmaScheduleChoice:
    """disabled / constant / delayed / cosine_delayed."""

    kind: Literal["disabled", "constant", "delayed", "cosine_delayed"] = "delayed"
    start_step: int = 10_000

    def build(self, *, decay: float | None) -> EmaSchedule | None:
        if self.kind == "disabled" or decay is None:
            return None
        if self.kind == "constant" or (self.kind == "delayed" and self.start_step <= 0):
            return EmaSchedule(stages=(EmaStage(0, None, decay),))
        if self.kind == "delayed":
            return EmaSchedule(
                stages=(EmaStage(0, self.start_step, None), EmaStage(self.start_step, None, decay))
            )
        if self.kind == "cosine_delayed":
            # The cosine ramp is computed by TrainConfig.get_ema_decay_for_step.
            return None
        raise ValueError(f"Unsupported EMA schedule kind: {self.kind}")
