"""The training step (port of ``lap_tpu/training/train_step.py``).

Forward and backward with rematerialised layers, the AdamW update, staged EMA
and gradient / parameter norms. Freezing is partitioned: a frozen parameter
gets ``requires_grad=False``, so it has no gradient buffer, no optimizer
moments and no EMA copy, and autograd prunes its backward work. The
validation step waits for the validation loop that calls it.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from lap_tpu_torch.training.optimizer import AdamW, global_norm
from lap_tpu_torch.training.state import TrainState


@dataclasses.dataclass(frozen=True)
class StepFunctions:
    train_step: Callable
    init_fn: Callable


def make_step_functions(
    model,
    optimizer: AdamW,
    lr_schedule: Callable[[int], float],
    *,
    ema_decay_for_step: Callable[[int], tuple[float, bool]] | None = None,
    freeze_filter: Callable[[str], bool] | None = None,
) -> StepFunctions:
    """Build ``init_fn() -> state`` and ``train_step(state, batch,
    **loss_kwargs) -> (state, metrics)`` over ``model`` (whose parameters are
    the state's params).

    ``ema_decay_for_step(step) -> (decay, enabled)`` switches EMA on (None:
    no EMA); the EMA copy keeps the parameter's dtype (the in-place update
    cannot promote it). ``freeze_filter(name) -> bool`` marks frozen
    parameters.
    ``loss_kwargs`` go to ``model.compute_loss`` (noise, time, aug_params,
    generator).
    """

    def init_fn() -> TrainState:
        trainable = []
        for name, p in model.named_parameters():
            frozen = freeze_filter is not None and bool(freeze_filter(name))
            p.requires_grad_(not frozen)
            p.grad = None
            if not frozen:
                trainable.append(name)
        params = dict(model.named_parameters())
        ema = None
        if ema_decay_for_step is not None:
            # Parameters update in place, so the initial EMA is a real copy.
            ema = {n: params[n].detach().clone() for n in trainable}
        return TrainState(
            step=0,
            model=model,
            trainable=trainable,
            opt_state=optimizer.init([params[n].detach() for n in trainable]),
            ema_params=ema,
        )

    def train_step(state: TrainState, batch, **loss_kwargs):
        observation, actions = batch
        named = dict(model.named_parameters())
        params = [named[n] for n in state.trainable]
        loss, metrics = model.compute_loss(observation, actions, train=True, **loss_kwargs)
        loss.backward()
        missing = [n for n, p in zip(state.trainable, params) if p.grad is None]
        if missing:
            raise RuntimeError(
                f"{len(missing)} trainable parameters took no gradient from the loss "
                f"(first: {missing[0]}); freeze what the loss does not reach"
            )
        with torch.no_grad():
            grads = [p.grad for p in params]
            grad_norm = global_norm(grads)
            optimizer.update_(params, grads, state.opt_state, lr_schedule, grad_norm=grad_norm)
            for p in params:
                p.grad = None
            if state.ema_params is not None:
                decay, enabled = ema_decay_for_step(state.step)
                ema = [state.ema_params[n] for n in state.trainable]
                if enabled:
                    torch._foreach_mul_(ema, decay)
                    torch._foreach_add_(ema, params, alpha=1 - decay)
                else:
                    torch._foreach_copy_(ema, params)
            metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
            metrics["loss"] = loss.detach()
            metrics["grad_norm"] = grad_norm
            metrics["param_norm"] = global_norm(p.detach() for p in named.values())
        state.step += 1
        return state, metrics

    return StepFunctions(train_step=train_step, init_fn=init_fn)
