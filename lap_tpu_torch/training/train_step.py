"""The training step (port of ``lap_tpu/training/train_step.py``).

Forward and backward with rematerialised layers, the AdamW update, staged EMA
and gradient / parameter norms (or SGD with momentum). Freezing is
partitioned: a frozen parameter gets ``requires_grad=False``, so it has no
gradient buffer, no optimizer state and no EMA copy, and autograd prunes its
backward work. A trainable parameter the loss does not reach gets a zero
gradient, as in JAX.

Randomness: JAX derives a step's noise, flow time and augmentation from
``fold_in(rng, state.step)`` (``train_step.py:103``), a function of the seed
and the step alone. Here each step draws them from a fresh
``torch.Generator`` seeded with ``step_seed(seed, state.step)``: the first
64-bit word of ``np.random.SeedSequence([seed, step])``, its top bit cleared
(the mix ``Policy`` uses for its requests). So a run resumed at step k takes
the steps an uninterrupted run takes from k. Randomness passed in
(``noise``, ``time``, ``aug_params``, ``generator``) wins, as in the parity
tests.

``val_step`` (``train_step.py:152-158``) computes the loss on
``inference_params(state)`` (the EMA view) with ``train=False`` under
``torch.no_grad()``: the EMA tensors stand in for the live parameters'
storage during the call and are swapped back after, so the live parameters
are never written. Its randomness is the generator seeded with ``seed`` on
every call, as JAX passes the same ``rng`` to every validation step.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from lap_tpu_torch.training.optimizer import AdamW, SGDConfig, global_norm
from lap_tpu_torch.training.state import TrainState, inference_params

RANDOMNESS_KWARGS = ("noise", "time", "aug_params", "generator")


def step_seed(seed: int, step: int) -> int:
    """The 63-bit generator seed of step ``step`` of a run seeded ``seed``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(2, np.uint64)[0] >> np.uint64(1))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(step_seed(seed, step))


@contextlib.contextmanager
def swapped_params(model, params: dict[str, torch.Tensor]):
    """Run with ``params`` as the storage of ``model``'s parameters of those
    names, and put the live storage back after."""
    own = dict(model.named_parameters())
    live = {}
    try:
        for name, value in params.items():
            if value is not own[name]:
                live[name] = own[name].data
                own[name].data = value
        yield
    finally:
        for name, data in live.items():
            own[name].data = data


@dataclasses.dataclass(frozen=True)
class StepFunctions:
    train_step: Callable
    val_step: Callable
    init_fn: Callable


def make_step_functions(
    model,
    optimizer: AdamW | SGDConfig,
    lr_schedule: Callable[[int], float],
    *,
    ema_decay_for_step: Callable[[int], tuple[float, bool]] | None = None,
    freeze_filter: Callable[[str], bool] | None = None,
    seed: int = 0,
) -> StepFunctions:
    """Build ``init_fn() -> state``, ``train_step(state, batch,
    **loss_kwargs) -> (state, metrics)`` and ``val_step(state, batch,
    **loss_kwargs) -> metrics`` over ``model`` (whose parameters are the
    state's params).

    ``ema_decay_for_step(step) -> (decay, enabled)`` switches EMA on (None:
    no EMA); the EMA copy keeps the parameter's dtype (the in-place update
    cannot promote it). ``freeze_filter(name) -> bool`` marks frozen
    parameters. ``seed`` seeds each step's randomness with the step.
    ``loss_kwargs`` go to ``model.compute_loss`` (noise, time, aug_params,
    generator).
    """

    def with_randomness(loss_kwargs: dict, generator_seed: int) -> dict:
        if any(k in loss_kwargs for k in RANDOMNESS_KWARGS):
            return loss_kwargs
        return {**loss_kwargs, "generator": torch.Generator(device=model.device).manual_seed(generator_seed)}

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
        loss_kwargs = with_randomness(loss_kwargs, step_seed(seed, state.step))
        loss, metrics = model.compute_loss(observation, actions, train=True, **loss_kwargs)
        loss.backward()
        with torch.no_grad():
            # A trainable parameter the loss does not reach takes a zero
            # gradient, as JAX's value_and_grad gives it: its moments decay,
            # weight decay and EMA still apply (pi0_replicated trains without
            # the language loss, so expert 0's last layer is never reached).
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
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

    @torch.no_grad()
    def val_step(state: TrainState, batch, **loss_kwargs):
        observation, actions = batch
        with swapped_params(model, inference_params(state)):
            loss, metrics = model.compute_loss(
                observation, actions, train=False, **with_randomness(loss_kwargs, seed)
            )
        metrics = dict(metrics)
        metrics["loss"] = loss
        return metrics

    return StepFunctions(train_step=train_step, val_step=val_step, init_fn=init_fn)
