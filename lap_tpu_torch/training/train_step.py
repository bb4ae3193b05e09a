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

A model parallelized by ``parallel.sharding.parallelize_`` (``model.parallel``)
runs each step under its mesh: the optimizer, the clip and the EMA work
elementwise on each rank's shards (a DTensor's local tensor under FSDP);
``global_norm`` sums each rank's squares, counting a shard that tp or dp
replicates on its first rank alone, and all-reduces the sum; the loss of
each data rank is its share of the global batch's (its gradients sum over
the data ranks, ``LAP.compute_loss``), and the metrics are averaged over
them, the loss summed. The step's randomness is drawn for the global batch
(``LAP.loss_randomness``, the data ranks' batches together) from the step's
generator, and each data rank takes its rows (``parallel.mesh.data_sharding``),
so a sharded step takes the values of one process's step.

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
import torch.distributed as dist

from lap_tpu_torch.parallel import mesh as mesh_lib
from lap_tpu_torch.parallel.sharding import counted_once, is_dtensor, local
from lap_tpu_torch.training.optimizer import AdamW, SGDConfig, global_norm, sum_of_squares
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
    names, and put the live storage back after. A DTensor parameter (FSDP)
    takes the values by copy into its shard, and its own back after."""
    own = dict(model.named_parameters())
    live, copied = {}, {}
    try:
        for name, value in params.items():
            p = own[name]
            if value is p:
                continue
            if is_dtensor(p):
                shard = local(p)
                copied[name] = shard.detach().clone()
                shard.detach().copy_(value)
            else:
                live[name] = p.data
                p.data = value
        yield
    finally:
        for name, data in live.items():
            own[name].data = data
        for name, data in copied.items():
            local(own[name]).detach().copy_(data)


def _take_rows(draws: dict, rows: slice) -> dict:
    from lap_tpu_torch.models.preprocessing import AugmentParams

    out = {k: v[rows] for k, v in draws.items() if k != "aug_params"}
    if "aug_params" in draws:
        out["aug_params"] = {
            key: AugmentParams(**{f.name: getattr(p, f.name)[rows] for f in dataclasses.fields(p)})
            for key, p in draws["aug_params"].items()
        }
    return out


def parallel_norm(model, named: dict[str, torch.Tensor]) -> torch.Tensor:
    """``global_norm`` of a sharded model's tensors (one per parameter
    name): each rank's squares of the shards it counts
    (``sharding.counted_once``), summed over every rank."""
    kept = [local(t) for name, t in named.items() if counted_once(model, name)]
    total = sum_of_squares(kept, model.device)
    dist.all_reduce(total)
    return total.sqrt().to(torch.float32)


def _reduce_metrics(model, metrics: dict) -> dict:
    """Float scalars averaged over the data ranks; the loss (each rank's
    share) summed."""
    index, count = model.parallel.data_placement
    if count == 1:
        return metrics
    group = mesh_lib.data_group(model.parallel.mesh)
    out = dict(metrics)
    for key in sorted(metrics):
        v = metrics[key]
        if isinstance(v, torch.Tensor) and v.numel() == 1 and v.is_floating_point():
            total = v.detach().to(torch.float64).reshape(())
            dist.all_reduce(total, group=group)
            out[key] = (total if key == "loss" else total / count).to(v.dtype)
    return out


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

    def with_randomness(loss_kwargs: dict, generator_seed: int, actions, *, train: bool) -> dict:
        if any(k in loss_kwargs for k in RANDOMNESS_KWARGS):
            return loss_kwargs
        generator = torch.Generator(device=model.device).manual_seed(generator_seed)
        par = getattr(model, "parallel", None)
        if par is None or par.data_placement[1] == 1:
            return {**loss_kwargs, "generator": generator}
        _, count = par.data_placement
        rows = actions.shape[0]
        draws = model.loss_randomness(rows * count, generator, train=train)
        return {**loss_kwargs, **_take_rows(draws, mesh_lib.data_sharding(par.mesh, rows * count))}

    def scope():
        par = getattr(model, "parallel", None)
        return contextlib.nullcontext() if par is None else par.scope()

    def norm(named: dict) -> torch.Tensor:
        if getattr(model, "parallel", None) is None:
            return global_norm(named.values())
        return parallel_norm(model, named)

    def init_fn() -> TrainState:
        trainable = []
        for name, p in model.named_parameters():
            frozen = freeze_filter is not None and bool(freeze_filter(name))
            p.requires_grad_(not frozen)
            p.grad = None
            if not frozen:
                trainable.append(name)
        params = {n: local(p).detach() for n, p in model.named_parameters()}
        ema = None
        if ema_decay_for_step is not None:
            # Parameters update in place, so the initial EMA is a real copy.
            ema = {n: params[n].clone() for n in trainable}
        return TrainState(
            step=0,
            model=model,
            trainable=trainable,
            opt_state=optimizer.init([params[n] for n in trainable]),
            ema_params=ema,
        )

    def train_step(state: TrainState, batch, **loss_kwargs):
        observation, actions = batch
        named = dict(model.named_parameters())
        with scope():
            loss_kwargs = with_randomness(loss_kwargs, step_seed(seed, state.step), actions, train=True)
            loss, metrics = model.compute_loss(observation, actions, train=True, **loss_kwargs)
            loss.backward()
        with torch.no_grad():
            # A trainable parameter the loss does not reach takes a zero
            # gradient, as JAX's value_and_grad gives it: its moments decay,
            # weight decay and EMA still apply (pi0_replicated trains without
            # the language loss, so expert 0's last layer is never reached).
            grads = {n: torch.zeros_like(local(named[n])) if named[n].grad is None else local(named[n].grad)
                     for n in state.trainable}
            grad_norm = norm(grads)
            params = [local(named[n]) for n in state.trainable]
            optimizer.update_(params, list(grads.values()), state.opt_state, lr_schedule, grad_norm=grad_norm)
            for n in state.trainable:
                named[n].grad = None
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
            if getattr(model, "parallel", None) is not None:
                metrics = _reduce_metrics(model, metrics)
            metrics["grad_norm"] = grad_norm
            metrics["param_norm"] = norm({n: p.detach() for n, p in named.items()})
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def val_step(state: TrainState, batch, **loss_kwargs):
        observation, actions = batch
        with swapped_params(model, inference_params(state)), scope():
            loss, metrics = model.compute_loss(
                observation, actions, train=False,
                **with_randomness(loss_kwargs, seed, actions, train=False),
            )
            par = getattr(model, "parallel", None)
            if par is not None and par.fsdp:
                # FSDP keeps the root's parameters gathered after a forward
                # with no backward to follow: shard them before the live
                # values go back.
                model.reshard()
        metrics = dict(metrics)
        metrics["loss"] = loss
        if getattr(model, "parallel", None) is not None:
            metrics = _reduce_metrics(model, metrics)
        return metrics

    return StepFunctions(train_step=train_step, val_step=val_step, init_fn=init_fn)
