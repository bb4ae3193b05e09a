"""Offline checkpoint evaluation (port of ``scripts/eval.py``).

    python -m lap_tpu_torch.training.eval <config> --exp_name X [--field value ...] [--device cpu]

For each selected step of ``{checkpoint_base_dir}/{name}/{exp_name}`` it
restores the evaluation weights (``restore_eval_params``, ``eval.py:76-90``:
the EMA view from ``params/`` when ``eval_use_ema`` or the run had no EMA,
the raw parameters from ``train_state/`` otherwise) and, over
``num_eval_batches`` batches of the ``eval_split`` loader, computes
``val_loss`` (the loss with ``train=False``, and its metrics) and, when the
model trains actions, ``action_prediction_l2`` (``sample_actions`` with 10
steps, the L2 norm over the action dimension, averaged; ``:49-64``). Each
metric is averaged over the batches (``reduce_metrics`` per batch, as JAX).
Batch ``i`` draws its noise and flow time from ``step_generator(seed, i)``
(JAX splits one key per batch). Steps: ``eval_checkpoint_step``, else
``eval_checkpoint_steps``, else all (``eval_all_checkpoints``) or the
latest, from ``eval_start_from_step`` on. With a ``data_mix`` the run's data
is evaluated again as ``eval_demo_dataset`` at ``val_fraction=1.0``, as JAX
does (for the ``fake`` repo it is the same data).

Runs on the card unless ``--device cpu`` is given; one process; metrics go to
``logging`` (wandb is ROADMAP item 21).
"""

from __future__ import annotations

import dataclasses
import logging
import sys
from pathlib import Path

import numpy as np
import torch

from lap_tpu_torch.device import resolve_device
from lap_tpu_torch.models.lap_model import LAP
from lap_tpu_torch.training import checkpoints as _checkpoints
from lap_tpu_torch.training.config import TrainConfig, cli
from lap_tpu_torch.training.train import reduce_metrics, split_device
from lap_tpu_torch.training.train_step import step_generator

logger = logging.getLogger("lap_tpu_torch.eval")

NUM_SAMPLE_STEPS = 10


@torch.no_grad()
def val_loss(model: LAP, batch, **loss_kwargs) -> dict:
    obs, actions = batch
    loss, metrics = model.compute_loss(obs, actions, train=False, **loss_kwargs)
    return {"val_loss": loss, **metrics}


@torch.no_grad()
def action_prediction_l2(model: LAP, batch, *, noise=None, generator=None) -> dict:
    obs, actions = batch
    sampled = model.sample_actions(obs, num_steps=NUM_SAMPLE_STEPS, noise=noise, generator=generator)
    l2 = torch.sqrt(torch.sum((sampled - actions.to(sampled.dtype)) ** 2, dim=-1)).mean()
    return {"action_prediction_l2": l2}


@torch.no_grad()
def restore_eval_params(config: TrainConfig, ckpt_mgr: _checkpoints.CheckpointManager, step: int, model: LAP) -> None:
    """Fill ``model`` with the weights ``eval_use_ema`` selects at ``step``."""
    step_dir = ckpt_mgr.step_dir(step)
    if config.eval_use_ema or not config.has_ema:
        # params/ holds the EMA view when the run had EMA, else the parameters.
        _checkpoints.restore_params(step_dir / "params", model)
        return
    path = step_dir / "train_state" / _checkpoints.TRAIN_STATE_FILE
    if not path.exists():
        raise FileNotFoundError(f"{path}: no port train state (eval_use_ema=False reads the raw parameters)")
    saved = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    _checkpoints.copy_tensors(dict(model.named_parameters()), saved["params"], "train state params")


def evaluate_checkpoint(config: TrainConfig, model: LAP, ckpt_mgr, step: int, loader, *,
                        num_batches: int | None) -> dict:
    """The batch-averaged eval metrics of ``step`` on ``loader``."""
    restore_eval_params(config, ckpt_mgr, step, model)
    all_metrics: list[dict] = []
    it = iter(loader)
    try:
        for i in range(num_batches or sys.maxsize):
            try:
                batch = next(it)
            except StopIteration:
                break
            m = val_loss(model, batch, generator=step_generator(config.seed, i, model.device))
            if config.model.enable_action_training:
                m.update(action_prediction_l2(model, batch, generator=step_generator(config.seed, i, model.device)))
            all_metrics.append(reduce_metrics(m))
    finally:
        it.close()
    if not all_metrics:
        return {}
    return {k: float(np.mean([m[k] for m in all_metrics if k in m])) for k in all_metrics[0]}


def select_steps(config: TrainConfig, available: list[int]) -> list[int]:
    """The steps ``eval_*`` select (``scripts/eval.py`` main)."""
    steps = list(available)
    if config.eval_checkpoint_step is not None:
        steps = [config.eval_checkpoint_step]
    elif config.eval_checkpoint_steps:
        steps = list(config.eval_checkpoint_steps)
    elif not config.eval_all_checkpoints and steps:
        steps = [steps[-1]]
    if config.eval_start_from_step is not None:
        steps = [s for s in steps if s >= config.eval_start_from_step]
    return steps


def run(config: TrainConfig, *, device=None) -> dict[int, dict[str, dict]]:
    """Evaluate the selected checkpoints; returns {step: {dataset: metrics}}."""
    from lap_tpu_torch.data.loader import create_data_loader

    device = resolve_device(device)
    if not Path(config.checkpoint_dir).is_dir():
        raise FileNotFoundError(f"no checkpoints found under {config.checkpoint_dir}")
    ckpt_mgr = _checkpoints.CheckpointManager(config.checkpoint_dir, keep_period=config.keep_period)
    steps = select_steps(config, ckpt_mgr.all_steps())
    if not steps:
        raise FileNotFoundError(f"no checkpoints found under {config.checkpoint_dir}")

    dataset_configs = [("original", config)]
    if config.data.data_mix is not None:
        demo = dataclasses.replace(config.data, data_mix="eval_demo_dataset", val_fraction=1.0)
        dataset_configs.append(("eval_demo_dataset", dataclasses.replace(config, data=demo)))
    # Only the fake repo is ported (ROADMAP item 19), so the optional mixture
    # JAX skips with a warning when it is absent cannot be absent here.
    loaders = {name: create_data_loader(ds_cfg, device=device, split=ds_cfg.eval_split)
               for name, ds_cfg in dataset_configs}

    model = config.model.create_module(device=device, init_seed=None, param_dtype=getattr(torch, config.param_dtype))
    results: dict[int, dict[str, dict]] = {}
    for step in steps:
        for name, loader in loaders.items():
            scalars = evaluate_checkpoint(config, model, ckpt_mgr, step, loader, num_batches=config.num_eval_batches)
            results.setdefault(step, {})[name] = scalars
            logger.info("checkpoint %d [%s]: %s", step, name,
                        " ".join(f"{name}/{k}={v:.9g}" for k, v in sorted(scalars.items())))
    return results


def main(argv: list[str] | None = None) -> dict:
    device, rest = split_device(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
                        datefmt="%H:%M:%S")
    return run(cli(rest), device=device)


if __name__ == "__main__":
    main()
