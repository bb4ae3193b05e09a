"""Training entry point (port of ``scripts/train.py:165-352``).

    python -m lap_tpu_torch.training.train <config> --exp_name X [--field value ...] [--device cpu]
    python -m lap_tpu_torch.training.train debug --device cpu   # tiny model, fake data
    python -m torch.distributed.run --nproc_per_node N -m lap_tpu_torch.training.train <config> \
        --exp_name X --fsdp_devices N                          # N ranks, one a card

Under ``torchrun`` each process joins the process group (NCCL on CUDA, gloo
with ``--device cpu``), builds the (dp, fsdp,
tp) mesh from ``--fsdp_devices`` (``pick_fsdp_devices``) and
``--tp_devices``, and shards the model before the first step
(``parallel.sharding.parallelize_``; ``--sequence_parallel true`` under tp).
A fresh run builds and initialises the whole model on each rank, merges the
pretrained weights, then shards it; a resumed run builds it empty on the
``meta`` device, shards it and restores each rank's slices. Each data rank
loads its share of the global ``batch_size``; rank 0 logs and writes the
checkpoints (the other ranks log warnings only), with every data rank's
loader cursor (``dataloader_process_{i}``, gathered by
``array_utils.gather_host_json``). A SIGTERM on any rank stops every rank
after the same step.

``<config>`` is a named config and ``--a.b value`` overrides any field
(``config.cli``). The loop, as JAX's:

- ``initialize_checkpoint_dir`` on ``{checkpoint_base_dir}/{name}/{exp_name}``
  (overwrite wipes it, resume resumes from its latest step);
- the trainer from the config's seed; unless resuming, the weight loader's
  weights merged in before the optimizer state and the EMA are made from
  them (``:134-145``); when resuming, the model is built empty and the state and
  the loader's cursor are restored from the latest step (``:232-244``);
- the optimizer of the config, ``AdamW`` or ``SGDConfig`` (``--optimizer
  SGDConfig`` picks it on the command line, ``--optimizer.momentum`` etc.
  set its fields); the freeze filter of the model (LoRA variants train
  their adapters alone) or ``freeze_vlm``;
- batches from ``data.loader.create_data_loader``; a log line at the first
  step and every ``log_interval``; ``val_step`` on the validation loader
  every ``val_interval`` (``use_validation``), its iterator restarted at its
  end; a checkpoint every ``save_interval`` and at the last step;
- SIGTERM: the step in flight finishes, a checkpoint is saved, and the run
  logs ``exiting after preemption checkpoint at step N`` and ends with exit
  code 0; otherwise it logs ``training complete at step N``.

It runs on the card unless ``--device cpu`` is given. Metrics go to
``logging`` (wandb and the metrics logger are ROADMAP item 21); no profiler
trace or batch visualisation; no pipeline parallelism (item 13b).
``Trainer``, ``build_trainer`` and ``fake_train_batch``
(optimizer steps on one synthetic batch: prompt tokens ``arange``, a
language-action span from token 8, random uint8 images, seeded actions) stay
for ``chip_smoke.py``'s timed steps.

Checkpoints are saved asynchronously (``CheckpointManager.async_save``, as
JAX's): the loop waits only for the copy to host memory; the run waits for
the write before it exits (also after a SIGTERM), and a restore waits for
any write in flight. Each finished save is logged once, with its bytes, the
seconds of its write and the seconds it blocked the loop.
"""

from __future__ import annotations

import dataclasses
import logging
import signal
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from lap_tpu_torch.device import process_placement, resolve_device
from lap_tpu_torch.models.lap_model import LAP, LAPConfig, get_freeze_filter, get_vlm_freeze_filter
from lap_tpu_torch.parallel import mesh as _mesh
from lap_tpu_torch.parallel.sharding import parallelize_
from lap_tpu_torch.training import checkpoints as _checkpoints
from lap_tpu_torch.training.array_utils import gather_host_json
from lap_tpu_torch.training.config import TrainConfig, cli
from lap_tpu_torch.training.state import TrainState
from lap_tpu_torch.training.train_step import StepFunctions, make_step_functions

logger = logging.getLogger("lap_tpu_torch.train")

LANGACT_START = 8  # first language-action token of the synthetic prompt
LOADER_STATE = "dataloader_process_0/dataloader_state.json"


def fake_train_batch(cfg: LAPConfig, batch: int, *, device, seed: int = 0):
    """The synthetic training batch: (observation, actions). The prompt is
    the ids 0, 1, ...; for a Gemma3 model it starts with the image blocks
    ``Gemma3Tokenizer`` writes (``lap_gemma3.image_prompt_head``), and the
    language-action span starts ``LANGACT_START`` tokens after them."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    h, w = cfg.image_resolution
    t = cfg.max_token_len
    obs = cfg.fake_obs(batch, device=device)
    images = {
        k: torch.randint(0, 256, (batch, h, w, 3), dtype=torch.uint8, generator=gen).to(device)
        for k in cfg.image_keys
    }
    prompt = torch.arange(t, dtype=torch.int32)
    langact_start = LANGACT_START
    if "gemma3" in cfg.paligemma_variant:
        from lap_tpu_torch.models.lap_gemma3 import image_prompt_head

        head = image_prompt_head(cfg)
        prompt[: len(head)] = torch.tensor(head, dtype=torch.int32)
        langact_start += len(head)
    obs = obs.replace(
        images=images,
        tokenized_prompt=prompt.to(device).expand(batch, t).contiguous(),
        tokenized_langact_mask=(torch.arange(t, device=device) >= langact_start).expand(batch, t).contiguous(),
        token_loss_mask=torch.ones((batch, t), dtype=torch.bool, device=device),
    )
    actions = torch.randn((batch, cfg.action_horizon, cfg.action_dim), generator=gen).to(device)
    return obs, actions


def reduce_metrics(metrics: dict) -> dict:
    """Scalar-reducible entries as floats; arrays of up to 4096 entries by
    their mean (``lap_tpu/training/metrics_logging.py:86``)."""
    out = {}
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().float().cpu().numpy()
        try:
            arr = np.asarray(v)
        except (TypeError, ValueError):
            continue
        if arr.dtype == object or arr.dtype.kind in "US" or arr.size == 0:
            continue
        if arr.ndim == 0:
            out[k] = float(arr)
        elif arr.size <= 4096:
            out[k] = float(arr.mean())
    return out


def _format(metrics: dict) -> str:
    return " ".join(f"{k}={v:.9g}" for k, v in sorted(metrics.items()))


@dataclasses.dataclass
class Trainer:
    """A built model with its step functions and state."""

    config: TrainConfig
    model: LAP
    steps: StepFunctions
    state: TrainState

    def run(self, batch, num_steps: int) -> list[dict]:
        """Take ``num_steps`` optimizer steps on ``batch``; returns one record
        per step (loss, grad_norm, param_norm, step_ms)."""
        records = []
        for i in range(num_steps):
            t0 = time.monotonic()
            self.state, metrics = self.steps.train_step(self.state, batch)
            record = {k: float(metrics[k]) for k in ("loss", "grad_norm", "param_norm")}  # syncs the device
            record["step_ms"] = (time.monotonic() - t0) * 1e3
            records.append(record)
            step = self.state.step
            if i == 0 or step % self.config.log_interval == 0 or i == num_steps - 1:
                logger.info("step %d loss %.4f grad_norm %.4f step_ms %.1f",
                            step, record["loss"], record["grad_norm"], record["step_ms"])
        return records


def build_trainer(config: TrainConfig, *, device=None, param_dtype: str | None = None,
                  init_weights: bool = True, mesh=None, weights=None) -> Trainer:
    """The configured model from the config's seed (empty when not
    ``init_weights``: a restore fills it), on the card unless ``device`` says
    otherwise, with its optimizer state and EMA. ``weights`` (a weight
    loader) are merged in before the state is made. With ``mesh`` the model
    is sharded over it (a model that a restore fills is built on ``meta``
    and sharded before any storage is allocated)."""
    device = resolve_device(device)
    dtype = getattr(torch, param_dtype or config.param_dtype)
    on_meta = mesh is not None and not init_weights
    model = config.model.create_module(device="meta" if on_meta else device,
                                       init_seed=config.seed if init_weights else None, param_dtype=dtype)
    if weights is not None:
        from lap_tpu_torch.training.weight_loaders import load_into

        load_into(model, weights)
    if mesh is not None:
        parallelize_(model, mesh, sequence_parallel=config.sequence_parallel)
        if on_meta:
            model.to_empty(device=device)
    freeze = get_vlm_freeze_filter(config.model) if config.freeze_vlm else get_freeze_filter(config.model)
    steps = make_step_functions(
        model,
        config.optimizer,
        config.lr_schedule,
        ema_decay_for_step=config.get_ema_decay_for_step if config.has_ema else None,
        freeze_filter=freeze,
        seed=config.seed,
    )
    return Trainer(config=config, model=model, steps=steps, state=steps.init_fn())


def train(config: TrainConfig, *, device=None, num_steps: int | None = None,
          batch_size: int | None = None, param_dtype: str | None = None) -> list[dict]:
    """Build the model and take ``num_steps`` optimizer steps on the synthetic
    batch; returns the per-step records of ``Trainer.run``."""
    trainer = build_trainer(config, device=device, param_dtype=param_dtype)
    device = trainer.model.device
    num_steps = config.num_train_steps if num_steps is None else num_steps
    batch = fake_train_batch(config.model, batch_size or config.batch_size, device=device, seed=config.seed)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    logger.info("training %s: %d params (%s), %d trainable tensors, batch %d on %s",
                config.name, n_params, param_dtype or config.param_dtype,
                len(trainer.state.trainable), batch[1].shape[0], device)
    return trainer.run(batch, num_steps)


def _wait_for_saves(ckpt_mgr, timings: dict) -> None:
    """Join the write in flight (every rank waits for rank 0's); the wait
    goes to ``timings["save_wait_s"]``."""
    t0 = time.monotonic()
    ckpt_mgr.wait_until_finished()
    if dist.is_initialized():
        dist.barrier()
    timings["save_wait_s"] = time.monotonic() - t0


def _log_finished_save(ckpt_mgr, reported: dict) -> None:
    """Log the latest finished save once."""
    done = ckpt_mgr.last_save
    if done and done["step"] != reported.get("step"):
        logger.info("saved checkpoint at step %d (%d bytes in %.2f s; the loop blocked %.2f s)", done["step"],
                    done["bytes"], done["seconds"], done["blocked_s"])
        reported.update(done)


def _collect_assets(config: TrainConfig, loader) -> dict:
    assets = {}
    stats = getattr(loader, "norm_stats", None)
    if stats:
        assets[f"{config.data.asset_id}/norm_stats.json"] = {"norm_stats": {k: v.to_dict() for k, v in stats.items()}}
    state_dict = getattr(loader, "state_dict", lambda: None)()
    if state_dict:
        for i, st in enumerate(gather_host_json(state_dict)):
            assets[f"dataloader_process_{i}/dataloader_state.json"] = st
    return assets


def _mesh_for(config: TrainConfig, device: torch.device):
    """The run's mesh: built over the process group when there is one (a
    run of one rank too), None for a plain single process."""
    if not dist.is_initialized():
        if config.fsdp_devices > 1 or config.tp_devices > 1:
            raise ValueError("fsdp_devices / tp_devices > 1 need one process a card: launch under torchrun "
                             "(python -m torch.distributed.run --nproc_per_node N -m lap_tpu_torch.training.train)")
        return None
    fsdp = _mesh.pick_fsdp_devices(config.fsdp_devices, dist.get_world_size() // config.tp_devices)
    return _mesh.make_mesh(fsdp, config.tp_devices, device_type=device.type)


def _open_checkpoints(config: TrainConfig, mesh):
    """``initialize_checkpoint_dir`` on rank 0 first (it may wipe the
    directory), then on the other ranks."""
    kw = dict(keep_period=config.keep_period, overwrite=config.overwrite, resume=config.resume)
    if mesh is None:
        return _checkpoints.initialize_checkpoint_dir(config.checkpoint_dir, **kw)
    out = None
    if dist.get_rank() == 0:
        out = _checkpoints.initialize_checkpoint_dir(config.checkpoint_dir, **kw)
    dist.barrier()
    if out is None:
        out = _checkpoints.initialize_checkpoint_dir(config.checkpoint_dir, **{**kw, "overwrite": False})
    return out


def _any_rank(flag: bool, mesh) -> bool:
    """Whether ``flag`` is set on any rank (the flag itself without a mesh)."""
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=_mesh.coordinate_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


@dataclasses.dataclass
class RunResult:
    """What a run leaves to a caller in the same process: the trainer (its
    state as the last step left it), the loader with its live iterator (the
    next batch is the one a resumed run would take first), and the
    checkpoint manager. ``close`` stops the loaders' producers."""

    trainer: Trainer
    loader: object
    data_iter: object
    checkpoints: _checkpoints.CheckpointManager
    metrics: dict  # the last logged step's (the first step is always logged)
    # restore_s when the run resumed; save_wait_s, the wait for the last
    # write; data_wait_s, each step's wait for its batch; step_ms, each logged
    # step's time (from its batch to its synced metrics)
    timings: dict
    val_iter: object = None

    def close(self) -> None:
        for it in (self.data_iter, self.val_iter):
            if it is not None:
                it.close()


def run(config: TrainConfig, *, device=None) -> RunResult:
    """The training loop of ``scripts/train.py:165-352`` (module header)."""
    from lap_tpu_torch.data.loader import create_data_loader

    device = resolve_device(device)
    mesh = _mesh_for(config, device)
    ckpt_mgr, resuming = _open_checkpoints(config, mesh)
    weights = None if resuming else config.weight_loader.build()
    trainer = build_trainer(config, device=device, init_weights=not resuming, mesh=mesh, weights=weights)
    if weights is not None:
        logger.info("merged pretrained weights from %s", config.weight_loader)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    logger.info("training %s/%s: %d params (%s), %d trainable tensors, EMA %s, batch %d on %s",
                config.name, config.exp_name, n_params, config.param_dtype, len(trainer.state.trainable),
                "on" if trainer.state.ema_params is not None else "off", config.batch_size, device)
    if mesh is not None:
        plan = trainer.model.parallel.plan
        logger.info("sharded over %s: %.1f MiB of parameters a rank (JAX's placement: %d sharded, %d replicated)",
                    plan.mesh_shape, plan.per_rank_bytes / 2**20, plan.num_sharded, plan.num_replicated)
    timings = {}
    if resuming:
        t0 = time.monotonic()
        ckpt_mgr.restore(None, trainer.state)
        timings["restore_s"] = time.monotonic() - t0
        logger.info("resumed from step %d (restored in %.2f s)", trainer.state.step, timings["restore_s"])

    loader = create_data_loader(config, device=device, split="train")
    if resuming:
        index, _ = process_placement()
        saved = (ckpt_mgr.load_assets(trainer.state.step, f"dataloader_process_{index}/dataloader_state.json")
                 or ckpt_mgr.load_assets(trainer.state.step, LOADER_STATE))
        if saved:
            loader.load_state_dict(saved)
            logger.info("restored dataloader state: %s", saved)
    data_iter = iter(loader)
    val_loader = val_iter = None
    if config.use_validation:
        val_loader = create_data_loader(config, device=device, split="val")
        val_iter = iter(val_loader)

    preempted = threading.Event()

    def on_sigterm(signum, frame):  # noqa: ARG001
        logger.warning("SIGTERM received: checkpointing and exiting after this step")
        preempted.set()

    previous = None
    try:
        previous = signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:  # not the main thread
        pass

    start_step = trainer.state.step
    metrics: dict = {}
    reported: dict = {}
    try:
        for step in range(start_step, config.num_train_steps):
            t_wait = time.monotonic()
            batch = next(data_iter)
            t0 = time.monotonic()
            timings.setdefault("data_wait_s", []).append(t0 - t_wait)
            trainer.state, step_metrics = trainer.steps.train_step(trainer.state, batch)
            if (step + 1) % config.log_interval == 0 or step == start_step:
                metrics = reduce_metrics(step_metrics)  # syncs the device
                metrics["step_ms"] = (time.monotonic() - t0) * 1e3
                timings.setdefault("step_ms", []).append(metrics["step_ms"])
                logger.info("step %d %s", step + 1, _format(metrics))
            if val_iter is not None and (step + 1) % config.val_interval == 0:
                try:
                    val_metrics = reduce_metrics(trainer.steps.val_step(trainer.state, next(val_iter)))
                    logger.info("step %d val %s", step + 1, _format(val_metrics))
                except StopIteration:
                    val_iter = iter(val_loader)
            stop = _any_rank(preempted.is_set(), mesh)
            if (step + 1) % config.save_interval == 0 or step + 1 == config.num_train_steps or stop:
                ckpt_mgr.save(step + 1, trainer.state, assets=_collect_assets(config, loader))
                _log_finished_save(ckpt_mgr, reported)
            if stop:
                _wait_for_saves(ckpt_mgr, timings)
                _log_finished_save(ckpt_mgr, reported)
                logger.warning("exiting after preemption checkpoint at step %d", step + 1)
                break
        else:
            _wait_for_saves(ckpt_mgr, timings)
            _log_finished_save(ckpt_mgr, reported)
            logger.info("training complete at step %d", config.num_train_steps)
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    return RunResult(trainer=trainer, loader=loader, data_iter=data_iter, checkpoints=ckpt_mgr, metrics=metrics,
                     timings=timings, val_iter=val_iter)


def split_device(argv: list[str]) -> tuple[str | None, list[str]]:
    """Take ``--device X`` (or ``--device=X``) out of a config command line."""
    rest, device, i = [], None, 0
    while i < len(argv):
        if argv[i] == "--device" and i + 1 < len(argv):
            device, i = argv[i + 1], i + 2
        elif argv[i].startswith("--device="):
            device, i = argv[i].split("=", 1)[1], i + 1
        else:
            rest.append(argv[i])
            i += 1
    return device, rest


def main(argv: list[str] | None = None) -> RunResult:
    """``--device`` comes out first; under ``torchrun`` the process group is
    joined with the backend that device takes (``init_distributed``)."""
    device, rest = split_device(sys.argv[1:] if argv is None else argv)
    config = cli(rest)
    rank, _ = _mesh.init_distributed(device=device)
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format="%(asctime)s %(levelname).1s %(name)s: %(message)s", datefmt="%H:%M:%S")
    return run(config, device=device)


if __name__ == "__main__":
    main().close()
    if dist.is_initialized():
        dist.destroy_process_group()
