"""Checkpoint files of the port (port of ``lap_tpu/training/checkpoints.py``).

- Norm stats: ``load_norm_stats``/``save_norm_stats`` read and write the JAX
  package's ``assets/<asset_id>/norm_stats.json`` layout
  (``lap_tpu/training/checkpoints.py:353``, ``lap_tpu/data/norm_stats.py:199``),
  so one assets directory serves both packages.
- Serving params: ``save_params(params, params_dir)`` writes
  ``params_dir/model.pt``, a ``torch.save`` of a ``{name: tensor}`` dict (a
  model's ``named_parameters()`` or the EMA view; the quantized copies are not
  saved: ``quantize_`` rebuilds them after a restore). ``restore_params(params_dir,
  model)`` loads it with ``weights_only=True, mmap=True`` and copies tensor
  by tensor into a model built with ``init_seed=None``: no weights are
  initialised first, and the host holds no second full copy (pages of the
  file are read as each tensor goes to its device). Values are cast to each
  parameter's dtype, so an f32 file restores into a bf16 model. A
  ``params/`` directory exported from a JAX orbax checkpoint holds
  ``params.npz`` instead (``scripts/export_jax_params.py``), which
  ``restore_params`` reads through the weight bridge.
- The train state: ``CheckpointManager`` (``checkpoints.py:44-208``) with the
  JAX layout, one directory a step, ``{directory}/{step}/``:

  - ``train_state/train_state.pt``: the step, the trainable names, the
    parameters, the optimizer's ``count`` and buffers (Adam's
    ``mu``/``nu``, SGD's ``trace``; over the trainable names) and the EMA
    (``{}`` when there is none, as the JAX package encodes it,
    ``:170-174``). ``torch.save`` copies a card's tensors to the host one
    storage at a time; the restore loads with ``mmap=True`` and copies tensor
    by tensor into the live state;
  - ``params/model.pt``: the EMA view (``inference_params``), which
    ``create_trained_policy`` serves;
  - ``assets/<path>``: JSON files, ``<asset_id>/norm_stats.json`` and
    ``dataloader_process_0/dataloader_state.json``.

  A step is written to a temporary sibling (``{step}.tmp-<pid>``), every file
  and directory is fsynced, and the sibling is renamed: ``all_steps`` and
  ``latest_step`` see only whole steps, so a kill mid-save leaves the
  previous step loadable (a stale sibling is removed when a manager opens the
  directory). Retention matches orbax's with ``max_to_keep`` and
  ``keep_period``: after a save a step is kept if it is one of the newest
  ``max_to_keep`` or a multiple of ``keep_period``. A failed save is retried
  ``save_retries`` times with a doubling delay.

  Saves are asynchronous by default, as JAX's ``async_save=True``
  (``checkpoints.py:44-128``): ``save`` copies the state to host memory
  (pinned for a card's tensors, one copy a storage, one device sync) and
  returns; a writer thread writes, fsyncs, renames and applies retention,
  with the same retry. A second ``save`` and ``restore`` wait for the write
  in flight; ``wait_until_finished`` joins it; an error of the writer is
  raised by the next ``save`` or ``wait_until_finished``. ``last_save``
  holds the step, its bytes, the seconds ``save`` blocked the caller
  (``blocked_s``: the wait for an earlier write and the copy) and the
  seconds of the write (``seconds``).
  ``async_save=False`` writes from the live tensors before returning.
  ``load_assets`` reads the JAX package's assets item
  (``{step}/assets/metadata``, one JSON object) and falls back to the file
  ``{step}/assets/<path>`` (``:153-167``).
- ``initialize_checkpoint_dir`` (``:185-208``): overwrite wipes, resume
  resumes, neither raises ``FileExistsError``; a resume with no step starts
  fresh.
- A sharded model (``parallel.sharding.parallelize_``, FSDP and/or tp):
  ``save`` gathers the whole of each tensor, one at a time
  (``sharding.full_tensor``: a collective every rank joins in the same
  order), to rank 0's host memory, and rank 0 writes the same files as one
  process does; the other ranks write nothing. ``restore`` and
  ``restore_params_sharded`` (``checkpoints.py:238``) read the files with
  ``mmap=True`` on every rank and copy only the rank's own slice of each
  tensor (``sharding.local_shard``), so the whole model is never staged on
  one rank's device. Any layout restores into any other, one process
  included.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import torch
from torch import nn

from lap_tpu_torch.training.state import TrainState, inference_params

logger = logging.getLogger(__name__)

PARAMS_FILE = "model.pt"
TRAIN_STATE_FILE = "train_state.pt"
TMP_MARK = ".tmp-"


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


def save_params(params: dict[str, torch.Tensor] | nn.Module, params_dir: str | Path) -> Path:
    """Write ``{name: tensor}`` (or a model's parameters) to
    ``params_dir/model.pt`` in the tensors' dtype. Returns the file's path."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    params_dir = Path(params_dir)
    params_dir.mkdir(parents=True, exist_ok=True)
    path = params_dir / PARAMS_FILE
    torch.save({name: p.detach() for name, p in params.items()}, path)
    return path


@torch.no_grad()
def restore_params(params_dir: str | Path, model: nn.Module) -> nn.Module:
    """Fill every parameter of ``model`` from ``params_dir``: the port's
    ``model.pt``, or ``params.npz`` exported from JAX.

    Raises if neither file is there, a parameter is left unfilled, an entry
    is left over, or a shape differs.
    """
    from lap_tpu_torch.training.weight_loaders import NPZ_FILE

    params_dir = Path(params_dir)
    path = params_dir / PARAMS_FILE
    if not path.exists():
        if (params_dir / NPZ_FILE).exists():
            from lap_tpu_torch.models.convert import load_jax_params, read_params_npz

            return load_jax_params(model, read_params_npz(params_dir / NPZ_FILE))
        raise FileNotFoundError(
            f"{path}: no port params file and no {NPZ_FILE}; export a JAX orbax params/ directory with "
            f"scripts/export_jax_params.py"
        )
    state = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    copy_tensors(dict(model.named_parameters()), state, "params file")
    return model


@torch.no_grad()
def restore_params_sharded(params_dir: str | Path, model: nn.Module, mesh=None) -> nn.Module:
    """``restore_params`` into a sharded model (``model.parallel``): each
    rank copies its own slice of each tensor of the file, read with
    ``mmap=True`` (a ``params.npz`` goes through the weight bridge on the
    host first). ``mesh``, when given, must be the model's."""
    from lap_tpu_torch.training.weight_loaders import NPZ_FILE

    if mesh is not None and mesh is not model.parallel.mesh:
        raise ValueError("restore_params_sharded: the mesh is not the one the model was sharded over")
    params_dir = Path(params_dir)
    path = params_dir / PARAMS_FILE
    if path.exists():
        state = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    elif (params_dir / NPZ_FILE).exists():
        from lap_tpu_torch.models.convert import from_jax_params, read_params_npz

        state = from_jax_params(read_params_npz(params_dir / NPZ_FILE))
    else:
        raise FileNotFoundError(f"{path}: no port params file and no {NPZ_FILE}")
    copy_shards(model, {n: p for n, p in model.named_parameters()}, state, "params file")
    return model


def copy_shards(model: nn.Module, own: dict[str, torch.Tensor], saved: dict[str, torch.Tensor], what: str) -> None:
    """``copy_tensors`` for a sharded model: ``own`` maps parameter names to
    this rank's shards (the parameters, or optimizer and EMA tensors laid
    out as them); each takes its slice of the whole saved tensor."""
    from lap_tpu_torch.parallel.sharding import local, local_shard

    placements = model.parallel.plan.placements
    missing = sorted(set(own) - set(saved))
    extra = sorted(set(saved) - set(own))
    if missing or extra:
        raise ValueError(f"{what} mismatch: unfilled {missing}, unexpected {extra}")
    for name in own:
        if tuple(saved[name].shape) != placements[name].shape:
            raise ValueError(f"{what}: {name}: shape {tuple(saved[name].shape)} != {placements[name].shape}")
    with torch.no_grad():
        for name, target in own.items():
            shard = local(target)
            shard.copy_(local_shard(model, name, saved[name]).to(dtype=shard.dtype))


def copy_tensors(own: dict[str, torch.Tensor], saved: dict[str, torch.Tensor], what: str) -> None:
    """Copy ``saved`` into ``own`` tensor by tensor (cast to each target's
    dtype), after checking that the names and shapes agree."""
    missing = sorted(set(own) - set(saved))
    extra = sorted(set(saved) - set(own))
    if missing or extra:
        raise ValueError(f"{what} mismatch: unfilled {missing}, unexpected {extra}")
    for name, target in own.items():
        if tuple(saved[name].shape) != tuple(target.shape):
            raise ValueError(f"{what}: {name}: shape {tuple(saved[name].shape)} != {tuple(target.shape)}")
    with torch.no_grad():
        for name, target in own.items():
            target.copy_(saved[name].to(dtype=target.dtype))


# ---------------------------------------------------------------------------
# The train state
# ---------------------------------------------------------------------------


def _train_state_dict(state: TrainState) -> dict:
    opt = {"count": int(state.opt_state.count)}
    for name, tensors in state.opt_state.buffers().items():
        opt[name] = dict(zip(state.trainable, tensors, strict=True))
    return {
        "step": int(state.step),
        "trainable": list(state.trainable),
        "params": {n: p.detach() for n, p in state.params.items()},
        "opt_state": opt,
        # No EMA is saved as {} (the JAX package's encoding).
        "ema_params": {} if state.ema_params is None else dict(state.ema_params),
    }


def _payload(state: TrainState) -> dict:
    """What a step directory holds: the train state and the EMA view."""
    return {"train_state": _train_state_dict(state), "params": dict(inference_params(state))}


def _gathered_payload(state: TrainState) -> dict | None:
    """``_payload`` of a sharded model as whole tensors in rank 0's host
    memory (None on the other ranks); every rank calls it."""
    import torch.distributed as dist

    from lap_tpu_torch.parallel.sharding import full_tensor

    model = state.model
    keep = dist.get_rank() == 0

    def whole(name: str, part: torch.Tensor):
        t = full_tensor(model, name, part)
        return t.to("cpu", copy=True) if keep else None

    params = {n: whole(n, p) for n, p in state.params.items()}
    opt = {"count": int(state.opt_state.count)}
    for buf, tensors in state.opt_state.buffers().items():
        opt[buf] = {n: whole(n, t) for n, t in zip(state.trainable, tensors, strict=True)}
    ema = {} if state.ema_params is None else {n: whole(n, t) for n, t in state.ema_params.items()}
    if not keep:
        return None
    train_state = {"step": int(state.step), "trainable": list(state.trainable), "params": params,
                   "opt_state": opt, "ema_params": ema}
    return {"train_state": train_state, "params": {n: ema.get(n, p) for n, p in params.items()}}


def snapshot_to_host(tree):
    """A copy of every tensor of ``tree`` (nested dicts) in host memory:
    pinned for a card's tensors (copied without blocking, then one device
    sync), cloned for the CPU's; tensors that share storage and layout are
    copied once and stay shared."""
    copies: dict = {}
    synced = []

    def copy(t: torch.Tensor) -> torch.Tensor:
        key = (t.data_ptr(), t.dtype, tuple(t.shape), tuple(t.stride()), t.device)
        if key not in copies:
            if t.is_cuda:
                out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                out.copy_(t.detach(), non_blocking=True)
                synced.append(t.device)
            else:
                out = t.detach().clone()
            copies[key] = out
        return copies[key]

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return copy(node) if isinstance(node, torch.Tensor) else node

    out = walk(tree)
    for device in set(synced):
        torch.cuda.synchronize(device)
    return out


def _fsync_tree(root: Path) -> None:
    """fsync every file under ``root``, then every directory, bottom up."""
    for dirpath, _, files in os.walk(root, topdown=False):
        for name in files:
            fd = os.open(os.path.join(dirpath, name), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        _fsync_dir(Path(dirpath))


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@dataclasses.dataclass
class CheckpointManager:
    """Train-state checkpoints, one atomic directory a step (module header)."""

    directory: Path
    keep_period: int | None = None
    max_to_keep: int | None = 1
    save_retries: int = 2
    retry_delay_s: float = 1.0
    async_save: bool = True

    def __post_init__(self):
        self.directory = Path(self.directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.last_save: dict | None = None  # step, bytes and seconds of the latest finished save
        self._writer: threading.Thread | None = None
        self._writer_error: BaseException | None = None
        for stale in self.directory.glob(f"*{TMP_MARK}*"):
            logger.info("removing the unfinished checkpoint %s", stale)
            shutil.rmtree(stale, ignore_errors=True)

    # -- queries ------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(d.name) for d in self.directory.iterdir() if d.name.isdigit() and d.is_dir())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> Path:
        return self.directory / str(step)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: TrainState, *, assets: dict | None = None) -> None:
        """Write ``{step}/`` (train state, EMA view, assets), retrying a
        failed write with a doubling delay, then apply retention; with
        ``async_save`` from a host snapshot, on the writer thread."""
        t0 = time.monotonic()
        self.wait_until_finished()  # a write in flight blocks the caller too
        sharded = getattr(state.model, "parallel", None) is not None
        if sharded:
            payload = _gathered_payload(state)  # whole tensors on rank 0's host
            if payload is None:
                return
        if not self.async_save:
            self._save_blocking(step, payload if sharded else _payload(state), assets or {}, t0, blocked_s=None)
            return
        if not sharded:
            payload = snapshot_to_host(_payload(state))
        blocked_s = time.monotonic() - t0

        def write():
            try:
                self._save_blocking(step, payload, assets or {}, time.monotonic(), blocked_s=blocked_s)
            except BaseException as e:  # noqa: BLE001 - raised by the next save / wait
                self._writer_error = e

        self._writer = threading.Thread(target=write, name=f"checkpoint-{step}")
        self._writer.start()

    def wait_until_finished(self) -> None:
        """Join the write in flight; raise its error, if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._writer_error is not None:
            error, self._writer_error = self._writer_error, None
            raise error

    def _save_blocking(self, step: int, payload: dict, assets: dict, t0: float, *, blocked_s) -> None:
        delay = self.retry_delay_s
        for attempt in range(self.save_retries + 1):
            try:
                self._write(step, payload, assets)
                break
            except OSError as e:
                logger.warning("checkpoint save at step %d failed (attempt %d/%d): %s",
                               step, attempt + 1, self.save_retries + 1, e)
                if attempt == self.save_retries:
                    raise
                time.sleep(delay)
                delay *= 2
        seconds = time.monotonic() - t0
        nbytes = sum(f.stat().st_size for f in self.step_dir(step).rglob("*") if f.is_file())
        self.last_save = {"step": step, "bytes": nbytes, "seconds": seconds,
                          "blocked_s": seconds if blocked_s is None else blocked_s}
        self._remove_old()

    def _write(self, step: int, payload: dict, assets: dict) -> None:
        tmp = self.directory / f"{step}{TMP_MARK}{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        (tmp / "train_state").mkdir(parents=True)
        torch.save(payload["train_state"], tmp / "train_state" / TRAIN_STATE_FILE)
        save_params(payload["params"], tmp / "params")
        for rel, payload in assets.items():
            path = tmp / "assets" / rel
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(payload))
        _fsync_tree(tmp)
        final = self.step_dir(step)
        if final.exists():  # a step written again replaces the old one
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(self.directory)

    def _remove_old(self) -> None:
        steps = self.all_steps()
        keep = set(steps if self.max_to_keep is None else steps[len(steps) - self.max_to_keep:])
        if self.keep_period is not None:
            keep |= {s for s in steps if s % self.keep_period == 0}
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.step_dir(s))

    # -- restore ------------------------------------------------------------
    @torch.no_grad()
    def restore(self, step: int | None, state: TrainState) -> TrainState:
        """Fill ``state`` (its model's parameters, moments, EMA, step) from
        ``{step}/train_state`` (the latest step when None), in place, after
        the write in flight."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = self.step_dir(step) / "train_state" / TRAIN_STATE_FILE
        saved = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        if saved["trainable"] != list(state.trainable):
            raise ValueError(
                f"{path}: trainable parameters differ from the run's "
                f"({len(saved['trainable'])} saved, {len(state.trainable)} now): freeze as the saved run did"
            )
        if (state.ema_params is None) != (not saved["ema_params"]):
            raise ValueError(f"{path}: the saved run {'had' if saved['ema_params'] else 'had no'} EMA; this one "
                             f"{'has none' if state.ema_params is None else 'has one'}")
        opt = saved["opt_state"]
        buffers = state.opt_state.buffers()
        if set(opt) - {"count"} != set(buffers):
            raise ValueError(f"{path}: optimizer state {sorted(set(opt) - {'count'})} saved, this run's optimizer "
                             f"keeps {sorted(buffers)}: resume with the saved run's optimizer")
        if getattr(state.model, "parallel", None) is not None:
            def copy(own, saved_tensors, what):
                copy_shards(state.model, own, saved_tensors, what)
        else:
            copy = copy_tensors
        copy(state.params, saved["params"], "train state params")
        for name, tensors in buffers.items():
            copy(dict(zip(state.trainable, tensors, strict=True)), opt[name], f"optimizer {name}")
        state.opt_state.count = int(opt["count"])
        if state.ema_params is not None:
            copy(state.ema_params, saved["ema_params"], "EMA")
        state.step = int(saved["step"])
        return state

    def load_assets(self, step: int, rel_path: str) -> Any | None:
        """One asset saved at ``step`` (None when absent): from the JAX
        package's assets item, else the file ``{step}/assets/<rel_path>``."""
        assets = self.step_dir(step) / "assets"
        item = assets / "metadata"
        if item.is_file():
            try:
                payload = json.loads(item.read_text())
            except ValueError:
                payload = None
            if isinstance(payload, dict) and rel_path in payload:
                return payload[rel_path]
        path = assets / rel_path
        if not path.is_file():
            return None
        return json.loads(path.read_text())


def initialize_checkpoint_dir(
    checkpoint_dir: str | Path, *, keep_period: int | None, overwrite: bool, resume: bool
) -> tuple[CheckpointManager, bool]:
    """Create or inspect the checkpoint directory; returns (manager, resuming)."""
    checkpoint_dir = Path(checkpoint_dir).resolve()
    resuming = False
    if checkpoint_dir.exists() and any(checkpoint_dir.iterdir()):
        if overwrite:
            shutil.rmtree(checkpoint_dir)
            logger.info("wiped checkpoint dir %s", checkpoint_dir)
        elif resume:
            resuming = True
        else:
            raise FileExistsError(f"{checkpoint_dir} exists; pass resume=True or overwrite=True")
    mgr = CheckpointManager(checkpoint_dir, keep_period=keep_period)
    if resuming and mgr.latest_step() is None:
        logger.info("resume requested but no checkpoint found; starting fresh")
        resuming = False
    return mgr, resuming
