"""The (dp, fsdp, tp) mesh over ``torch.distributed`` (port of
``lap_tpu/parallel/mesh.py:1-320``, without pipeline parallelism).

JAX runs one process that drives every device of its host; the port runs
one process per GPU. So a mesh here is a ``DeviceMesh`` over ranks, with dim
names ``("dp", "fsdp", "tp")``:

- ``rank_layout`` is JAX's ``_host_aware_layout`` (``:160-191``) as a pure
  function of (ranks, ranks per host): a model group (fsdp x tp ranks)
  never straddles a host when it fits in one, and is built from whole hosts
  when it is larger; tp varies fastest, then fsdp, then dp. ``torchrun``
  numbers ranks host by host, so host ``h`` holds ranks ``h * per_host ...``.
  On one host, and where the host-aware layout is infeasible, the ranks are
  reshaped in order, as JAX falls back to a reshape of its device list.
- Data (the batch dim) shards over dp and fsdp (``DATA_AXES``): the ranks of
  one tp group load the same batch. ``make_mesh`` also builds the
  process group of each rank's data ranks (same tp coordinate) and the
  process-wide record that ``device.process_placement`` reads.
- The ambient mesh (``set_mesh``/``get_mesh``/``suspend_mesh``/
  ``sequence_parallel_enabled``) is thread-local, as JAX's. Model code reads
  it once in the calling thread and passes what it needs down explicitly
  (``parallel/tp.py``): autograd runs a backward pass, and the recompute of
  a checkpointed block, on threads of its own.
- ``init_distributed`` reads ``torchrun``'s environment. The backend is the
  caller's: by default NCCL on CUDA and gloo when the caller's device is the
  CPU; it is never switched in silence.

There is no ``activation_sharding_constraint``: GSPMD places activations in
JAX, while here the collectives that placement implies are written at the
points JAX constrains (``parallel/tp.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
from collections.abc import Mapping

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

BATCH_AXIS = "dp"
FSDP_AXIS = "fsdp"
TP_AXIS = "tp"
DATA_AXES = (BATCH_AXIS, FSDP_AXIS)
MESH_AXES = (BATCH_AXIS, FSDP_AXIS, TP_AXIS)

PP_NOT_PORTED = "pipeline parallelism (pp_devices > 1) is not ported yet (ROADMAP queue A, item 13b)"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical parallelism layout: fsdp_devices * tp_devices must divide
    the rank count; the remaining factor is pure data parallelism."""

    fsdp_devices: int = 1
    tp_devices: int = 1

    def __post_init__(self):
        if self.fsdp_devices < 1 or self.tp_devices < 1:
            raise ValueError("fsdp_devices and tp_devices must be >= 1")


def _host_aware_layout(n_ranks: int, ranks_per_host: int, fsdp_devices: int, tp_devices: int):
    """JAX's ``_host_aware_layout`` over rank ids: [dp, fsdp, tp], or None
    for one host and for infeasible layouts."""
    if ranks_per_host < 1 or n_ranks % ranks_per_host:
        return None
    hosts = n_ranks // ranks_per_host
    if hosts <= 1:
        return None
    model = fsdp_devices * tp_devices
    grid = np.arange(n_ranks).reshape(hosts, ranks_per_host)
    if model <= ranks_per_host:
        if ranks_per_host % model:
            return None
        return grid.reshape(hosts * (ranks_per_host // model), fsdp_devices, tp_devices)
    if model % ranks_per_host or hosts % (model // ranks_per_host):
        return None
    return grid.reshape(hosts // (model // ranks_per_host), fsdp_devices, tp_devices)


def rank_layout(n_ranks: int, fsdp_devices: int = 1, tp_devices: int = 1, *,
                ranks_per_host: int | None = None) -> np.ndarray:
    """The rank ids as a [dp, fsdp, tp] array (module header). Raises when
    fsdp * tp does not divide the rank count."""
    MeshConfig(fsdp_devices, tp_devices)
    model = fsdp_devices * tp_devices
    if n_ranks % model:
        raise ValueError(f"{n_ranks} ranks not divisible by fsdp_devices*tp_devices = {fsdp_devices}*{tp_devices}")
    grid = _host_aware_layout(n_ranks, ranks_per_host or n_ranks, fsdp_devices, tp_devices)
    if grid is None:
        grid = np.arange(n_ranks).reshape(n_ranks // model, fsdp_devices, tp_devices)
    return grid


def pick_fsdp_devices(requested: int, n_devices: int | None = None) -> int:
    """Largest divisor of the rank count that is <= requested (JAX's
    graceful fallback, ``scripts/train.py:134-147``)."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    requested = max(1, min(requested, n_devices))
    for cand in range(requested, 0, -1):
        if n_devices % cand == 0:
            return cand
    return 1


def init_distributed(backend: str | None = None, *, device=None) -> tuple[int, int]:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``); returns (rank, world
    size). Without that environment, and when a group is already up, it
    joins nothing. ``backend`` defaults to gloo when ``device`` is the CPU,
    else to NCCL when CUDA is available and to gloo otherwise."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return 0, 1
    if backend is None:
        on_cpu = device is not None and torch.device(device).type == "cpu"
        backend = "nccl" if torch.cuda.is_available() and not on_cpu else "gloo"
    dist.init_process_group(backend)
    logger.info("joined a %s process group: rank %d of %d", backend, dist.get_rank(), dist.get_world_size())
    return dist.get_rank(), dist.get_world_size()


def make_mesh(fsdp_devices: int = 1, tp_devices: int = 1, pp_devices: int = 1, *,
              ranks_per_host: int | None = None, device_type: str | None = None):
    """A ``DeviceMesh`` ("dp", "fsdp", "tp") over the process group's ranks
    (``rank_layout``), with this rank's data group beside it. Every rank
    calls it, in the same order. ``ranks_per_host`` defaults to
    ``LOCAL_WORLD_SIZE`` (``torchrun``), else all ranks on one host;
    ``device_type`` is where the model lives (FSDP places its buffers
    there): ``cuda`` when CUDA is available, else ``cpu``."""
    from torch.distributed.device_mesh import DeviceMesh

    if pp_devices > 1:
        raise NotImplementedError(PP_NOT_PORTED)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed() (or run under torchrun)")
    world = dist.get_world_size()
    if ranks_per_host is None and "LOCAL_WORLD_SIZE" in os.environ:
        ranks_per_host = int(os.environ["LOCAL_WORLD_SIZE"])
    layout = rank_layout(world, fsdp_devices, tp_devices, ranks_per_host=ranks_per_host)
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    mesh = DeviceMesh(device_type, torch.as_tensor(layout), mesh_dim_names=MESH_AXES)
    # The data ranks of each tp coordinate, as one process group each.
    groups = [layout[:, :, t].reshape(-1).tolist() for t in range(tp_devices)]
    if len(groups) == 1:
        data_group = dist.group.WORLD
    else:
        data_group, _ = dist.new_subgroups_by_enumeration(groups)
    global _PROCESS_MESH
    _PROCESS_MESH = _MeshRecord(mesh=mesh, layout=layout, data_group=data_group)
    logger.info("mesh %s over %d ranks", dict(zip(MESH_AXES, layout.shape, strict=True)), world)
    return mesh


@dataclasses.dataclass(frozen=True)
class _MeshRecord:
    mesh: object
    layout: np.ndarray
    data_group: object


_PROCESS_MESH: _MeshRecord | None = None


def _record(mesh) -> _MeshRecord:
    if _PROCESS_MESH is None or _PROCESS_MESH.mesh is not mesh:
        raise ValueError("this mesh was not built by make_mesh in this process")
    return _PROCESS_MESH


def process_mesh():
    """The mesh ``make_mesh`` last built in this process, or None."""
    return None if _PROCESS_MESH is None else _PROCESS_MESH.mesh


def mesh_shape(mesh) -> dict[str, int]:
    """{axis: size} of a ``DeviceMesh`` or of a mapping of axis sizes (a mesh
    planned but not built, as for a model larger than the ranks at hand)."""
    if isinstance(mesh, Mapping):
        return {a: int(mesh.get(a, 1)) for a in MESH_AXES}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape, strict=True))


def coordinate(mesh) -> dict[str, int]:
    """This rank's {axis: index} in ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate(), strict=True))


def coordinate_device(mesh) -> torch.device:
    """Where a tensor for a collective over ``mesh`` lives: this rank's card
    for a CUDA mesh (its current device), the CPU otherwise."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def tp_group(mesh):
    """The process group of this rank's tp axis, or None when tp is 1."""
    if mesh is None or mesh_shape(mesh)[TP_AXIS] <= 1:
        return None
    return mesh.get_group(TP_AXIS)


def data_group(mesh):
    """The process group of this rank's data ranks (its dp x fsdp slice)."""
    return _record(mesh).data_group


def data_placement(mesh) -> tuple[int, int]:
    """(index over the data axes, dp * fsdp) of this rank."""
    shape, coord = mesh_shape(mesh), coordinate(mesh)
    return coord[BATCH_AXIS] * shape[FSDP_AXIS] + coord[FSDP_AXIS], shape[BATCH_AXIS] * shape[FSDP_AXIS]


def data_submesh(mesh):
    """The ("dp", "fsdp") part of ``mesh`` that FSDP shards over: both dims
    (HSDP: replicate over dp, shard over fsdp) when dp > 1, else fsdp."""
    if mesh_shape(mesh)[BATCH_AXIS] > 1:
        return mesh[DATA_AXES]
    return mesh[FSDP_AXIS]


class _MeshState(threading.local):
    mesh = None
    sequence_parallel: bool = False


_STATE = _MeshState()


@contextlib.contextmanager
def set_mesh(mesh, *, sequence_parallel: bool = False):
    """Make ``mesh`` the ambient mesh of this thread. ``sequence_parallel``
    keeps the residual stream token-sharded over tp between the attention
    and MLP regions (Megatron-SP); it is a no-op without tp > 1."""
    if _STATE.mesh is not None:
        raise ValueError("A mesh is already active; nesting is not supported.")
    if sequence_parallel and mesh_shape(mesh)[TP_AXIS] <= 1:
        sequence_parallel = False
    _STATE.mesh = mesh
    _STATE.sequence_parallel = sequence_parallel
    try:
        yield
    finally:
        _STATE.mesh = None
        _STATE.sequence_parallel = False


@contextlib.contextmanager
def suspend_mesh():
    """Clear the ambient mesh for the scope."""
    saved = _STATE.mesh, _STATE.sequence_parallel
    _STATE.mesh, _STATE.sequence_parallel = None, False
    try:
        yield
    finally:
        _STATE.mesh, _STATE.sequence_parallel = saved


def get_mesh():
    return _STATE.mesh


def sequence_parallel_enabled() -> bool:
    return _STATE.mesh is not None and _STATE.sequence_parallel


def sequence_sharded(length: int, tp: int) -> bool:
    """JAX's rule for a [B, T, D] leaf under sp (``mesh.py:283-310``): the
    token dim shards over tp when it divides and is at least tp; other
    leaves stay batch-only."""
    return tp > 1 and length >= tp and length % tp == 0


def data_sharding(mesh, batch_size: int) -> slice:
    """The rows of a global batch of ``batch_size`` that this rank holds:
    every (dp * fsdp)-th row from its data index. The loader's per-rank
    split is strided (JAX's, ``lap_tpu/data/loader.py:121-130``), so the
    global batch is the data ranks' samples in stream order; a step that
    draws randomness for the global batch gives each rank these rows."""
    index, count = data_placement(mesh)
    if batch_size % count:
        raise ValueError(f"batch {batch_size} not divisible by the {count} data ranks")
    return slice(index, batch_size, count)


def replicated(mesh, batch_size: int) -> slice:
    """Every row: a replicated batch."""
    del mesh
    return slice(0, batch_size)


def activation_sharding_constraint(pytree):
    """The identity. In JAX this pins activations for GSPMD; the port writes
    the collectives that placement implies at the same points
    (``parallel/tp.py``), so there is nothing to pin."""
    return pytree


def _data_parallel():
    """(mesh, data group) of the ambient mesh when its data axes hold more
    than one rank, else None."""
    mesh = get_mesh()
    if mesh is None or data_placement(mesh)[1] <= 1:
        return None
    return mesh, data_group(mesh)


def batch_count(count: torch.Tensor) -> torch.Tensor:
    """A per-rank count summed over the ambient mesh's data ranks (the
    global batch's count); ``count`` itself without data parallelism. The
    sum carries no gradient."""
    dp = _data_parallel()
    if dp is None:
        return count
    total = count.detach().to(torch.float64).clone()
    dist.all_reduce(total, group=dp[1])
    return total.to(count.dtype)


def batch_mean(per_sample: torch.Tensor) -> torch.Tensor:
    """The global batch's mean of ``per_sample`` [B], as this rank's share:
    its sum over the global batch size (the shares of the data ranks sum to
    the mean). ``per_sample.mean()`` without data parallelism."""
    dp = _data_parallel()
    if dp is None:
        return per_sample.mean()
    return per_sample.sum() / (per_sample.numel() * data_placement(dp[0])[1])
