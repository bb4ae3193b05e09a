"""Default-device rule and process placement shared by the port's entry points."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return ``device``; when none is given, this rank's card:
    ``cuda:{LOCAL_RANK}`` under ``torchrun`` (``LOCAL_RANK`` set) or when a
    process group is up (its rank on a one-host run), and ``cuda`` otherwise.

    There is no silent CPU fallback: without a GPU the caller must ask for
    ``device="cpu"`` explicitly. An explicit device always wins (two ranks
    may share one card that way). Raises when the local rank has no card.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "lap_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    local = os.environ.get("LOCAL_RANK")
    if local is None and dist.is_initialized():
        local = dist.get_rank()
    if local is None:
        return torch.device("cuda")
    local = int(local)
    if local >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local} has no card ({torch.cuda.device_count()} visible); pass a device explicitly"
        )
    return torch.device(f"cuda:{local}")


def process_placement() -> tuple[int, int]:
    """(index, count) of this rank over the data axes (dp x fsdp) of the mesh
    this process built (``parallel.mesh.make_mesh``): the part of JAX's
    ``jax.process_index()``/``process_count()`` that splits the data. The tp
    ranks of one group share one data index and load the same batch. Without
    a mesh: the process group's (rank, world size), or (0, 1) without one."""
    from lap_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.process_mesh()
    if mesh is not None:
        return mesh_lib.data_placement(mesh)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
