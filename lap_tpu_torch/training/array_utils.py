"""Multi-process tensor utilities (port of ``lap_tpu/training/array_utils.py:1-73``).

JAX's process is a host; the port's is one rank. The data ranks (a mesh's
dp x fsdp slice, ``parallel.mesh``) each hold their own part of a batch, so
``global_concat`` and ``gather_host_json`` work over the data group of the
mesh this process built (``mesh.make_mesh``), and over the whole process
group without one. With no process group, a single process, they return
their input whole (``[obj]`` for ``gather_host_json``). Collectives are
plain ``torch.distributed`` calls: gloo runs them on CUDA tensors too.
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import torch
import torch.distributed as dist

from lap_tpu_torch.parallel import mesh as mesh_lib


def array_info(x) -> str:
    """Shape, dtype and placement of a tensor (a DTensor's placements)."""
    placement = getattr(x, "placements", None)
    return f"{tuple(x.shape)} {x.dtype} placements={placement}"


def tree_info(tree: dict, prefix: str = "") -> str:
    """``array_info`` of every tensor of a nested dict, one line each."""
    lines = []
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            lines.append(tree_info(v, path))
        else:
            lines.append(f"{path}: {array_info(v)}")
    return "\n".join(line for line in lines if line)


def to_local_array(x) -> np.ndarray:
    """This rank's part of ``x`` as numpy (a DTensor's local shard)."""
    from lap_tpu_torch.parallel.sharding import local

    return local(x).detach().cpu().numpy()


def _group():
    if not dist.is_initialized():
        return None
    mesh = mesh_lib.process_mesh()
    return dist.group.WORLD if mesh is None else mesh_lib.data_group(mesh)


def global_concat(x: torch.Tensor) -> np.ndarray:
    """Every data rank's ``x`` concatenated along dim 0, in data-rank order
    (one process: ``x``)."""
    group = _group()
    if group is None or dist.get_world_size(group) == 1:
        return to_local_array(x)
    t = x.detach().contiguous()
    out = t.new_empty((dist.get_world_size(group) * t.shape[0], *t.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, t, group=group)
    return out.cpu().numpy()


def sync_global_devices(name: str) -> None:
    """A barrier over every rank (no-op without a process group)."""
    del name
    if dist.is_initialized():
        dist.barrier()


def gather_host_json(obj) -> list:
    """One small JSON-serialisable object from each data rank, on every
    rank, in data-rank order; ``[obj]`` without a process group."""
    group = _group()
    if group is None:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, json.loads(json.dumps(obj)), group=group)
    return out
