"""Parameter placement: FSDP (ZeRO-3) and tensor parallelism (port of
``lap_tpu/parallel/sharding.py:1-193``, without the ``pp`` branch).

``fsdp_sharding(model, mesh)`` applies JAX's rules to the model's JAX
parameter tree (``convert.jax_params_template``: each port parameter's
``convert.jax_path``, layers stacked on a leading depth axis as JAX's scanned
tree holds them): a tp dim from ``DEFAULT_TP_RULES`` (attention heads at
dim -3, the MLP's largest dim, the embedding never), then, for a leaf of at
least ``min_size_bytes``, the largest remaining dim that the fsdp size
divides. It returns per port parameter JAX's spec of its leaf and the tp dim
in the port's layout, and with ``log=True`` logs JAX's sharded and
replicated counts and bytes. ``mesh`` may be a ``DeviceMesh`` or a mapping
of axis sizes (a plan for more ranks than are at hand, on the ``meta``
device).

Applying a plan (``parallelize_``):

- tp: each rank keeps its slice of every tp-sharded weight as a plain
  tensor (the ``Einsum`` weights are ``[n, d, h]`` einsums, which
  ``ColwiseParallel``/``RowwiseParallel`` do not take), and the modules that
  use a tp-replicated weight on one rank's heads record the tp group
  (``grad_sum``, ``parallel/tp.py``). The gemma stacks record the group for
  their regions. LoRA adapters under tp are not ported (JAX keeps them
  replicated; their row-parallel term needs a collective of its own), nor
  are the quantized copies (single-card, as in JAX).
- FSDP: ``fully_shard`` (FSDP2) on each Gemma/Gemma3 block, the SigLIP
  encoder and the root, over the data ranks (``mesh.data_submesh``: HSDP
  when dp > 1), summing gradients (the loss of each data rank is its share
  of the global mean). FSDP2 shards dim 0 of each parameter, where JAX
  picks the largest divisible dim (``jax_spec``); the numbers do not depend
  on the dim, and ``jax_spec`` keeps JAX's choice on record.

``full_tensor`` and ``local_shard`` move one tensor between a rank's shard
and the whole (checkpoints), with plain collectives over the mesh's groups:
gloo runs those on CUDA tensors, where it crashes in DTensor's functional
collectives.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import re
import warnings

import torch
import torch.distributed as dist
from torch import nn

from lap_tpu_torch.parallel import mesh as mesh_lib
from lap_tpu_torch.parallel.tp import make_context

logger = logging.getLogger(__name__)

DEFAULT_MIN_SIZE_BYTES = 4 * 1024 * 1024

DEFAULT_TP_RULES: tuple[tuple[str, object], ...] = (
    # Attention projections: the heads dim sits at -3 in every layout.
    (r".*attn.*(qkv_einsum|q_einsum|kv_einsum|attn_vec_einsum).*/w$", -3),
    # MLPs: the hidden dim, the largest in the Gemma ([2, D, F]) and Gemma3
    # ([2, F, D]) gating layouts.
    (r".*mlp.*(gating_einsum|linear)$", "largest"),
    # The embedding table is not tp-sharded (JAX: its gather's backward
    # would repartition [B, T, D] cotangents); FSDP still splits it.
)


@dataclasses.dataclass(frozen=True)
class Placement:
    jax_path: str
    jax_spec: tuple  # per dim of the JAX leaf: None, "fsdp" or "tp" (trailing Nones dropped)
    tp_dim: int | None  # the tp dim in the port parameter's layout
    shape: tuple[int, ...]  # the port parameter's whole shape


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    placements: dict[str, Placement]
    mesh_shape: dict[str, int]
    num_sharded: int
    num_replicated: int
    sharded_bytes: int
    replicated_bytes: int
    per_rank_bytes: int  # bytes of the JAX tree one rank holds under the plan


def _tp_dim(path: str, shape: tuple[int, ...], tp_size: int, tp_rules) -> int | None:
    if tp_size <= 1 or not shape:
        return None
    for pattern, rule in tp_rules:
        if not re.search(pattern, path):
            continue
        dim = max(range(len(shape)), key=lambda i: shape[i]) if rule == "largest" else rule % len(shape)
        if shape[dim] % tp_size == 0 and shape[dim] >= tp_size:
            return dim
    return None


def _trim(spec: list) -> tuple:
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return tuple(spec)


def _leaf_spec(shape, itemsize: int, fsdp_size: int, min_bytes: int, tp_dim: int | None) -> tuple:
    """JAX's ``_leaf_fsdp_spec``: the tp dim, then the largest divisible
    dim on fsdp (ties toward the trailing dim)."""
    spec = [None] * len(shape)
    if tp_dim is not None:
        spec[tp_dim] = mesh_lib.TP_AXIS
    if fsdp_size <= 1 or not shape or math.prod(shape) * itemsize < min_bytes:
        return _trim(spec)
    for dim in sorted(range(len(shape)), key=lambda i: (shape[i], i), reverse=True):
        if dim != tp_dim and shape[dim] % fsdp_size == 0 and shape[dim] >= fsdp_size:
            spec[dim] = mesh_lib.FSDP_AXIS
            break
    return _trim(spec)


def fsdp_sharding(model: nn.Module, mesh, *, min_size_bytes: int = DEFAULT_MIN_SIZE_BYTES,
                  tp_rules=DEFAULT_TP_RULES, log: bool = False) -> ShardingPlan:
    """The placement of every parameter of ``model`` (module header); the
    model must not be tp-sharded yet."""
    from lap_tpu_torch.models.convert import jax_params_template, jax_path

    shape = mesh_lib.mesh_shape(mesh)
    fsdp_size, tp_size = shape[mesh_lib.FSDP_AXIS], shape[mesh_lib.TP_AXIS]
    specs, stats = {}, dict(sharded=0, replicated=0, sharded_b=0, repl_b=0, rank_b=0)
    for path, leaf in jax_params_template(model).items():
        dims = tuple(leaf.shape)
        spec = _leaf_spec(dims, leaf.element_size(), fsdp_size, min_size_bytes,
                          _tp_dim(path, dims, tp_size, tp_rules))
        specs[path] = (spec, dims)
        nbytes = math.prod(dims) * leaf.element_size()
        split = math.prod(shape[a] for a in spec if a is not None)
        stats["rank_b"] += nbytes // split
        if spec:
            stats["sharded"] += 1
            stats["sharded_b"] += nbytes
            if log:
                logger.info("fsdp shard %s %s -> %s", path, dims, spec)
        else:
            stats["replicated"] += 1
            stats["repl_b"] += nbytes
    placements = {}
    for name, p in model.named_parameters():
        path = jax_path(name)
        spec, dims = specs[path]
        tp_dim = None
        if mesh_lib.TP_AXIS in spec:
            jdim = spec.index(mesh_lib.TP_AXIS)
            tp_dim = p.dim() + jdim - len(dims)
            if tp_dim < 0 or p.shape[tp_dim] != dims[jdim]:
                raise ValueError(f"{name}: tp dim {jdim} of {path} {dims} has no counterpart in {tuple(p.shape)}")
        placements[name] = Placement(path, spec, tp_dim, tuple(p.shape))
    plan = ShardingPlan(placements, shape, stats["sharded"], stats["replicated"], stats["sharded_b"],
                        stats["repl_b"], stats["rank_b"])
    if log:
        logger.info("fsdp_sharding: %d sharded (%.1f MiB), %d replicated (%.1f MiB); %.1f MiB a rank",
                    plan.num_sharded, plan.sharded_bytes / 2**20, plan.num_replicated,
                    plan.replicated_bytes / 2**20, plan.per_rank_bytes / 2**20)
    return plan


def describe_sharding(plan: ShardingPlan) -> str:
    """One line a parameter: its name, JAX path, JAX spec and port tp dim."""
    return "\n".join(f"{name}: {p.jax_path} {p.jax_spec} tp_dim={p.tp_dim}" for name, p in plan.placements.items())


# ---------------------------------------------------------------------------
# Applying a plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ModelSharding:
    """What a parallelized model records (``model.parallel``)."""

    plan: ShardingPlan
    mesh: object
    fsdp: bool
    sequence_parallel: bool = False

    @property
    def coord(self) -> dict[str, int]:
        return mesh_lib.coordinate(self.mesh)

    @property
    def data_placement(self) -> tuple[int, int]:
        return mesh_lib.data_placement(self.mesh)

    def scope(self):
        """The model's mesh as this thread's ambient mesh (the loss's
        data-parallel reductions and sequence parallelism read it)."""
        return mesh_lib.set_mesh(self.mesh, sequence_parallel=self.sequence_parallel)


def _tp_slice(t: torch.Tensor, dim: int, tp: int, rank: int) -> torch.Tensor:
    k = t.shape[dim] // tp
    return t.narrow(dim, rank * k, k)


def _fsdp_chunk(t: torch.Tensor, n: int, index: int) -> torch.Tensor:
    """FSDP2's dim-0 shard ``index`` of ``n`` (``torch.chunk``, empty past the end)."""
    chunks = torch.chunk(t, n, dim=0)
    return chunks[index] if index < len(chunks) else t.new_empty((0, *t.shape[1:]))


def _shard_tp_(model: nn.Module, plan: ShardingPlan, mesh) -> None:
    from lap_tpu_torch.models import gemma as _gemma
    from lap_tpu_torch.models import gemma3 as _gemma3

    if any(getattr(m, "lora_config", None) is not None for m in model.modules()):
        raise NotImplementedError("LoRA adapters under tp > 1 are not ported: train LoRA with fsdp and dp")
    tp = plan.mesh_shape[mesh_lib.TP_AXIS]
    group = mesh_lib.tp_group(mesh)
    rank = dist.get_rank(group)
    ctx = make_context(group)
    names = {id(p): n for n, p in model.named_parameters()}

    def tp_dim(param):
        return plan.placements[names[id(param)]].tp_dim

    for module in model.modules():
        if isinstance(module, _gemma.Attention):
            for n in ("qkv_einsum", "q_einsum", "attn_vec_einsum"):
                for e in getattr(module, n, ()):
                    if tp_dim(e.w) is None:
                        raise ValueError(f"tp={tp} does not divide the {n} heads {tuple(e.w.shape)}")
            for e in getattr(module, "kv_einsum", ()):
                if tp_dim(e.w) is None:
                    e.tp_grad = ctx  # MQA: one KV head, replicated
            if isinstance(module, _gemma3.Attention) and hasattr(module, "q_rmsnorm"):
                module.q_rmsnorm.tp_grad = ctx
                module.k_rmsnorm.tp_grad = ctx
        if isinstance(module, _gemma.Module):
            module.tp_group = group
        if isinstance(module, (_gemma.FeedForward, _gemma3.FeedForward)):
            for leaf in ("gating_einsum", "linear"):
                if tp_dim(getattr(module, leaf)) is None:
                    raise ValueError(f"tp={tp} does not divide the MLP hidden dim {tuple(module.linear.shape)}")
    for name, placement in plan.placements.items():
        if placement.tp_dim is None:
            continue
        owner, leaf = _owner(model, name)
        p = getattr(owner, leaf)
        local = _tp_slice(p.detach(), placement.tp_dim, tp, rank)
        setattr(owner, leaf, nn.Parameter(local if local.is_meta else local.clone(), requires_grad=p.requires_grad))


def _owner(model: nn.Module, name: str):
    prefix, _, leaf = name.rpartition(".")
    return model.get_submodule(prefix), leaf




def _shard_fsdp_(model: nn.Module, mesh) -> None:
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    data_mesh = mesh_lib.data_submesh(mesh)
    units = [*model.llm.layers, model.img, model]
    # SigLIP's output is a view (its head's reshape); nothing writes to it in
    # place (``LAP.embed_prefix`` splits and concatenates it), which is what
    # FSDP2 warns of on every call.
    warnings.filterwarnings("ignore", message=r"FSDP2-wrapped module \(FSDPSigLIP\) returned a view tensor")
    for unit in units:
        fully_shard(unit, mesh=data_mesh)
        # Each data rank's loss is its share of the global mean: sum, with
        # plain SUM collectives (gloo has no pre-multiplied sum).
        unit.set_gradient_divide_factor(1.0)
        unit.set_force_sum_reduction_for_comms(True)
    # The training step calls ``compute_loss``, not ``forward``: FSDP gathers
    # the root's shards (embedding, projections, final norms) around it.
    register_fsdp_forward_method(model, "compute_loss")


def parallelize_(model: nn.Module, mesh, plan: ShardingPlan | None = None, *,
                 sequence_parallel: bool = False) -> nn.Module:
    """Apply ``plan`` (``fsdp_sharding(model, mesh)`` when None) in place:
    tp slices when tp > 1, FSDP when the data axes hold more than one rank.
    Records ``model.parallel`` (``ModelSharding``); ``sequence_parallel`` is
    the training steps' choice (no-op without tp)."""
    plan = plan or fsdp_sharding(model, mesh)
    shape = plan.mesh_shape
    if shape[mesh_lib.TP_AXIS] > 1:
        _shard_tp_(model, plan, mesh)
    fsdp = shape[mesh_lib.BATCH_AXIS] * shape[mesh_lib.FSDP_AXIS] > 1
    if fsdp:
        _shard_fsdp_(model, mesh)
    sp = sequence_parallel and shape[mesh_lib.TP_AXIS] > 1
    model.parallel = ModelSharding(plan=plan, mesh=mesh, fsdp=fsdp, sequence_parallel=sp)
    return model


# ---------------------------------------------------------------------------
# One tensor between a rank's shard and the whole
# ---------------------------------------------------------------------------


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A rank's own part of ``t`` (a DTensor's local tensor; ``t`` itself
    otherwise). In-place updates of it update ``t``."""
    return t.to_local() if is_dtensor(t) else t


def _fsdp_shard_group(mesh):
    return mesh.get_group(mesh_lib.FSDP_AXIS)


def full_tensor(model: nn.Module, name: str, part: torch.Tensor) -> torch.Tensor:
    """The whole (unsharded) tensor of which ``part`` is this rank's shard,
    laid out as parameter ``name`` is: a collective over the parameter's
    groups, which every rank calls in the same order."""
    par: ModelSharding = model.parallel
    param = dict(model.named_parameters())[name]
    t = local(part).detach()
    shape = par.plan.mesh_shape
    if par.fsdp and shape[mesh_lib.FSDP_AXIS] > 1:
        n = shape[mesh_lib.FSDP_AXIS]
        rows = param.shape[0]
        per = -(-rows // n)
        padded = t.new_zeros((per, *t.shape[1:]))
        padded[: t.shape[0]] = t
        out = t.new_empty((n * per, *t.shape[1:]))
        _all_gather(out, padded.contiguous(), _fsdp_shard_group(par.mesh))
        t = out[:rows]
    tp_dim = par.plan.placements[name].tp_dim
    if tp_dim is not None:
        moved = t.movedim(tp_dim, 0).contiguous()
        out = moved.new_empty((shape[mesh_lib.TP_AXIS] * moved.shape[0], *moved.shape[1:]))
        _all_gather(out, moved, mesh_lib.tp_group(par.mesh))
        t = out.movedim(0, tp_dim)
    return t


def local_shard(model: nn.Module, name: str, whole: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``whole`` (laid out as parameter ``name``): its
    tp slice, then its FSDP chunk of dim 0. No collective."""
    par = getattr(model, "parallel", None)
    if par is None:
        return whole
    shape, coord = par.plan.mesh_shape, par.coord
    tp_dim = par.plan.placements[name].tp_dim
    if tp_dim is not None:
        whole = _tp_slice(whole, tp_dim, shape[mesh_lib.TP_AXIS], coord[mesh_lib.TP_AXIS])
    if par.fsdp and shape[mesh_lib.FSDP_AXIS] > 1:
        whole = _fsdp_chunk(whole, shape[mesh_lib.FSDP_AXIS], coord[mesh_lib.FSDP_AXIS])
    return whole


def counted_once(model: nn.Module, name: str) -> bool:
    """Whether this rank's shard of parameter ``name`` enters a sum over all
    ranks (a norm): replicas over tp (a weight with no tp dim) and over dp
    (HSDP) count on their first rank alone."""
    par = getattr(model, "parallel", None)
    if par is None:
        return True
    coord = par.coord
    if par.plan.placements[name].tp_dim is None and coord[mesh_lib.TP_AXIS] != 0:
        return False
    return coord[mesh_lib.BATCH_AXIS] == 0


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x, group=group)
