"""Tensor- and sequence-parallel regions of a Gemma block (Megatron's
collectives, written where the JAX package calls
``activation_sharding_constraint``: ``lap_tpu/models/gemma.py:346,360,372,
390``, ``gemma3.py:320,328,345,367``).

Under tp each rank holds 1/tp of the attention heads and of the MLP hidden
dim (``sharding.py``). A region runs from a column-parallel projection
(q/kv, MLP gate/up) to a row-parallel one (attention out, MLP down):

- ``region_in``: identity forward, all-reduce backward (the partial input
  gradients of each rank's heads sum); under sp an all-gather of the tokens
  forward, a reduce-scatter backward.
- ``region_out``: all-reduce forward (the per-rank partial products sum),
  identity backward; under sp a reduce-scatter of the tokens forward, an
  all-gather backward. The sum of the partial products (bf16 in a bf16
  stream, as JAX's) runs in f32 and is rounded once to their dtype.
- ``grad_sum``: identity forward, all-reduce backward, for a tensor that is
  replicated over tp but used by one rank's part of the work: the MQA
  ``kv_einsum`` (one KV head cannot split; each rank's copy receives the
  gradient of its query heads), Gemma3's q/k norms, and under sp the norm
  scales and adaRMS modulation applied to one rank's tokens.
- ``split_tokens``/``gather_tokens``: the residual stream enters the stack
  token-sharded under sp and leaves it whole.

A ``TPContext`` carries the group and, per expert, whether its residual
stream is token-sharded; the stack builds it once in the calling thread and
passes it down, so a checkpointed block recomputes with the same regions on
the autograd thread. Without a context every function is the identity.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TPContext:
    group: object
    size: int
    rank: int
    sharded: tuple[bool, ...] = ()

    def is_sharded(self, i: int) -> bool:
        return i < len(self.sharded) and self.sharded[i]


def make_context(group, sharded=()) -> TPContext | None:
    """A context over ``group`` (None: no tp, and no context)."""
    if group is None:
        return None
    return TPContext(group, dist.get_world_size(group), dist.get_rank(group), tuple(sharded))


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``, in f32."""
    out = x.to(torch.float32).contiguous()
    dist.all_reduce(out, group=group)
    return out


def _gather_dim1(x: torch.Tensor, ctx: TPContext) -> torch.Tensor:
    """[B, t, ...] -> [B, tp * t, ...], rank-major along dim 1."""
    moved = x.transpose(0, 1).contiguous()
    out = moved.new_empty((ctx.size * moved.shape[0], *moved.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)  # renamed all_gather_single in later releases
        dist.all_gather_into_tensor(out, moved, group=ctx.group)
    return out.transpose(0, 1)


def _reduce_scatter_dim1(x: torch.Tensor, ctx: TPContext) -> torch.Tensor:
    """[B, T, ...] summed over the group -> this rank's [B, T / tp, ...], in f32."""
    moved = x.to(torch.float32).transpose(0, 1).contiguous()
    out = moved.new_empty((moved.shape[0] // ctx.size, *moved.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, moved, group=ctx.group)
    return out.transpose(0, 1)


def _local_dim1(x: torch.Tensor, ctx: TPContext) -> torch.Tensor:
    t = x.shape[1] // ctx.size
    return x[:, ctx.rank * t:(ctx.rank + 1) * t]


class _GradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.tp.group).to(grad.dtype), None


class _Sum(torch.autograd.Function):
    """All-reduce (in f32, back to the input's dtype); the identity backward."""

    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp.group).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherTokens(torch.autograd.Function):
    """All-gather over tokens; reduce-scatter backward (region_in under sp)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _gather_dim1(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_dim1(grad, ctx.tp).to(grad.dtype), None


class _ScatterTokens(torch.autograd.Function):
    """Reduce-scatter over tokens (in f32, back to the input's dtype);
    all-gather backward (region_out under sp)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _reduce_scatter_dim1(x, tp).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return _gather_dim1(grad, ctx.tp), None


class _SplitTokens(torch.autograd.Function):
    """This rank's tokens of a replicated tensor; all-gather backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _local_dim1(x, tp).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather_dim1(grad, ctx.tp), None


class _WholeTokens(torch.autograd.Function):
    """All-gather of a token-sharded tensor that every rank then uses whole;
    backward keeps this rank's rows of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _gather_dim1(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _local_dim1(grad, ctx.tp).contiguous(), None


def grad_sum(x, tp: TPContext | None):
    if tp is None or x is None:
        return x
    return _GradSum.apply(x, tp)


def region_in(x, tp: TPContext | None, i: int):
    if tp is None or x is None:
        return x
    return _GatherTokens.apply(x, tp) if tp.is_sharded(i) else _GradSum.apply(x, tp)


def region_out(y, tp: TPContext | None, i: int):
    """The sum of the ranks' partial products ``y``."""
    if tp is None or y is None:
        return y
    return _ScatterTokens.apply(y, tp) if tp.is_sharded(i) else _Sum.apply(y, tp)


def split_tokens(x, tp: TPContext | None, i: int):
    if tp is None or x is None or not tp.is_sharded(i):
        return x
    return _SplitTokens.apply(x, tp)


def gather_tokens(x, tp: TPContext | None, i: int):
    if tp is None or x is None or not tp.is_sharded(i):
        return x
    return _WholeTokens.apply(x, tp)
