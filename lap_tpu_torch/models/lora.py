"""Einsum and gated-GELU FeedForward layers with weight-only quantized serving
(port of ``lap_tpu/models/lora.py``; LoRA adapters are not ported).

Weights keep the JAX checkpoint shapes (``w``; ``gating_einsum`` [2, D, F],
``linear`` [F, D]). ``quantize_("int8" | "int4")`` adds quantized copies of
every weight of at least ``QUANT_MIN_WEIGHT_ELEMS`` elements as buffers named
as the JAX package names its "quant" variables (``w_i8``/``w_i4`` and
``scale``; ``gating_w_*``, ``linear_w_*``), relaid out to ``[K, N]`` as JAX's
``w_perm`` does: the contraction axes in the weight's order, then the output
axes (gating ``[2, D, F]`` becomes ``[D, 2F]`` with column ``g * F + f``).
int4 is group-wise (the largest of ``INT4_GROUP_CANDIDATES`` that divides
K/2) and falls back to int8 for a K that fits no group. Calls of at most
``QUANT_MAX_ROWS`` rows go through the dequant matmuls; more rows, and every
weight without a copy, keep the exact product in the activation dtype. The
bf16 weights stay: the prefill needs them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from lap_tpu_torch.ops import int4_matmul as _int4
from lap_tpu_torch.ops import int8_matmul as _int8

# Rows up to which a call takes the dequant matmul (decode: 1 AR token per
# request, or 16 flow-suffix rows); prefill calls of hundreds of rows keep
# the exact product.
QUANT_MAX_ROWS = 128
# Weights below this element count are not quantized (the JAX package's
# threshold: gemma_2b's q/attn_vec/MLP/vocab weights and the 300m expert's
# MLP qualify; kv_einsum and the expert's attention projections do not).
QUANT_MIN_WEIGHT_ELEMS = 4 * 2**20
# int4 group sizes (contraction rows per scale), largest first.
INT4_GROUP_CANDIDATES = (256, 128, 64, 32)
QUANT_MODES = ("int8", "int4")


def _int4_group(k: int) -> int | None:
    for g in INT4_GROUP_CANDIDATES:
        if k % (2 * g) == 0:
            return g
    return None


def _plan_quant_einsum(eqn: str):
    """Decompose ``einsum(eqn, x, w)`` into a ``[M, K] @ [K, N]`` matmul.

    Returns (x_batch, contract, w_out, w_perm, out_perm): ``w_perm``
    transposes w to (contract..., out...) and ``out_perm`` the reshaped
    [*x_batch, *w_out] result into the equation's output order. x's axes
    must be (batch..., contract...).
    """
    lhs, out_spec = eqn.split("->")
    x_spec, w_spec = lhs.split(",")
    contract = [a for a in w_spec if a in x_spec]
    w_out = [a for a in w_spec if a not in x_spec]
    x_batch = [a for a in x_spec if a not in w_spec]
    if list(x_spec) != x_batch + contract:
        raise ValueError(f"x axes not (batch..., contract...) in {eqn!r}")
    natural = x_batch + w_out
    if sorted(out_spec) != sorted(natural) or len(out_spec) != len(natural):
        raise ValueError(f"unsupported output spec in {eqn!r}")
    w_perm = tuple(w_spec.index(a) for a in contract + w_out)
    out_perm = tuple(natural.index(a) for a in out_spec)
    return x_batch, contract, w_out, w_perm, out_perm


def _kn(shape, w_perm, n_contract: int) -> tuple[int, int]:
    k = math.prod(shape[p] for p in w_perm[:n_contract])
    return k, math.prod(shape[p] for p in w_perm[n_contract:])


def _quant_pair(w_raw: torch.Tensor, w_perm, n_contract: int, mode: str):
    """One-time relayout + quantization: int8 per output channel, or int4
    group-wise (int8 when K fits no group)."""
    k, n = _kn(w_raw.shape, w_perm, n_contract)
    wt = w_raw.permute(*w_perm).reshape(k, n).contiguous()
    if mode == "int4":
        g = _int4_group(k)
        if g is not None:
            return _int4.quantize_int4(wt, group_size=g)
    return _int8.quantize_int8(wt, axis=0)


def quant_enabled(quant: str | None, n_weight_elems: int) -> bool:
    """Whether a weight of this size is quantized in mode ``quant``."""
    if quant is None:
        return False
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quant mode: {quant}")
    return n_weight_elems >= QUANT_MIN_WEIGHT_ELEMS


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, out_shape) -> torch.Tensor:
    """Flatten x to [M, K], run the dequant matmul, reshape to ``out_shape``.
    The packing follows from the scale's rank: int4 group scales are
    [K/G, N], int8 per-channel scales [N]."""
    if scale.dim() == 2:
        y = _int4.int4_matmul(x.reshape(-1, 2 * w_q.shape[0]), w_q, scale)
    else:
        y = _int8.int8_matmul(x.reshape(-1, w_q.shape[0]), w_q, scale)
    return y.reshape(out_shape)


def _rows(x: torch.Tensor, n_batch: int) -> int:
    return math.prod(x.shape[:n_batch])


class QuantWeights(nn.Module):
    """A module whose large weights may carry quantized copies as buffers.

    Subclasses list their weights in ``quant_targets``: (buffer prefix,
    weight, w_perm, number of contraction axes).
    """

    def quant_targets(self) -> list[tuple[str, torch.Tensor, tuple[int, ...], int]]:
        raise NotImplementedError

    def quant_spec(self, mode: str) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """Name -> (shape, dtype) of every buffer ``quantize_(mode)`` makes."""
        spec = {}
        for prefix, w, w_perm, n_contract in self.quant_targets():
            if not quant_enabled(mode, w.numel()):
                continue
            k, n = _kn(w.shape, w_perm, n_contract)
            g = _int4_group(k) if mode == "int4" else None
            if g is None:
                spec[f"{prefix}w_i8"] = ((k, n), torch.int8)
                spec[f"{prefix}scale"] = ((n,), torch.float32)
            else:
                spec[f"{prefix}w_i4"] = ((k // 2, n), torch.int8)
                spec[f"{prefix}scale"] = ((k // g, n), torch.float32)
        return spec

    def clear_quant_(self) -> None:
        for prefix, *_ in self.quant_targets():
            for name in ("w_i8", "w_i4", "scale"):
                self._buffers.pop(prefix + name, None)

    @torch.no_grad()
    def quantize_(self, mode: str | None) -> None:
        """Build the quantized copies from the current weights (``None``:
        remove them)."""
        self.clear_quant_()
        for prefix, w, w_perm, n_contract in self.quant_targets():
            if quant_enabled(mode, w.numel()):
                w_q, scale = _quant_pair(w, w_perm, n_contract, mode)
                self.register_buffer(prefix + ("w_i4" if scale.dim() == 2 else "w_i8"), w_q)
                self.register_buffer(prefix + "scale", scale)

    def quantized(self, prefix: str = "") -> tuple[torch.Tensor, torch.Tensor] | None:
        """(w_q, scale) of the weight under ``prefix``, or None."""
        scale = self._buffers.get(prefix + "scale")
        if scale is None:
            return None
        w_q = self._buffers.get(prefix + "w_i4")
        return (self._buffers[prefix + "w_i8"] if w_q is None else w_q), scale


class Einsum(QuantWeights):
    """y = einsum(eqn, x, w), computed in the dtype of ``x``.

    ``fan_in`` is the size of the contracted weight axes (for random init).
    """

    def __init__(self, shape: tuple[int, ...], eqn: str, fan_in: int, *, device=None, dtype=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(shape, device=device, dtype=dtype))
        self.eqn = eqn
        self.plan = _plan_quant_einsum(eqn)
        self.fan_in = fan_in

    def quant_targets(self):
        _, contract, _, w_perm, _ = self.plan
        return [("", self.w, w_perm, len(contract))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.quantized()
        x_batch, contract, _, w_perm, out_perm = self.plan
        if q is not None and _rows(x, len(x_batch)) <= QUANT_MAX_ROWS:
            out_dims = tuple(x.shape[: len(x_batch)]) + tuple(self.w.shape[p] for p in w_perm[len(contract):])
            return quant_matmul(x, *q, out_dims).permute(*out_perm)
        return torch.einsum(self.eqn, x, self.w.to(x.dtype))

    def random_init_(self, gen: torch.Generator) -> None:
        self.w.normal_(0.0, self.fan_in**-0.5, generator=gen)


class FeedForward(QuantWeights):
    """Gemma gated-GELU MLP: (gelu_tanh(x @ w0) * (x @ w1)) @ w2."""

    def __init__(self, features: int, hidden_dim: int, *, device=None, dtype=None):
        super().__init__()
        self.gating_einsum = nn.Parameter(
            torch.empty((2, features, hidden_dim), device=device, dtype=dtype)
        )
        self.linear = nn.Parameter(torch.empty((hidden_dim, features), device=device, dtype=dtype))

    def quant_targets(self):
        # [2, D, F] -> [D, 2F]: both projections stream in one matmul.
        return [("gating_", self.gating_einsum, (1, 0, 2), 1), ("linear_", self.linear, (0, 1), 1)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows_ok = _rows(x, x.dim() - 1) <= QUANT_MAX_ROWS
        gating = self.quantized("gating_")
        if gating is not None and rows_ok:
            gates = quant_matmul(x, *gating, (*x.shape[:-1], 2, self.gating_einsum.shape[-1]))
            gate_pre, up = gates[..., 0, :], gates[..., 1, :]
        else:
            w = self.gating_einsum.to(x.dtype)
            gate_pre, up = x @ w[0], x @ w[1]
        act = F.gelu(gate_pre, approximate="tanh") * up
        linear = self.quantized("linear_")
        if linear is not None and rows_ok:
            return quant_matmul(act, *linear, (*x.shape[:-1], self.linear.shape[-1]))
        return act @ self.linear.to(x.dtype)

    def random_init_(self, gen: torch.Generator) -> None:
        self.gating_einsum.normal_(0.0, self.gating_einsum.shape[1] ** -0.5, generator=gen)
        self.linear.normal_(0.0, self.linear.shape[0] ** -0.5, generator=gen)
