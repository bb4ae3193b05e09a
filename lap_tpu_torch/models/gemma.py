"""Multi-expert Gemma decoder (port of ``lap_tpu/models/gemma.py``).

The token sequence is split between experts (the PaliGemma VLM and the
action expert), each with its own weights; attention runs jointly over the
concatenated sequence. Numerics held from the JAX module: RMSNorm variance
in f32 with eps 1e-6 and a ``1 + scale`` weight, adaRMS (scale/shift/gate
from a conditioning vector), RoPE then ``q *= head_dim**-0.5`` then attention
at scale 1.0, gated residuals, the embedding scaled by ``sqrt(D)`` rounded to
the activation dtype, and a KV cache ``(idx, k, v)`` stacked over layers.

Serving: the blocks are per layer (JAX's ``scan_layers=False``), so each
layer's weights are real tensors that the dequant kernels can read.
``quantize_`` gives the Einsums, MLPs and the vocab head (``Embedder.decode``,
[V, D] relaid out to [D, V]) quantized copies (``lora.py``). Single-token AR
decode writes each layer's new K/V into the stacked cache in place, at each
batch row's own index (``update_cache``; JAX rebuilds the arrays), so a
decode step stacks nothing; the attention of a decode step is the einsum
path.

Training: ``stop_action_to_vlm_grad`` splits each layer's attention into two
calls at the expert-0 boundary, the second with detached expert-0 keys and
values (forward values unchanged); ``remat_policy="nothing_saveable"``
recomputes each block in the backward pass (``torch.utils.checkpoint``),
``"none"`` keeps its activations. Parameters may be float32 under bf16
activations: every layer casts its weights at use. Dropout is not ported (no
config reaches it, and remat replays no RNG state).

LoRA: a config's ``lora_configs`` (``"attn"``, ``"ffn"``) adapts that
expert's attention einsums and MLP (``lora.py``); the ``*_lora`` variants
adapt both, with rank = alpha (16 for gemma_2b, 32 for gemma_300m, 4 for
dummy).

Tensor and sequence parallelism (``parallel/``): a model sharded by
``parallel.sharding.parallelize_`` keeps 1/tp of the heads and MLP hidden
dims on each rank and records its tp group (``Module.tp_group``); each
attention and MLP is then one Megatron region (``parallel/tp.py``) at the
points where JAX constrains activations (``lap_tpu/models/gemma.py:346,
360, 372, 390``). Under sequence parallelism (training) an expert's stream
whose length tp divides stays token-sharded between regions, and its norms
sum their gradients over tp. Without a tp group every hook is the identity.

Parameters keep the JAX checkpoint shapes; per-expert modules sit in
``nn.ModuleList``s indexed by expert, layers in ``layers``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from lap_tpu_torch.models.lora import QUANT_MAX_ROWS, Einsum, FeedForward, LoRAConfig, QuantWeights, quant_matmul
from lap_tpu_torch.ops.attention import attention
from lap_tpu_torch.ops.rope import apply_rope
from lap_tpu_torch.parallel import mesh as _mesh
from lap_tpu_torch.parallel.tp import (
    TPContext,
    gather_tokens,
    grad_sum,
    make_context,
    region_in,
    region_out,
    split_tokens,
)

PALIGEMMA_VOCAB_SIZE = 257_152
REMAT_POLICIES = ("nothing_saveable", "none")


@dataclasses.dataclass(frozen=True)
class Config:
    width: int
    depth: int
    mlp_dim: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    lora_configs: dict[str, LoRAConfig] = dataclasses.field(default_factory=dict)


_VARIANTS = {
    "dummy": dict(width=64, depth=4, mlp_dim=128, num_heads=8, num_kv_heads=1, head_dim=16),
    "gemma_300m": dict(width=1024, depth=18, mlp_dim=4096, num_heads=8, num_kv_heads=1, head_dim=256),
    "gemma_2b": dict(width=2048, depth=18, mlp_dim=16_384, num_heads=8, num_kv_heads=1, head_dim=256),
}


# The LoRA variants: (base variant, rank = alpha), adapting attention and MLP.
_LORA_VARIANTS = {"gemma_2b_lora": ("gemma_2b", 16), "gemma_300m_lora": ("gemma_300m", 32),
                  "dummy_lora": ("dummy", 4)}


def get_config(variant: str) -> Config:
    if variant in _VARIANTS:
        return Config(**_VARIANTS[variant])
    if variant in _LORA_VARIANTS:
        base, rank = _LORA_VARIANTS[variant]
        cfg = LoRAConfig(rank=rank, alpha=float(rank))
        return Config(**_VARIANTS[base], lora_configs={"attn": cfg, "ffn": cfg})
    raise ValueError(f"Unknown gemma variant: {variant}")


class RMSNorm(nn.Module):
    """RMSNorm; adaptive (scale/shift/gate from ``cond``) when ``adaptive``.

    Returns (normed, gate or None).
    """

    def __init__(self, width: int, *, adaptive: bool = False, device=None, dtype=None):
        super().__init__()
        self.adaptive = adaptive
        if adaptive:
            # flax Dense_0 of the modulation, as torch Linear weight [3W, W] + bias.
            self.modulation_weight = nn.Parameter(torch.empty((3 * width, width), device=device, dtype=dtype))
            self.modulation_bias = nn.Parameter(torch.empty(3 * width, device=device, dtype=dtype))
        else:
            self.scale = nn.Parameter(torch.empty(width, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor, cond: torch.Tensor | None = None, grad_tp: TPContext | None = None):
        """``grad_tp``: the tp context when ``x`` holds one rank's tokens
        (sequence parallelism): the scale's (or modulation's) gradient then
        sums over tp."""
        dtype = x.dtype
        var = x.float().square().mean(dim=-1, keepdim=True)
        normed = x * torch.rsqrt(var + 1e-6)
        if not self.adaptive:
            if cond is not None:
                raise ValueError("a plain RMSNorm takes no conditioning")
            return (normed * (1 + grad_sum(self.scale, grad_tp))).to(dtype), None
        # The modulation Dense runs in the activation dtype (flax dtype=x.dtype).
        modulation = F.linear(
            cond.to(dtype), self.modulation_weight.to(dtype), self.modulation_bias.to(dtype)
        )
        scale, shift, gate = grad_sum(modulation, grad_tp)[:, None, :].chunk(3, dim=-1)
        return (normed * (1 + scale) + shift).to(dtype), gate

    def random_init_(self, gen: torch.Generator) -> None:
        if self.adaptive:
            # Small enough that 18 modulated layers keep the stream in range.
            fan_in = self.modulation_weight.shape[1]
            self.modulation_weight.normal_(0.0, 0.3 * fan_in**-0.5, generator=gen)
            self.modulation_bias.normal_(0.0, 0.02, generator=gen)
        else:
            self.scale.normal_(0.0, 0.1, generator=gen)


def tied_table_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Tied-head vocab logits ``x @ table.T`` in the dtype of ``x``: the one
    definition of the training decode head (``Embedder.decode`` and the
    chunked language CE both route here)."""
    return x @ table.to(x.dtype).T


class Embedder(QuantWeights):
    def __init__(self, vocab_size: int, embed_dim: int, *, device=None, dtype=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.input_embedding = nn.Parameter(
            torch.empty((vocab_size, embed_dim), device=device, dtype=dtype)
        )

    def quant_targets(self):
        # The vocab head of AR decode: [V, D] -> [D, V].
        return [("decode_", self.input_embedding, (1, 0), 1)]

    def encode(self, tokens: torch.Tensor) -> torch.Tensor:
        # F.embedding, not indexing: indexing's backward accumulates with
        # index_put_, which on the CPU sums repeated tokens in an order that
        # varies with the threads, so two identical steps gave different
        # table gradients; embedding's backward sums in a fixed order.
        x = F.embedding(tokens.long(), self.input_embedding)
        scale = torch.tensor(float(self.embed_dim), dtype=torch.float32).sqrt().to(x.dtype)
        return x * scale.to(x.device)

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        q = self.quantized("decode_")
        if q is not None and x[..., 0].numel() <= QUANT_MAX_ROWS:
            return quant_matmul(x, *q, (*x.shape[:-1], self.input_embedding.shape[0]))
        return tied_table_logits(x, self.input_embedding)

    def random_init_(self, gen: torch.Generator) -> None:
        self.input_embedding.normal_(0.0, 0.01, generator=gen)  # flax normal() default


def init_cache(k, v, cache_size: int, cache_dtype=None):
    """Pad fresh K/V to ``cache_size``; idx marks the filled prefix length."""
    prefill = k.shape[1]
    dtype = cache_dtype or k.dtype
    pad = (0, 0, 0, 0, 0, cache_size - prefill)
    idx = torch.full((k.shape[0],), prefill, dtype=torch.int32, device=k.device)
    return idx, F.pad(k.to(dtype), pad), F.pad(v.to(dtype), pad)


def update_cache(k, v, idx, k_cache, v_cache):
    """Write one decode step's K/V ([B, 1, K, H]) into the caches at each
    batch row's own index ``idx`` [B], in place; returns (idx + 1, k_cache,
    v_cache)."""
    if k.shape[1] != 1:
        raise ValueError("KV-cache updates must be single-token")
    index = idx.long()[:, None, None, None].expand(-1, 1, *k_cache.shape[2:])
    k_cache.scatter_(1, index, k.to(k_cache.dtype))
    v_cache.scatter_(1, index, v.to(v_cache.dtype))
    return idx + 1, k_cache, v_cache


def _expert_list(make, n: int) -> nn.ModuleList:
    return nn.ModuleList([make(i) for i in range(n)])


class Attention(nn.Module):
    """Joint attention over the concatenated expert sequences."""

    QKV_EQN = "bsd,cndh->cbsnh"
    Q_EQN = "btd,ndh->btnh"
    ATTN_VEC_EQN = "btnh,nhd->btd"

    def __init__(self, configs: Sequence[Config], *, stop_action_to_vlm_grad: bool = False,
                 cache_dtype=None, attn_impl="auto", device=None, dtype=None):
        super().__init__()
        cfg0 = configs[0]
        if not all(
            (c.head_dim, c.num_heads, c.num_kv_heads) == (cfg0.head_dim, cfg0.num_heads, cfg0.num_kv_heads)
            for c in configs
        ):
            raise ValueError("experts must share head geometry")
        self.configs = tuple(configs)
        self.stop_action_to_vlm_grad = stop_action_to_vlm_grad
        self.cache_dtype = cache_dtype
        self.attn_impl = attn_impl
        kw = dict(device=device, dtype=dtype)
        n, k, h = cfg0.num_heads, cfg0.num_kv_heads, cfg0.head_dim
        self.fused_qkv = k == n
        ne, qkv, q_eqn, vec = len(configs), self.QKV_EQN, self.Q_EQN, self.ATTN_VEC_EQN

        def einsum(i, shape, eqn, fan_in):
            return Einsum(shape, eqn, fan_in, lora_config=configs[i].lora_configs.get("attn"), **kw)

        if self.fused_qkv:
            self.qkv_einsum = _expert_list(lambda i: einsum(i, (3, n, configs[i].width, h), qkv, configs[i].width), ne)
        else:
            self.q_einsum = _expert_list(lambda i: einsum(i, (n, configs[i].width, h), q_eqn, configs[i].width), ne)
            self.kv_einsum = _expert_list(lambda i: einsum(i, (2, k, configs[i].width, h), qkv, configs[i].width), ne)
        self.attn_vec_einsum = _expert_list(lambda i: einsum(i, (n, h, configs[i].width), vec, n * h), ne)

    def forward(self, xs, positions, attn_mask, kv_cache, want_cache: bool = True):
        """Three call shapes: a fresh joint pass over the live experts
        (``kv_cache is None``: the training step with both experts, or the
        serving prefill with expert 0 alone), the cached suffix step
        (``kv_cache`` given, expert 0 absent), and single-token AR decode
        (``kv_cache`` given, expert 0 present: the cache is written in
        place)."""
        q, k, v = self._project(xs)
        q = apply_rope(q, positions)
        q = q * self.configs[0].head_dim ** -0.5
        k = apply_rope(k, positions)
        idx, k, v = self._cache(xs, k, v, attn_mask, kv_cache, want_cache)
        encoded = self._attend(xs, q, k, v, attn_mask, kv_cache)
        return self._project_out(xs, encoded), ((idx, k, v) if want_cache else None)

    def _project(self, xs):
        """q [B, T, N, H], k and v [B, T, K, H] of the live experts' tokens,
        concatenated."""
        qs, ks, vs = [], [], []
        for i, x in enumerate(xs):
            if x is None:
                continue
            if self.fused_qkv:
                q, k, v = self.qkv_einsum[i](x).unbind(0)
            else:
                q = self.q_einsum[i](x)
                k, v = self.kv_einsum[i](x).unbind(0)
            qs.append(q)
            ks.append(k)
            vs.append(v)
        return torch.cat(qs, dim=1), torch.cat(ks, dim=1), torch.cat(vs, dim=1)

    def _cache(self, xs, k, v, attn_mask, kv_cache, want_cache):
        """(idx, k, v) of the keys attention reads: the cache written in
        place (AR decode), the cached prefix then the fresh keys (suffix
        step), a new cache padded to the mask's length, or the fresh keys
        (training: idx None)."""
        if kv_cache is not None and xs[0] is not None:
            idx, k, v = update_cache(k, v, *kv_cache)
        elif kv_cache is not None:
            # Suffix step (flow-matching action expert): the fresh suffix K/V
            # follow the cached prefix.
            idx, cache_k, cache_v = kv_cache
            idx = idx + k.shape[1]
            k = torch.cat([cache_k, k.to(cache_k.dtype)], dim=1)
            v = torch.cat([cache_v, v.to(cache_v.dtype)], dim=1)
        elif want_cache:
            idx, k, v = init_cache(k, v, attn_mask.shape[-1], self.cache_dtype)
        else:
            # Training: nobody reads a cache, so none is padded or stacked.
            if attn_mask.shape[-1] != k.shape[1]:
                raise ValueError("without a cache the mask must cover exactly the fresh keys")
            idx = None
            k, v = k.to(self.cache_dtype or k.dtype), v.to(self.cache_dtype or v.dtype)
        return idx, k, v

    def _attend(self, xs, q, k, v, attn_mask, kv_cache):
        joint = xs[0] is not None and any(x is not None for x in xs[1:])
        if self.stop_action_to_vlm_grad and kv_cache is None and joint:
            # The joint training pass: queries of experts != 0 must not
            # backpropagate into expert-0 keys and values. Split the query
            # rows at the expert-0 boundary; the second call sees detached
            # expert-0 K/V. Forward values are those of one joint call. A
            # serving prefill (expert 0 alone) has no second group of rows
            # and takes the single call below.
            l0 = xs[0].shape[1]
            k_sg = torch.cat([k[:, :l0].detach(), k[:, l0:]], dim=1)
            v_sg = torch.cat([v[:, :l0].detach(), v[:, l0:]], dim=1)
            out0 = attention(q[:, :l0], k, v, attn_mask[:, :l0], scale=1.0, impl=self.attn_impl)
            out1 = attention(q[:, l0:], k_sg, v_sg, attn_mask[:, l0:], scale=1.0, impl=self.attn_impl)
            encoded = torch.cat([out0, out1], dim=1)
        else:
            encoded = attention(q, k, v, attn_mask, scale=1.0, impl=self.attn_impl)
        return encoded

    def _project_out(self, xs, encoded):
        """Each live expert's rows of ``encoded`` through its attn_vec_einsum."""
        out, start = [], 0
        for i, x in enumerate(xs):
            if x is None:
                out.append(None)
                continue
            end = start + x.shape[1]
            out.append(self.attn_vec_einsum[i](encoded[:, start:end]))
            start = end
        return out


def _sp_grad(tp: TPContext | None, i: int) -> TPContext | None:
    """The context under which expert ``i``'s norms sum their gradients: its
    stream is token-sharded (sequence parallelism)."""
    return tp if tp is not None and tp.is_sharded(i) else None


def _gated_residual(x, y, gate):
    if x is None:
        return None
    return x + y if gate is None else x + y * gate


class Block(nn.Module):
    def __init__(self, configs: Sequence[Config], use_adarms: Sequence[bool], *,
                 stop_action_to_vlm_grad: bool = False, cache_dtype=None, attn_impl="auto",
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        n = len(configs)
        self.pre_attention_norm = _expert_list(lambda i: RMSNorm(configs[i].width, adaptive=use_adarms[i], **kw), n)
        self.attn = Attention(configs, stop_action_to_vlm_grad=stop_action_to_vlm_grad,
                              cache_dtype=cache_dtype, attn_impl=attn_impl, **kw)
        self.pre_ffw_norm = _expert_list(lambda i: RMSNorm(configs[i].width, adaptive=use_adarms[i], **kw), n)
        self.mlp = _expert_list(
            lambda i: FeedForward(configs[i].width, configs[i].mlp_dim, lora_config=configs[i].lora_configs.get("ffn"),
                                  **kw), n)

    def forward(self, xs, kv_cache, positions, attn_mask, adarms_cond, want_cache: bool = True, *,
                tp: TPContext | None = None):
        """``tp``: the tensor-parallel context (``parallel/tp.py``); each
        attention and MLP is one region."""
        pre, gates = [], []
        for i, x in enumerate(xs):
            gate = None
            if x is not None:
                x, gate = self.pre_attention_norm[i](x, adarms_cond[i], _sp_grad(tp, i))
            pre.append(region_in(x, tp, i))
            gates.append(gate)
        post, kv_cache = self.attn(pre, positions, attn_mask, kv_cache, want_cache)
        post = [region_out(y, tp, i) for i, y in enumerate(post)]
        xs = [_gated_residual(x, y, g) for x, y, g in zip(xs, post, gates, strict=True)]

        outs, gates = [], []
        for i, x in enumerate(xs):
            gate = None
            if x is not None:
                x, gate = self.pre_ffw_norm[i](x, adarms_cond[i], _sp_grad(tp, i))
                x = region_out(self.mlp[i](region_in(x, tp, i)), tp, i)
            outs.append(x)
            gates.append(gate)
        xs = [_gated_residual(x, y, g) for x, y, g in zip(xs, outs, gates, strict=True)]
        return xs, kv_cache


class Module(nn.Module):
    """The multi-expert transformer: ``depth`` blocks, then per-expert final norms."""

    BLOCK = Block
    # The tp group of a tensor-parallel model (``parallel.sharding``).
    tp_group = None

    def __init__(self, configs: Sequence[Config], *, use_adarms: Sequence[bool] | None = None,
                 embed_dtype: torch.dtype = torch.bfloat16, cache_dtype=None, attn_impl: str = "auto",
                 stop_action_to_vlm_grad: bool = False, remat_policy: str = "nothing_saveable",
                 vocab_size: int = PALIGEMMA_VOCAB_SIZE, device=None, dtype=None):
        super().__init__()
        if not all(c.depth == configs[0].depth for c in configs):
            raise ValueError("experts must share depth")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, got {remat_policy!r}")
        self.configs = tuple(configs)
        self.embed_dtype = embed_dtype
        self.remat_policy = remat_policy
        use_adarms = tuple(use_adarms or [False] * len(configs))
        kw = dict(device=device, dtype=dtype)
        self.embedder = Embedder(vocab_size, configs[0].width, **kw)
        self.layers = nn.ModuleList(
            [
                self.BLOCK(configs, use_adarms, stop_action_to_vlm_grad=stop_action_to_vlm_grad,
                           cache_dtype=cache_dtype, attn_impl=attn_impl, **kw)
                for _ in range(configs[0].depth)
            ]
        )
        self.final_norm = _expert_list(
            lambda i: RMSNorm(configs[i].width, adaptive=use_adarms[i], **kw), len(configs)
        )

    def set_attn_impl(self, impl: str) -> None:
        for block in self.layers:
            block.attn.attn_impl = impl

    def quantize_(self, mode: str | None) -> None:
        """Quantized copies of the Einsum, MLP and vocab-head weights for
        decode-shaped calls (``lora.quantize_``); ``None`` removes them."""
        for m in self.modules():
            if isinstance(m, QuantWeights):
                m.quantize_(mode)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embedder.encode(tokens).to(self.embed_dtype)

    def decode_logits(self, prelogits: torch.Tensor) -> torch.Tensor:
        return self.embedder.decode(prelogits)

    def _tp_context(self, embedded, want_cache: bool) -> TPContext | None:
        """The tensor-parallel context of one call (None without tp): under
        sequence parallelism (training only) an expert's [B, T, D] stream is
        token-sharded when tp divides T (JAX's rule, ``mesh.sequence_sharded``).
        Read in the calling thread, then passed down explicitly."""
        if self.tp_group is None:
            return None
        sp = not want_cache and _mesh.sequence_parallel_enabled()
        tp = make_context(self.tp_group)
        if not sp:
            return tp
        sharded = [e is not None and _mesh.sequence_sharded(e.shape[1], tp.size) for e in embedded]
        return make_context(self.tp_group, sharded)

    def _block_kwargs(self, layer: int, **kwargs) -> dict:
        """Keyword arguments of layer ``layer``'s block beyond the shared ones."""
        if kwargs:
            raise TypeError(f"unexpected arguments {sorted(kwargs)}")
        return {}

    def forward(self, embedded, positions, mask, adarms_cond=None, *, kv_cache=None,
                want_cache: bool = True, **block_kwargs):
        """Run the stack.

        Args:
            embedded: per-expert [B, T_i, D_i] embeddings (None = skip expert).
            positions: [B, T_total] token positions.
            mask: [B, T_total, S] boolean attention mask.
            adarms_cond: per-expert [B, D_i] adaRMS conditioning, or None.
            kv_cache: stacked (idx [L, B], k [L, B, S, K, H], v) or None.
                A single-token AR step (expert 0 present) writes k and v
                in place.
            want_cache: False in training: no cache is built or stacked.
            block_kwargs: passed to ``_block_kwargs`` (Gemma3's image mask).

        Returns:
            (per-expert final-normed outputs, stacked kv_cache or None)
        """
        in_place = kv_cache is not None and embedded[0] is not None
        embedded = [None if e is None else e.to(self.embed_dtype) for e in embedded]
        if adarms_cond is None:
            adarms_cond = [None] * len(self.configs)
        tp = self._tp_context(embedded, want_cache)
        embedded = [split_tokens(e, tp, i) for i, e in enumerate(embedded)]
        remat = self.remat_policy != "none" and torch.is_grad_enabled()
        caches = []
        for i, block in enumerate(self.layers):
            layer_in = None if kv_cache is None else tuple(c[i] for c in kv_cache)
            args = (embedded, layer_in, positions, mask, adarms_cond, want_cache)
            kwargs = self._block_kwargs(i, **block_kwargs)
            if tp is not None:
                kwargs["tp"] = tp
            if remat:
                # No dropout, so there is no RNG state to replay.
                embedded, layer_out = checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False,
                                                 **kwargs)
            else:
                embedded, layer_out = block(*args, **kwargs)
            caches.append(layer_out)
        embedded = [gather_tokens(e, tp, i) for i, e in enumerate(embedded)]
        if not want_cache:
            kv_cache = None
        elif in_place:
            kv_cache = (torch.stack([c[0] for c in caches]), kv_cache[1], kv_cache[2])
        else:
            kv_cache = tuple(torch.stack(parts) for parts in zip(*caches))
        out = [
            None if e is None else norm(e, a)[0]
            for norm, e, a in zip(self.final_norm, embedded, adarms_cond, strict=True)
        ]
        return out, kv_cache
