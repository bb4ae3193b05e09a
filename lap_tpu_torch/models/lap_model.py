"""LAP flow-matching and language-action policy model (port of
``lap_tpu/models/lap_model.py``).

SigLIP + a two-expert Gemma (the VLM and the action expert) with pi0.5
adaRMS time conditioning (``pi05``), or the pi0 branch (``pi05=False``): a
state token from ``state_proj`` that opens its own AR segment before the
action tokens, ``[action tokens, time embedding]`` through
``action_time_mlp_in`` (swish) and ``action_time_mlp_out`` (none), and no
adaRMS, so both experts take the plain RMSNorm. With
``enable_action_training=False`` (the VLM-only, vla0 model) there is one
expert and no action projection: the loss is the language loss alone, AR
decode serves it, and ``sample_actions`` refuses it (there is no action
expert to call); ``pi05`` changes nothing there, as JAX's one-expert module
never gets a conditioning vector. ``use_bimanual`` adds the right wrist
camera; ``scan_layers`` and ``scan_unroll`` are accepted for JAX's command
lines and change nothing (the layers are always per layer). Ported:
inference by flow matching
(``embed_prefix``, ``embed_suffix``, ``sample_actions``: prefix prefill, then
Euler steps of the action expert against the KV cache), autoregressive
language-action decode (``sample_tokens``: the prefix right-aligned by
``left_to_right_align``, one prefill of the VLM, then single-token steps
against the cache, greedy or by temperature), quantized serving
(``quantize_``: int8/int4 copies of the decode weights beside the bf16 ones,
used by calls of at most ``lora.QUANT_MAX_ROWS`` rows), the training loss
(``compute_loss``: one joint pass of both experts, the shifted language CE
over the language-action tokens plus the flow-matching MSE, with the VQA /
prediction / sample-mask mixing), and the freeze filters.

Numerics held from JAX: ``action_in_proj``, the time MLP and
``action_out_proj`` are flax ``Dense`` layers without ``dtype``, so they
compute in the promoted type, f32 on f32 inputs even with bf16 weights; the
Euler loop accumulates time in f32; the CE takes its log-softmax in f32 and
the action loss is f32. Where JAX draws from split keys (flow noise and time,
augmentation, AR sampling), the values are arguments, drawn from a
``torch.Generator`` when not given. Temperature sampling takes the argmax of
``logits / T`` plus Gumbel noise, as ``jax.random.categorical`` does, from
the generator's own bits. Rows that emitted EOS write 0; with
``stop_on_eos`` the loop ends once every row has, which the host reads once
per token (one device sync per decode step).

Data parallelism (one process a data rank, ``parallel/``): under a mesh
whose data axes hold more than one rank, ``compute_loss`` returns this
rank's share of the global batch's loss (its sums over the global counts,
``mesh.batch_mean``/``batch_count``), so the shares and their gradients sum
to one process's; its metrics stay the rank's own. ``loss_randomness``
draws what ``compute_loss`` would draw, in its order, for any batch size:
a sharded step draws for the global batch and takes its rows. JAX's
activation constraints at ``lap_model.py:263-274,315`` pin the batch dim,
which here each rank holds whole: nothing to do there.
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from lap_tpu_torch.device import resolve_device
from lap_tpu_torch.models import gemma as _gemma
from lap_tpu_torch.models import metrics as _metrics
from lap_tpu_torch.models import siglip as _siglip
from lap_tpu_torch.models.init import random_init_
from lap_tpu_torch.models.preprocessing import AugmentParams, preprocess_observation
from lap_tpu_torch.models.types import IMAGE_KEYS, IMAGE_RESOLUTION, CoTObservation, fake_obs
from lap_tpu_torch.ops.masks import make_attn_mask
from lap_tpu_torch.parallel.mesh import batch_count, batch_mean

# Ids of the VQA datasets in the order the JAX package's data registry
# registers them (0 is reserved for "not a VQA sample").
VQA_DATASET_ID_MAP = {
    "coco_captions": 1,
    "vqa": 2,
    "lvis": 3,
    "paco_lvis": 4,
    "paco_ego4d": 5,
    "pixmo_cap": 6,
    "pixmo_point": 7,
}


@dataclasses.dataclass(frozen=True)
class LAPConfig:
    """The fields of the JAX package's LAPConfig that the ported paths read."""

    dtype: str = "bfloat16"
    paligemma_variant: str = "gemma_2b"
    action_expert_variant: str = "gemma_300m"
    siglip_variant: str = "So400m/14"

    action_dim: int = 7
    action_horizon: int = 16
    max_token_len: int = 220

    verbose_mode: bool = False
    pi05: bool = True
    # Read by the host transforms (tokenizer and prompt), not by the model.
    discrete_state_input: bool = True
    prompt_format: str = "lap"
    prediction_format: str = "default"
    use_fast: bool = False

    aug_wrist_image: bool = True
    enable_image_augmentation: bool = True
    use_bimanual: bool = False

    enable_action_training: bool = False
    enable_langact_training: bool = True
    enable_prediction_training: bool = False
    enable_vqa_training: bool = False
    language_loss_weight: float = 1.0
    action_loss_weight: float = 1.0
    prediction_loss_weight: float = 1.0
    vqa_loss_weight: float = 0.1
    vqa_loss_weights: dict | None = None

    state_dropout: float = 0.0
    reasoning_mask_prob: float = 0.0
    stop_action_to_vlm_grad: bool = False

    # Attention implementation ("auto" / "flash" / "xla").
    attn_impl: str = "auto"
    # JAX's layer-scan knobs: the port's layers are always per layer, so
    # both are accepted and change no numerics.
    scan_unroll: int = 1
    # Block rematerialisation in training ("nothing_saveable" / "none").
    remat_policy: str = "nothing_saveable"
    scan_layers: bool = True
    image_resolution: tuple[int, int] = IMAGE_RESOLUTION
    # Weight-only quantized serving ("int8" / "int4" / None): a model built
    # with random weights quantizes at once; one built empty for a weight
    # load quantizes with ``LAP.quantize_`` after it.
    quant: str | None = None

    @property
    def image_keys(self) -> tuple[str, ...]:
        if self.use_bimanual:
            return ("base_0_rgb", "left_wrist_0_rgb", "right_wrist_0_rgb")
        return IMAGE_KEYS

    @property
    def model_type(self) -> str:
        return "lap_fast" if self.use_fast else "lap"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def backbone_depth(self) -> int:
        """Layer count of the VLM backbone."""
        if "gemma3" in self.paligemma_variant:
            from lap_tpu_torch.models import gemma3 as _gemma3

            return _gemma3.get_config(self.paligemma_variant).num_layers
        return _gemma.get_config(self.paligemma_variant).depth

    def create_module(self, **kwargs) -> "LAP":
        """The model class of this config (``LAPGemma3`` for a gemma3 VLM),
        built with ``kwargs`` (``device``, ``init_seed``, ``param_dtype``)."""
        if "gemma3" in self.paligemma_variant:
            from lap_tpu_torch.models.lap_gemma3 import LAPGemma3

            return LAPGemma3(self, **kwargs)
        return LAP(self, **kwargs)

    def fake_obs(self, batch_size: int = 1, device=None) -> CoTObservation:
        return fake_obs(
            batch_size=batch_size,
            image_keys=self.image_keys,
            action_dim=self.action_dim,
            max_token_len=self.max_token_len,
            resolution=self.image_resolution,
            device=device,
        )


def posemb_sincos(pos: torch.Tensor, embedding_dim: int, min_period: float, max_period: float):
    """Sine-cosine time embedding in f32 (openpi pi0 semantics)."""
    if embedding_dim % 2 != 0:
        raise ValueError("embedding_dim must be even")
    fraction = torch.linspace(0.0, 1.0, embedding_dim // 2, dtype=torch.float32, device=pos.device)
    period = min_period * (max_period / min_period) ** fraction
    angles = pos.to(torch.float32)[:, None] * (1.0 / period * 2 * math.pi)[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def left_to_right_align(x, input_mask, attn_mask):
    """Right-align the valid tokens (padding moves to the left); the valid
    tokens must be left-aligned. Padded keys and queries stay masked."""
    size = x.shape[1]
    shift = size - input_mask.sum(dim=1)
    idx = (torch.arange(size, device=x.device)[None, :] - shift[:, None]) % size
    b = x.shape[0]
    x_al = torch.gather(x, 1, idx[..., None].expand(b, size, x.shape[-1]))
    mask_al = torch.gather(input_mask, 1, idx)
    attn_al = torch.gather(attn_mask, 1, idx[:, :, None].expand(b, size, attn_mask.shape[-1]))
    attn_al = torch.gather(attn_al, 2, idx[:, None, :].expand(b, size, size))
    attn_al = attn_al & mask_al[:, None, :] & mask_al[:, :, None]
    return x_al, mask_al, attn_al


def put_along_last_axis(arr, idx, vals):
    """Write ``vals`` into ``arr`` at last-axis positions ``idx``."""
    iota = torch.arange(arr.shape[-1], device=arr.device)
    return torch.where(iota == idx, vals.to(arr.dtype), arr)


@dataclasses.dataclass
class ARState:
    """The state of one AR decode between steps: the stacked KV cache, the
    logits of the last position [B, 1, V], and where each row's prefix lies
    in the right-aligned prefill."""

    kv_cache: tuple
    logits: torch.Tensor
    prefill_len: torch.Tensor
    prefix_start: torch.Tensor
    prefill_size: int
    step: int = 0


def _pick_token(logits: torch.Tensor, temperature: float, generator: torch.Generator | None) -> torch.Tensor:
    """[B, 1] int32: argmax, or a categorical draw at ``temperature``."""
    if temperature > 0.0:
        gumbel = -torch.empty(logits.shape, device=logits.device).exponential_(generator=generator).log()
        return (logits.float() / max(temperature, 1e-6) + gumbel).argmax(dim=-1).to(torch.int32)
    return logits.argmax(dim=-1).to(torch.int32)


def _dense_promoted(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A flax ``Dense`` without ``dtype``: computes in the promoted type."""
    dtype = torch.promote_types(x.dtype, layer.weight.dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class LAP(nn.Module):
    """Flow-matching action policy on a two-expert Gemma (one expert, the
    VLM, without ``enable_action_training``).

    Parameters are created on ``device`` (``cuda`` unless given) in
    ``param_dtype`` (the config's dtype unless given; training keeps float32
    parameters under bf16 activations). With ``init_seed`` they are filled
    with seeded random values (every one non-zero); with ``init_seed=None``
    they are left uninitialised for ``convert.load_jax_params``.
    """

    # Token-chunk size of the language CE: above this many positions the
    # [B, T, V] logits are never materialised; the vocab projection, the
    # logsumexp and the label gather run per chunk and are recomputed in the
    # backward pass.
    CE_CHUNK: int = 256
    EOS_TOKEN: int = 1

    def __init__(self, config: LAPConfig, *, device=None, init_seed: int | None = 0,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        with torch.device("meta"):
            kw = dict(dtype=param_dtype or config.torch_dtype)
            self._action_width = width = self._build(config, kw)
            if config.enable_action_training:
                self.action_in_proj = nn.Linear(config.action_dim, width, **kw)
                if config.pi05:
                    self.time_mlp_in = nn.Linear(width, width, **kw)
                    self.time_mlp_out = nn.Linear(width, width, **kw)
                else:
                    self.state_proj = nn.Linear(config.action_dim, width, **kw)
                    self.action_time_mlp_in = nn.Linear(2 * width, width, **kw)
                    self.action_time_mlp_out = nn.Linear(width, width, **kw)
                self.action_out_proj = nn.Linear(width, config.action_dim, **kw)
        self.to_empty(device=device)
        if init_seed is not None:
            random_init_(self, init_seed)
            if config.quant is not None:
                self.quantize_(config.quant)

    @staticmethod
    def _experts(config: LAPConfig, get_config) -> tuple[list, list[bool], int | None]:
        """The backbone's expert configs, which of them take adaRMS, and the
        action expert's width (None without one)."""
        pali = get_config(config.paligemma_variant)
        if not config.enable_action_training:
            return [pali], [False], None
        action = get_config(config.action_expert_variant)
        return [pali, action], [False, config.pi05], action.width

    def _build(self, config: LAPConfig, kw: dict) -> int | None:
        """Build ``img`` and ``llm`` (on the meta device); returns the action
        expert's width (None without one)."""
        dtype = config.torch_dtype
        experts, adarms, width = self._experts(config, _gemma.get_config)
        pali = experts[0]
        self.img = _siglip.SigLIP(
            _siglip.get_config(config.siglip_variant, head_dim_out=pali.width),
            image_size=config.image_resolution,
            attn_impl=config.attn_impl,
            compute_dtype=dtype,
            **kw,
        )
        self.llm = _gemma.Module(
            experts,
            use_adarms=adarms,
            embed_dtype=dtype,
            cache_dtype=dtype,
            attn_impl=config.attn_impl,
            stop_action_to_vlm_grad=config.stop_action_to_vlm_grad,
            remat_policy=config.remat_policy,
            **kw,
        )
        return width

    @property
    def device(self) -> torch.device:
        return self.llm.embedder.input_embedding.device

    @property
    def num_experts(self) -> int:
        return len(self.llm.configs)

    def _experts_input(self, first):
        """The backbone's per-expert list with ``first`` for expert 0."""
        return [first] + [None] * (self.num_experts - 1)

    def set_attn_impl(self, impl: str) -> None:
        self.img.set_attn_impl(impl)
        self.llm.set_attn_impl(impl)

    def quantize_(self, mode: str | None) -> None:
        """int8/int4 copies of the decode weights from the current (bf16)
        weights, which stay for the prefill; ``None`` removes the copies.
        The counterpart of the JAX package's "quant" collection."""
        self.llm.quantize_(mode)

    # ------------------------------------------------------------------

    def embed_prefix(self, obs: CoTObservation):
        """Image tokens (all cameras in one ViT pass) + prompt embeddings."""
        names = list(obs.images.keys())
        b = obs.state.shape[0]
        stacked = torch.cat([obs.images[n] for n in names], dim=0)
        per_cam = self.img(stacked).split(b, dim=0)

        tokens, input_mask, ar_mask = [], [], []
        for name, img_tokens in zip(names, per_cam, strict=True):
            s = img_tokens.shape[1]
            tokens.append(img_tokens)
            input_mask.append(obs.image_masks[name][:, None].expand(b, s))
            ar_mask.append(torch.zeros((b, s), dtype=torch.bool, device=stacked.device))

        tokens.append(self.llm.embed(obs.tokenized_prompt))
        input_mask.append(obs.tokenized_prompt_mask.to(torch.bool))
        if obs.tokenized_langact_mask is not None:
            ar_mask.append(obs.tokenized_langact_mask.to(torch.bool))
        else:
            ar_mask.append(torch.zeros(obs.tokenized_prompt.shape, dtype=torch.bool, device=stacked.device))
        return torch.cat(tokens, dim=1), torch.cat(input_mask, dim=1), torch.cat(ar_mask, dim=1)

    def _prefix_inputs(self, obs: CoTObservation):
        """(tokens, input mask, ar mask, extra keyword arguments of the
        backbone's prefix call) of the prefix."""
        return (*self.embed_prefix(obs), {})

    def _embed_prefix_for_loss(self, obs: CoTObservation, suffix: dict):
        """``_prefix_inputs`` for ``compute_loss``, whose backbone call also
        holds the ``suffix`` tokens (JAX's hook of the same name)."""
        del suffix
        return self._prefix_inputs(obs)

    @staticmethod
    def _right_align(tokens, input_mask, attn_mask, extra: dict):
        """The AR prefill's right alignment of the prefix and its extra
        backbone arguments."""
        return (*left_to_right_align(tokens, input_mask, attn_mask), extra)

    def embed_suffix(self, obs: CoTObservation, noisy_actions: torch.Tensor, timestep: torch.Tensor):
        """Action-expert tokens and the adaRMS time conditioning (pi0.5), or
        the state token and the time-mixed action tokens (pi0, no
        conditioning): (tokens, input mask, AR flags [S], cond or None)."""
        cfg = self.config
        action_tokens = _dense_promoted(self.action_in_proj, noisy_actions)
        time_emb = posemb_sincos(timestep, self._action_width, min_period=4e-3, max_period=4.0)
        # The first action token starts a new AR segment; the chunk is
        # bidirectional within itself.
        flags = [True] + [False] * (cfg.action_horizon - 1)
        if cfg.pi05:
            y = F.silu(_dense_promoted(self.time_mlp_in, time_emb))
            adarms_cond = F.silu(_dense_promoted(self.time_mlp_out, y))
            tokens = action_tokens
        else:
            # The state token opens its own segment before the actions.
            state_token = _dense_promoted(self.state_proj, obs.state)[:, None, :]
            time_tokens = time_emb[:, None, :].expand(-1, cfg.action_horizon, -1)
            y = torch.cat([action_tokens, time_tokens.to(action_tokens.dtype)], dim=-1)
            y = F.silu(_dense_promoted(self.action_time_mlp_in, y))
            expert_tokens = _dense_promoted(self.action_time_mlp_out, y)
            tokens = torch.cat([state_token.to(expert_tokens.dtype), expert_tokens], dim=1)
            adarms_cond = None
            flags = [True] + flags
        input_mask = torch.ones(tokens.shape[:2], dtype=torch.bool, device=tokens.device)
        ar = torch.tensor(flags, dtype=torch.bool, device=tokens.device)
        return tokens, input_mask, ar, adarms_cond

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def loss_randomness(self, batch_size: int, generator: torch.Generator, *, train: bool = True) -> dict:
        """What ``compute_loss`` draws from ``generator`` for a batch of
        ``batch_size``, in its order: each augmented camera's
        ``AugmentParams``, then the flow noise and time. A data-parallel step
        draws them for the global batch and gives each rank its rows."""
        cfg, device = self.config, self.device
        out = {}
        if train and cfg.enable_image_augmentation:
            out["aug_params"] = {
                key: AugmentParams.draw(batch_size, *cfg.image_resolution, generator=generator, device=device)
                for key in cfg.image_keys
                if cfg.aug_wrist_image or "wrist" not in key
            }
        if cfg.enable_action_training:
            shape = (batch_size, cfg.action_horizon, cfg.action_dim)
            out["noise"] = torch.randn(shape, generator=generator, device=device)
            u = torch.rand((batch_size,), generator=generator, device=device)
            out["time"] = u ** (1.0 / 1.5) * 0.999 + 0.001
        return out

    def prepare_suffix(self, obs: CoTObservation, actions, *, noise=None, time=None,
                       generator: torch.Generator | None = None):
        """Flow-matching corruption: ``x_t = t*noise + (1-t)*a``, target
        ``u_t = noise - a``, ``t ~ Beta(1.5, 1)`` by inverse CDF, scaled to
        [0.001, 1]. ``noise`` and ``time`` are drawn from ``generator`` when
        not given."""
        actions = actions.to(torch.float32)
        if noise is None:
            noise = torch.randn(actions.shape, generator=generator, device=actions.device)
        if time is None:
            u = torch.rand(actions.shape[:-2], generator=generator, device=actions.device)
            time = u ** (1.0 / 1.5) * 0.999 + 0.001
        noise = noise.to(device=actions.device, dtype=torch.float32)
        time = time.to(device=actions.device, dtype=torch.float32)
        t = time[..., None, None]
        x_t = t * noise + (1 - t) * actions
        u_t = noise - actions
        suffix_tokens, suffix_mask, suffix_ar, adarms_cond = self.embed_suffix(obs, x_t, time)
        return dict(
            suffix_tokens=suffix_tokens,
            suffix_mask=suffix_mask,
            suffix_ar_mask=suffix_ar[None, :].expand_as(suffix_mask),
            adarms_cond=adarms_cond,
            u_t=u_t,
        )

    def _build_prefix_action_mask(self, prefix_mask, obs):
        """Prefix keys visible to action tokens: images + prompt, not langact."""
        if obs.tokenized_langact_mask is None:
            return prefix_mask
        img_len = prefix_mask.shape[1] - obs.tokenized_langact_mask.shape[1]
        langact_full = F.pad(obs.tokenized_langact_mask.to(torch.bool), (img_len, 0))
        return prefix_mask & ~langact_full

    def _build_combined_attention_mask(self, prefix_mask, prefix_ar_mask, prefix_mask_action,
                                       suffix_mask, suffix_ar_mask):
        prefix_attn = make_attn_mask(prefix_mask, prefix_ar_mask)
        if suffix_mask is None:
            return prefix_attn
        p, s = prefix_mask.shape[1], suffix_mask.shape[1]
        input_mask = torch.cat([prefix_mask_action, suffix_mask], dim=1)
        ar_mask = torch.cat([torch.zeros_like(prefix_mask_action), suffix_ar_mask], dim=1)
        action_rows = make_attn_mask(input_mask, ar_mask)[:, p:, :]
        prefix_rows = F.pad(prefix_attn, (0, s))
        return torch.cat([prefix_rows, action_rows], dim=1)

    def _build_combined_positions(self, prefix_mask, prefix_mask_action, suffix_mask):
        prefix_positions = torch.cumsum(prefix_mask, dim=1) - 1
        if suffix_mask is None:
            return prefix_positions.to(torch.int32)
        suffix_positions = (
            prefix_mask_action.sum(dim=-1, keepdim=True) + torch.cumsum(suffix_mask, dim=-1) - 1
        )
        return torch.cat([prefix_positions, suffix_positions], dim=1).to(torch.int32)

    def _token_logp_and_pred(self, pre_logits, labels, *, need_pred: bool):
        """Per-token label log-prob (f32) and argmax predictions, chunked over
        the token axis above ``CE_CHUNK`` positions. Both branches give the
        single-shot log-softmax + gather: each token's logsumexp is a
        full-vocab reduction either way."""
        table = self.llm.embedder.input_embedding
        labels = labels.long()
        chunk = self.CE_CHUNK

        def one(pre_c, labels_c, table_):
            logits = _gemma.tied_table_logits(pre_c, table_).to(torch.float32)
            logz = torch.logsumexp(logits, dim=-1)
            lab = torch.gather(logits, -1, labels_c[..., None])[..., 0]
            pred = logits.argmax(dim=-1) if need_pred else torch.zeros_like(labels_c)
            return lab - logz, pred

        if pre_logits.shape[1] <= chunk:
            logp, pred = one(pre_logits, labels, table)
            return logp, (pred if need_pred else None)
        logps, preds = [], []
        for start in range(0, pre_logits.shape[1], chunk):
            args = (pre_logits[:, start : start + chunk], labels[:, start : start + chunk], table)
            if torch.is_grad_enabled():
                logp_c, pred_c = checkpoint(one, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                logp_c, pred_c = one(*args)
            logps.append(logp_c)
            preds.append(pred_c)
        return torch.cat(logps, dim=1), (torch.cat(preds, dim=1) if need_pred else None)

    def _compute_language_loss(self, obs, prefix_pre_logits, sample_mask=None, *, verbose_mode=False):
        """Shifted CE over the language-action tokens."""
        labels = obs.tokenized_prompt[:, 1:]
        pre_logits = prefix_pre_logits[:, :-1]
        pre_logits = pre_logits[:, -labels.shape[1] :]

        loss_mask = (
            obs.tokenized_langact_mask[:, 1:].to(torch.bool)
            & obs.tokenized_prompt_mask[:, 1:].to(torch.bool)
            & obs.token_loss_mask[:, 1:].to(torch.bool)
        )
        ex_mask = None
        if sample_mask is not None:
            ex_mask = sample_mask.to(torch.bool)[..., None]
            loss_mask = loss_mask & ex_mask

        token_logp, predictions = self._token_logp_and_pred(pre_logits, labels, need_pred=verbose_mode)
        # JAX multiplies by a boolean mask as a select: a masked position
        # gives 0 even where its log-prob is NaN (LAPGemma3's labels past
        # the vocabulary).
        masked_logp = torch.where(loss_mask, token_logp, 0.0)
        per_sample = -masked_logp.sum(dim=-1) / loss_mask.sum(dim=-1).clamp(min=1)
        metrics = {"lang_loss": per_sample.mean()}

        if verbose_mode:
            def prep(m):
                if m is None:
                    return None
                m = m[:, 1:]
                return m * ex_mask if ex_mask is not None else m

            metrics.update(
                _metrics.compute_token_accuracy_metrics(
                    predictions=predictions,
                    labels=labels,
                    per_token_loss=-masked_logp,
                    token_mask=loss_mask,
                    critical_mask=prep(obs.critical_token_mask),
                    number_mask=prep(obs.number_token_mask),
                    direction_mask=prep(obs.direction_token_mask),
                )
            )
        return per_sample, metrics

    def _compute_action_loss(self, suffix_out, u_t):
        v_t = _dense_promoted(
            self.action_out_proj, suffix_out[:, -self.config.action_horizon :].to(torch.float32)
        )
        per_sample = (v_t - u_t).square().mean(dim=(-1, -2))
        return per_sample, {"action_loss": per_sample.mean()}

    def compute_loss(self, observation: CoTObservation, actions, *, train: bool = False,
                     verbose_mode: bool | None = None, noise=None, time=None, aug_params=None,
                     generator: torch.Generator | None = None,
                     return_augmented_images: bool = False):
        """One joint forward of both experts and the weighted loss mix.

        Returns (loss, metrics). ``noise`` [B, horizon, action_dim], ``time``
        [B] and ``aug_params`` (camera -> ``AugmentParams``) fix the random
        values; each is drawn from ``generator`` when not given.
        """
        cfg = self.config
        verbose = cfg.verbose_mode if verbose_mode is None else verbose_mode
        batch_size = observation.tokenized_prompt.shape[0]
        device = self.device

        vqa_mask = None
        if cfg.enable_vqa_training and observation.is_vqa_sample is not None:
            vqa_mask = observation.is_vqa_sample.to(torch.bool)
        pred_mask = None
        if cfg.enable_prediction_training and observation.is_prediction_sample is not None:
            pred_mask = observation.is_prediction_sample.to(torch.bool)

        observation = preprocess_observation(
            observation,
            train=train,
            image_keys=cfg.image_keys,
            image_resolution=cfg.image_resolution,
            aug_wrist_image=cfg.aug_wrist_image,
            enable_image_augmentation=cfg.enable_image_augmentation,
            vqa_mask=vqa_mask,
            aug_params=aug_params,
            generator=generator,
        )
        augmented_images = observation.images if return_augmented_images else None

        # The VLM-only model has no suffix: its loss is the language loss.
        suffix = (self.prepare_suffix(observation, actions, noise=noise, time=time, generator=generator)
                  if cfg.enable_action_training else None)
        prefix_tokens, prefix_mask, prefix_ar_mask, backbone_kwargs = self._embed_prefix_for_loss(observation, suffix)
        if suffix is None:
            prefix_mask_action, suffix_mask, suffix_ar_mask = prefix_mask, None, None
            embedded, conds = [prefix_tokens], [None]
        else:
            prefix_mask_action = self._build_prefix_action_mask(prefix_mask, observation)
            suffix_mask, suffix_ar_mask = suffix["suffix_mask"], suffix["suffix_ar_mask"]
            embedded, conds = [prefix_tokens, suffix["suffix_tokens"]], [None, suffix["adarms_cond"]]
        combined_mask = self._build_combined_attention_mask(
            prefix_mask, prefix_ar_mask, prefix_mask_action, suffix_mask, suffix_ar_mask
        )
        positions = self._build_combined_positions(prefix_mask, prefix_mask_action, suffix_mask)
        pre_logits, _ = self.llm(embedded, positions, combined_mask, conds, want_cache=False, **backbone_kwargs)

        def zeros():
            return torch.zeros(batch_size, dtype=torch.float32, device=device)

        metrics = {}
        lang_per_sample = zeros()
        sample_mask = observation.sample_mask
        if sample_mask is not None:
            sample_mask = sample_mask.to(torch.bool)

        if cfg.enable_langact_training:
            lang_loss, lang_metrics = self._compute_language_loss(
                observation, pre_logits[0], sample_mask=sample_mask, verbose_mode=verbose
            )
            metrics.update(lang_metrics)

            if cfg.enable_vqa_training or cfg.enable_prediction_training:
                none = torch.zeros(batch_size, dtype=torch.bool, device=device)
                vqa_m = vqa_mask if vqa_mask is not None else none
                pred_m = pred_mask if pred_mask is not None else none
                lang_m = ~(vqa_m | pred_m)
                if sample_mask is not None:
                    vqa_m = vqa_m & sample_mask
                    pred_m = pred_m & sample_mask
                    lang_m = lang_m & sample_mask
                    active = sample_mask.sum().to(torch.float32).clamp(min=1.0)
                    metrics["active_num_samples"] = sample_mask.sum()
                else:
                    active = torch.tensor(float(batch_size), device=device)
                    metrics["active_num_samples"] = active
                metrics["vqa_num_samples"] = vqa_m.sum()
                metrics["pred_num_samples"] = pred_m.sum()
                metrics["langact_num_samples"] = lang_m.sum()
                metrics["vqa_sample_portion"] = metrics["vqa_num_samples"] / active
                metrics["pred_sample_portion"] = metrics["pred_num_samples"] / active
                metrics["langact_sample_portion"] = metrics["langact_num_samples"] / active

                if cfg.enable_vqa_training:
                    metrics.update(_metrics.compute_sample_specific_metrics(lang_loss, vqa_m, "vqa_"))
                if cfg.enable_prediction_training:
                    metrics.update(_metrics.compute_sample_specific_metrics(lang_loss, pred_m, "pred_"))
                metrics.update(_metrics.compute_sample_specific_metrics(lang_loss, lang_m, "langact_"))

                vqa_weights = torch.full((batch_size,), cfg.vqa_loss_weight, dtype=torch.float32, device=device)
                if cfg.vqa_loss_weights and observation.vqa_dataset_id is not None:
                    ids = observation.vqa_dataset_id.to(torch.int32)
                    for name, weight in cfg.vqa_loss_weights.items():
                        if name in VQA_DATASET_ID_MAP:
                            vqa_weights = torch.where(ids == VQA_DATASET_ID_MAP[name], weight, vqa_weights)
                lang_per_sample = lang_per_sample + (
                    vqa_weights * lang_loss * vqa_m
                    + cfg.prediction_loss_weight * lang_loss * pred_m
                    + cfg.language_loss_weight * lang_loss * lang_m
                )
            else:
                everyone = torch.ones(batch_size, dtype=torch.bool, device=device)
                metrics.update(
                    _metrics.compute_sample_specific_metrics(
                        lang_loss, sample_mask if sample_mask is not None else everyone, "langact_"
                    )
                )
                lang_per_sample = lang_per_sample + cfg.language_loss_weight * lang_loss

        if suffix is None:
            # JAX's loss without an action expert: the language term alone.
            total_per_sample = lang_per_sample
            if cfg.enable_langact_training and sample_mask is not None:
                final_loss = lang_per_sample.sum() / batch_count(sample_mask.sum().to(torch.float32)).clamp(min=1.0)
            else:
                final_loss = batch_mean(lang_per_sample)
        else:
            action_loss, action_metrics = self._compute_action_loss(pre_logits[1], suffix["u_t"])
            action_sample_mask = torch.ones(batch_size, dtype=torch.bool, device=device)
            if vqa_mask is not None:
                action_sample_mask = action_sample_mask & ~vqa_mask
            if pred_mask is not None:
                action_sample_mask = action_sample_mask & ~pred_mask
            action_sample_mask_f = action_sample_mask.to(torch.float32)
            action_count = action_sample_mask_f.sum().clamp(min=1.0)
            action_per_sample = cfg.action_loss_weight * action_loss * action_sample_mask_f
            action_metrics["action_loss"] = (action_loss * action_sample_mask_f).sum() / action_count
            metrics.update(action_metrics)
            total_per_sample = lang_per_sample + action_per_sample

            # Under data parallelism each rank's terms are its share of the
            # global batch's (``parallel.mesh.batch_count``); the metrics above
            # stay the rank's own.
            action_term = action_per_sample.sum() / batch_count(action_sample_mask_f.sum()).clamp(min=1.0)
            if not cfg.enable_langact_training:
                lang_term = 0.0
            elif sample_mask is not None:
                lang_term = lang_per_sample.sum() / batch_count(sample_mask.sum().to(torch.float32)).clamp(min=1.0)
            else:
                lang_term = batch_mean(lang_per_sample)
            final_loss = lang_term + action_term

        if verbose:
            metrics["per_sample_loss"] = total_per_sample

        if augmented_images is not None:
            metrics["augmented_images"] = augmented_images
        return final_loss, metrics

    # ------------------------------------------------------------------
    # Sampling
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def sample_actions(self, observation: CoTObservation, *, num_steps: int = 10, noise=None,
                       generator: torch.Generator | None = None) -> torch.Tensor:
        """Prefill the prefix, then Euler-integrate the flow from t=1 to 0."""
        cfg = self.config
        if not cfg.enable_action_training:
            raise ValueError(
                "sample_actions needs the action expert: this model was built with enable_action_training=False "
                "(VLM-only); serve it with sample_tokens (ARPolicy)"
            )
        observation = preprocess_observation(
            observation, image_keys=cfg.image_keys, image_resolution=cfg.image_resolution
        )
        device = self.device
        dt = np.float32(-1.0 / num_steps)
        batch_size = observation.state.shape[0]
        if noise is None:
            noise = torch.randn(
                (batch_size, cfg.action_horizon, cfg.action_dim),
                generator=generator, device=device, dtype=torch.float32,
            )
        noise = noise.to(device=device, dtype=torch.float32)

        prefix_tokens, prefix_mask, prefix_ar_mask, extra = self._prefix_inputs(observation)
        prefix_attn_mask = make_attn_mask(prefix_mask, prefix_ar_mask)
        positions = torch.cumsum(prefix_mask, dim=1) - 1
        _, kv_cache = self.llm([prefix_tokens, None], positions, prefix_attn_mask, [None, None], **extra)

        prefix_len = prefix_mask.sum(dim=-1)
        x_t, time = noise, np.float32(1.0)
        for _ in range(num_steps):
            timestep = torch.full((batch_size,), float(time), dtype=torch.float32, device=device)
            suffix_tokens, suffix_mask, suffix_ar, adarms_cond = self.embed_suffix(observation, x_t, timestep)
            suffix_attn = make_attn_mask(suffix_mask, suffix_ar[None].expand_as(suffix_mask))
            prefix_attn = prefix_mask[:, None, :].expand(batch_size, suffix_tokens.shape[1], prefix_mask.shape[1])
            full_mask = torch.cat([prefix_attn, suffix_attn], dim=-1)
            pos = prefix_len[:, None] + torch.cumsum(suffix_mask, dim=-1) - 1
            (_, suffix_out), _ = self.llm(
                [None, suffix_tokens], pos, full_mask, [None, adarms_cond], kv_cache=kv_cache,
                want_cache=False,
            )
            v_t = _dense_promoted(
                self.action_out_proj, suffix_out[:, -cfg.action_horizon :].to(torch.float32)
            )
            x_t = x_t + float(dt) * v_t
            time = np.float32(time + dt)  # f32 accumulation, as in JAX
        return x_t

    @torch.inference_mode()
    def ar_prefill(self, observation: CoTObservation, max_decoding_steps: int) -> ARState:
        """Right-align the prefix and run it through the VLM alone, with a
        cache of ``max_decoding_steps`` free slots; the state holds the
        logits of the last prefix position."""
        cfg = self.config
        observation = preprocess_observation(
            observation, image_keys=list(observation.images.keys()), image_resolution=cfg.image_resolution
        )
        prefix_tokens, prefix_mask, prefix_ar_mask, extra = self._prefix_inputs(observation)
        prefix_attn_mask = make_attn_mask(prefix_mask, prefix_ar_mask)
        prefix_tokens, prefix_mask, prefix_attn_mask, extra = self._right_align(
            prefix_tokens, prefix_mask, prefix_attn_mask, extra
        )
        prefill_size = prefix_tokens.shape[1]
        prefill_len = prefix_mask.sum(dim=-1)
        prefix_attn_mask = F.pad(prefix_attn_mask, (0, max_decoding_steps))
        positions = torch.cumsum(prefix_mask, dim=-1) - 1
        pre_logits, kv_cache = self.llm(self._experts_input(prefix_tokens), positions, prefix_attn_mask,
                                        self._experts_input(None), **extra)
        return ARState(
            kv_cache=kv_cache,
            logits=self.llm.decode_logits(pre_logits[0][:, -1:]),
            prefill_len=prefill_len,
            prefix_start=prefill_size - prefill_len,
            prefill_size=prefill_size,
        )

    @torch.inference_mode()
    def ar_step(self, state: ARState, token: torch.Tensor) -> torch.Tensor:
        """Feed ``token`` [B, 1] at the next position; the cache is written
        in place. Returns (and keeps in ``state``) the next logits [B, 1, V]."""
        total = state.kv_cache[1].shape[2]
        pos = state.prefill_len[:, None] + state.step
        col = torch.arange(total, device=token.device)[None, None, :]
        mask = (col >= state.prefix_start[:, None, None]) & (col < state.prefill_size + state.step + 1)
        pre_logits, state.kv_cache = self.llm(
            self._experts_input(self.llm.embed(token)), pos, mask, self._experts_input(None), kv_cache=state.kv_cache
        )
        state.logits = self.llm.decode_logits(pre_logits[0])
        state.step += 1
        return state.logits

    @torch.inference_mode()
    def sample_tokens(self, observation: CoTObservation, *, max_decoding_steps: int = 390,
                      temperature: float = 0.0, stop_on_eos: bool = True, eos_token: int | None = None,
                      generator: torch.Generator | None = None) -> torch.Tensor:
        """Right-aligned prefill, then cached AR decode: [B, max_decoding_steps]
        int32 tokens, 0 after a row's EOS. ``stop_on_eos=False`` runs the
        whole budget (work independent of what the weights emit)."""
        eos_token = self.EOS_TOKEN if eos_token is None else eos_token
        state = self.ar_prefill(observation, max_decoding_steps)
        b = state.logits.shape[0]
        out = torch.zeros((b, max_decoding_steps), dtype=torch.int32, device=state.logits.device)
        eos = torch.zeros((b,), dtype=torch.bool, device=out.device)
        for step in range(max_decoding_steps):
            if stop_on_eos and bool(eos.all()):
                break
            token = _pick_token(state.logits, temperature, generator)
            token = torch.where(eos[:, None], 0, token)
            out = put_along_last_axis(out, step, token)
            eos = eos | (token[:, 0] == eos_token)
            self.ar_step(state, token)
        return out


# Freeze filters: predicates over the port's parameter names (as given by
# ``named_parameters``), consumed by ``training.train_step``. Each name is
# translated to its JAX params path (``convert.jax_path``) and judged by the
# JAX package's regex rules (``lap_tpu/models/lap_model.py:891-924``), so the
# port freezes exactly the leaves JAX freezes.

_EXPERT_LISTS = (
    "q_einsum", "kv_einsum", "qkv_einsum", "attn_vec_einsum",
    "pre_attention_norm", "pre_ffw_norm", "mlp", "final_norm",
)
_EXPERT_1 = re.compile(r"\.(" + "|".join(_EXPERT_LISTS) + r")\.1(\.|$)")


def is_action_expert_param(name: str) -> bool:
    """Whether a parameter under ``llm`` belongs to expert 1 (JAX: the ``_1``
    suffix of the module name)."""
    return _EXPERT_1.search(name) is not None


def path_matches(path: str, pattern: str) -> bool:
    return re.search(pattern, path) is not None


def _on_jax_path(rule):
    """A predicate over port names from one over JAX params paths."""
    from lap_tpu_torch.models.convert import jax_path

    return lambda name: rule(jax_path(name))


def get_freeze_filter(config: LAPConfig):
    """Returns predicate(name) -> bool for params to FREEZE, or None: with a
    LoRA VLM and/or action expert, every ``llm`` leaf of the adapted
    expert(s) but the adapters."""
    pali_lora = "lora" in config.paligemma_variant
    expert_lora = "lora" in config.action_expert_variant
    if not (pali_lora or expert_lora):
        return None

    def frozen(path: str) -> bool:
        if path_matches(path, r"lora"):
            return False
        if pali_lora and expert_lora:
            return path_matches(path, r"llm")
        if pali_lora:
            return path_matches(path, r"llm") and not path_matches(path, r"_1")
        return path_matches(path, r"llm") and path_matches(path, r"_1")

    return _on_jax_path(frozen)


def get_vlm_freeze_filter(config: LAPConfig):
    """Freeze the VLM (``llm`` minus the `_1` action expert) and the image encoder."""
    del config

    def frozen(path: str) -> bool:
        if path_matches(path, r"img"):
            return True
        return path_matches(path, r"llm") and not path_matches(path, r"_1")

    return _on_jax_path(frozen)
