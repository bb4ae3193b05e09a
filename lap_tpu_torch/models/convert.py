"""Weight bridge: the JAX package's ``params`` tree -> this port's state dict.

The input is the flax params tree in checkpoint layout, as nested dicts of
numpy arrays. Its traps, each handled here:

- expert 1's modules carry the ``_1`` suffix (``q_einsum_1``, ``mlp_1``, ...);
- every leaf under ``llm/layers`` and ``img/Transformer_encoderblock`` has a
  leading depth axis (``nn.scan``); a ``scan_layers=False`` model (the JAX
  package's quantized serving layout) keeps the Gemma layers as
  ``llm/layers_{i}`` subtrees instead;
- flax ``Dense`` kernels are [in, out], torch ``Linear`` weights [out, in];
- SigLIP's ``DenseGeneral`` kernels are [D, N, H] (query/key/value) and
  [N, H, D] (out);
- the ``nn.Conv`` patchify kernel is HWIO, torch's OIHW;
- the adaRMS modulation lives under ``<norm>_1/Dense_0``.

``from_jax_params`` fails on any leaf it does not consume;
``load_jax_params`` also fails on any port parameter it does not fill.
``from_jax_quant``/``load_jax_quant`` carry the "quant" collection of a
quantized JAX model (``layers_{i}/attn/q_einsum/w_i8``,
``.../mlp/gating_w_i4``, ``embedder/decode_w_i8``, the scales) into the
port's quantized buffers with the same checks.

The same translation carries any tree laid out like the params: a gradient
tree, Adam moments, an EMA copy. ``None`` leaves (the frozen gaps of a
partitioned trainable tree) are passed over; nothing else is dropped.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

_EXPERT = re.compile(r"^(?P<name>[a-z_]+?)(?:_(?P<expert>\d+))?$")
_UNSCANNED_LAYER = re.compile(r"^layers_(\d+)$")
_QUANT_LEAF = re.compile(r"^(?P<prefix>(gating_|linear_|decode_)?)(?P<leaf>w_i8|w_i4|scale)$")
_GEMMA_EINSUMS = ("q_einsum", "kv_einsum", "qkv_einsum", "attn_vec_einsum")


def flatten(tree: dict, parent: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{parent}/{k}" if parent else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def _split_expert(name: str) -> tuple[str, int]:
    m = _EXPERT.match(name)
    if m is None:
        raise KeyError(name)
    return m["name"], int(m["expert"] or 0)


def _dense(prefix: str, leaf: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    """flax Dense kernel [in, out] / bias -> torch Linear weight / bias."""
    if leaf == "kernel":
        return f"{prefix}.weight", value.T
    if leaf == "bias":
        return f"{prefix}.bias", value
    raise KeyError(leaf)


def _norm(prefix: str, rest: list[str], value: np.ndarray) -> tuple[str, np.ndarray]:
    if rest == ["scale"]:
        return f"{prefix}.scale", value
    if rest == ["Dense_0", "kernel"]:
        return f"{prefix}.modulation_weight", value.T
    if rest == ["Dense_0", "bias"]:
        return f"{prefix}.modulation_bias", value
    raise KeyError("/".join(rest))


def _llm_layer(parts: list[str], value: np.ndarray, i: int) -> tuple[str, np.ndarray]:
    """One layer's slice of a leaf under llm/layers/."""
    if parts[0] == "attn":
        name, expert = _split_expert(parts[1])
        if name not in _GEMMA_EINSUMS or parts[2:] != ["w"]:
            raise KeyError("/".join(parts))
        return f"llm.layers.{i}.attn.{name}.{expert}.w", value
    name, expert = _split_expert(parts[0])
    if name in ("pre_attention_norm", "pre_ffw_norm"):
        return _norm(f"llm.layers.{i}.{name}.{expert}", parts[1:], value)
    if name == "mlp" and len(parts) == 2 and parts[1] in ("gating_einsum", "linear"):
        return f"llm.layers.{i}.mlp.{expert}.{parts[1]}", value
    raise KeyError("/".join(parts))


def _siglip_layer(parts: list[str], value: np.ndarray, i: int) -> tuple[str, np.ndarray]:
    """One layer's slice of a leaf under img/Transformer_encoderblock/."""
    prefix = f"img.blocks.{i}"
    if parts[0] in ("LayerNorm_0", "LayerNorm_1"):
        ln = "ln0" if parts[0] == "LayerNorm_0" else "ln1"
        return f"{prefix}.{ln}." + {"scale": "weight", "bias": "bias"}[parts[1]], value
    if parts[0] == "MultiHeadDotProductAttention_0":
        proj, leaf = parts[1], parts[2]
        if proj in ("query", "key", "value"):
            if leaf == "kernel":  # [D, N, H] -> [N*H, D]
                return f"{prefix}.attn.{proj}.weight", value.reshape(value.shape[0], -1).T
            return f"{prefix}.attn.{proj}.bias", value.reshape(-1)
        if proj == "out":
            if leaf == "kernel":  # [N, H, D] -> [D, N*H]
                return f"{prefix}.attn.out.weight", value.reshape(-1, value.shape[-1]).T
            return f"{prefix}.attn.out.bias", value
    if parts[0] == "MlpBlock_0":
        dense = {"Dense_0": "mlp0", "Dense_1": "mlp1"}[parts[1]]
        return _dense(f"{prefix}.{dense}", parts[2], value)
    raise KeyError("/".join(parts))


def _translate(key: str, value: np.ndarray) -> list[tuple[str, np.ndarray]]:
    parts = key.split("/")
    top = parts[0]
    if top in ("action_in_proj", "action_out_proj", "time_mlp_in", "time_mlp_out"):
        return [_dense(top, parts[1], value)]
    if top == "llm":
        if parts[1] == "embedder" and parts[2:] == ["input_embedding"]:
            return [("llm.embedder.input_embedding", value)]
        if parts[1] == "layers":
            return [_llm_layer(parts[2:], value[i], i) for i in range(value.shape[0])]
        layer = _UNSCANNED_LAYER.match(parts[1])
        if layer:
            return [_llm_layer(parts[2:], value, int(layer[1]))]
        name, expert = _split_expert(parts[1])
        if name == "final_norm":
            return [_norm(f"llm.final_norm.{expert}", parts[2:], value)]
    if top == "img":
        sub = parts[1]
        if sub == "embedding":
            if parts[2] == "kernel":  # HWIO -> OIHW
                return [("img.embedding.weight", value.transpose(3, 2, 0, 1))]
            return [("img.embedding.bias", value)]
        if sub == "pos_embedding":
            return [("img.pos_embedding", value)]
        if sub == "Transformer_encoderblock":
            return [_siglip_layer(parts[2:], value[i], i) for i in range(value.shape[0])]
        if sub == "Transformer_encoder_norm":
            return [("img.encoder_norm." + {"scale": "weight", "bias": "bias"}[parts[2]], value)]
        if sub == "head":
            return [_dense("img.head", parts[2], value)]
    raise KeyError(key)


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: no numpy-native twin
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable, contiguous copy


def from_jax_params(tree: dict) -> dict[str, torch.Tensor]:
    """JAX params tree (nested dicts of numpy arrays) -> torch state dict.

    Values keep their dtype; raises on any leaf it does not consume.
    """
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}
    unused = []
    for key, value in flatten(tree).items():
        if value is None:
            continue
        try:
            pairs = _translate(key, np.asarray(value))
        except (KeyError, IndexError):
            unused.append(key)
            continue
        for name, arr in pairs:
            out[name] = _to_tensor(arr)
    if unused:
        raise ValueError(f"JAX params not consumed by the port: {sorted(unused)}")
    return out


def _translate_quant(key: str) -> str:
    """A leaf of the JAX "quant" collection -> the port's buffer name."""
    parts = key.split("/")
    if parts[0] != "llm" or len(parts) < 3 or not _QUANT_LEAF.match(parts[-1]):
        raise KeyError(key)
    if parts[1:-1] == ["embedder"] and parts[-1].startswith("decode_"):
        return f"llm.embedder.{parts[-1]}"
    layer = _UNSCANNED_LAYER.match(parts[1])
    if layer is None:
        raise KeyError(key)
    i = int(layer[1])
    leaf = _QUANT_LEAF.match(parts[-1])
    if parts[2] == "attn" and len(parts) == 5 and not leaf["prefix"]:
        name, expert = _split_expert(parts[3])
        if name in _GEMMA_EINSUMS:
            return f"llm.layers.{i}.attn.{name}.{expert}.{parts[-1]}"
    if len(parts) == 4 and leaf["prefix"] in ("gating_", "linear_"):
        name, expert = _split_expert(parts[2])
        if name == "mlp":
            return f"llm.layers.{i}.mlp.{expert}.{parts[-1]}"
    raise KeyError(key)


def from_jax_quant(tree: dict) -> dict[str, torch.Tensor]:
    """JAX "quant" collection (nested dicts of numpy arrays) -> the port's
    buffer names; raises on any leaf it does not consume."""
    if "quant" in tree and len(tree) == 1:
        tree = tree["quant"]
    out, unused = {}, []
    for key, value in flatten(tree).items():
        try:
            out[_translate_quant(key)] = _to_tensor(np.asarray(value))
        except KeyError:
            unused.append(key)
    if unused:
        raise ValueError(f"JAX quant leaves not consumed by the port: {sorted(unused)}")
    return out


def load_jax_quant(model: nn.Module, tree: dict) -> nn.Module:
    """Replace the quantized copies of ``model``'s weights by a JAX "quant"
    collection. The mode (int4 if any weight is nibble-packed, else int8)
    fixes which buffers the model must get (those ``quantize_`` would make);
    raises if one is left unfilled, a leaf is left over, or a shape or dtype
    differs."""
    from lap_tpu_torch.models.lora import QuantWeights

    state = from_jax_quant(tree)
    mode = "int4" if any(name.endswith("w_i4") for name in state) else "int8"
    owners = {}
    for module_name, module in model.named_modules():
        if isinstance(module, QuantWeights):
            for name, spec in module.quant_spec(mode).items():
                owners[f"{module_name}.{name}"] = (module, name, spec)
    missing = sorted(set(owners) - set(state))
    extra = sorted(set(state) - set(owners))
    if missing or extra:
        raise ValueError(f"quant bridge mismatch: unfilled {missing}, unexpected {extra}")
    for full, (_, _, (shape, dtype)) in owners.items():
        if tuple(state[full].shape) != shape or state[full].dtype != dtype:
            raise ValueError(f"{full}: {tuple(state[full].shape)} {state[full].dtype} != {shape} {dtype}")
    for module_name, module in model.named_modules():
        if isinstance(module, QuantWeights):
            module.clear_quant_()
    device = next(model.parameters()).device
    for full, (module, name, _) in owners.items():
        module.register_buffer(name, state[full].to(device))
    return model


def load_jax_params(model: nn.Module, tree: dict) -> nn.Module:
    """Fill every parameter of ``model`` from a JAX params tree.

    Raises if a port parameter is left unfilled, a leaf is left over, or a
    shape differs. Values are cast to each parameter's dtype and device.
    """
    state = from_jax_params(tree)
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError(f"weight bridge mismatch: unfilled {missing}, unexpected {extra}")
    with torch.no_grad():
        for name, param in own.items():
            value = state[name]
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(param.shape)}")
            param.copy_(value.to(dtype=param.dtype, device=param.device))
    return model
