"""Gemma3 checkpoint remapper (port of ``lap_tpu/training/gemma3_weights.py``).

A raw Gemma3-IT export stores

    transformer/layer_N/attn/{q,kv,attn_vec}_einsum/w
    transformer/layer_N/attn/{_key_norm,_query_norm}/scale
    transformer/layer_N/mlp/{gating_einsum,linear}/w
    transformer/layer_N/{pre,post}_{attention,ffw}_norm/scale
    transformer/{final_norm/scale, embedder/input_embedding}
    transformer/embedder/mm_input_projection/w        -> img/head/kernel
    transformer/embedder/mm_soft_embedding_norm/scale -> img/mm_soft_embedding_norm/scale
    SigLiPFromPatches_0/siglip_encoder/Transformer/encoderblock_N/...
    SigLiPFromPatches_0/siglip_encoder/{embedding,pos_embedding,head,...}

and ``remap_gemma3_export`` moves it into the model's JAX paths: per-layer
and per-encoderblock arrays stacked on a leading depth axis, the QK norms
renamed, the MLP's ``/w`` nesting dropped, the multimodal projection routed
into the SigLIP head. ``Gemma3ScanCompatibleWeightLoader`` resizes the ViT
position embeddings when the grid differs (bicubic, ``scipy.ndimage.zoom``
with ``order=3, mode="reflect"``, as the reference does; 64x64 at 896 px to
16x16 at 224 px), checks that the remap gained no parameter, and merges in
JAX-path space (``weight_loaders.merge_params``).

The port reads no orbax: ``params_path`` is a flat ``.npz`` (or a directory
holding ``params.npz``), such as ``scripts/export_jax_params.py`` writes from
the export's orbax directory. bfloat16 leaves arrive as 2-byte void
(``weight_loaders.recover_dtype``); a position embedding that must be resized
is resized in float32.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from pathlib import Path

import numpy as np

from lap_tpu_torch.models import convert
from lap_tpu_torch.training.weight_loaders import NPZ_FILE, flatten, merge_params, recover_dtype, unflatten

logger = logging.getLogger(__name__)

_LAYER_RE = re.compile(r"(?:^|/)layer_(\d+)/")
_ENCODERBLOCK_RE = re.compile(r"(?:^|/)Transformer_encoderblock_(\d+)/")


def _stack_by_index(flat: dict, pattern: re.Pattern, replacement: str) -> dict:
    """Collapse ``...<name>_N/...`` paths into stacked arrays with a leading
    depth axis, leaving other paths untouched."""
    grouped: dict[str, dict[int, np.ndarray]] = {}
    out: dict = {}
    for key, value in flat.items():
        m = pattern.search(key)
        if not m:
            out[key] = value
            continue
        idx = int(m.group(1))
        stacked_key = key[: m.start()] + ("/" if m.start() else "") + replacement + key[m.end() - 1 :]
        grouped.setdefault(stacked_key, {})[idx] = value
    for key, by_layer in grouped.items():
        depth = max(by_layer) + 1
        if len(by_layer) != depth:
            raise ValueError(f"missing layers for {key}: have {sorted(by_layer)}")
        out[key] = np.stack([np.asarray(by_layer[i]) for i in range(depth)], axis=0)
    return out


def stack_scan_layers(flat: dict) -> dict:
    """Collapse ``.../layer_N/...`` paths into stacked arrays with a leading
    depth axis, leaving other paths untouched."""
    return _stack_by_index(flat, _LAYER_RE, "layers")


def resize_pos_embedding(posemb: np.ndarray, target_tokens: int) -> np.ndarray:
    """Bicubic grid resize of learned ViT position embeddings [1, N, D]."""
    from scipy.ndimage import zoom

    posemb = np.asarray(posemb)
    n, d = posemb.shape[-2], posemb.shape[-1]
    side = int(round(n**0.5))
    target_side = int(round(target_tokens**0.5))
    if side == target_side:
        return posemb
    grid = posemb.reshape(side, side, d)
    factor = target_side / side
    resized = zoom(grid, (factor, factor, 1), order=3, mode="reflect")
    return resized.reshape(1, target_side * target_side, d).astype(posemb.dtype)


def remap_gemma3_export(flat: dict) -> dict:
    """Remap a flattened raw Gemma3 export to the model's flat JAX paths (no
    merging; key and layout surgery only)."""
    out: dict = {}
    for key, value in flat.items():
        key = key.removeprefix("params/")
        if key.startswith("transformer/embedder/mm_input_projection/w"):
            out["img/head/kernel"] = value
            continue
        if key.startswith("transformer/embedder/mm_input_projection/b"):
            out["img/head/bias"] = value
            continue
        if key.startswith("transformer/embedder/mm_soft_embedding_norm/"):
            out["img/" + key.removeprefix("transformer/embedder/")] = value
            continue
        if key.startswith("transformer/"):
            key = "llm/" + key.removeprefix("transformer/")
            key = key.replace("/_key_norm/", "/k_rmsnorm/")
            key = key.replace("/_query_norm/", "/q_rmsnorm/")
            # The model's MLP keeps bare arrays, not {'w': ...}.
            key = key.replace("/mlp/gating_einsum/w", "/mlp/gating_einsum")
            key = key.replace("/mlp/linear/w", "/mlp/linear")
            out[key] = value
            continue
        if key.startswith("SigLiPFromPatches_0/siglip_encoder/"):
            sub = key.removeprefix("SigLiPFromPatches_0/siglip_encoder/")
            sub = sub.replace("Transformer/encoder_norm/", "Transformer_encoder_norm/")
            sub = sub.replace("Transformer/encoderblock_", "Transformer_encoderblock_")
            out["img/" + sub] = value
            continue
        out[key] = value  # already in the model's namespace (a re-export of a merge)
    out = _stack_by_index(out, _LAYER_RE, "layers")
    return _stack_by_index(out, _ENCODERBLOCK_RE, "Transformer_encoderblock")


def _n_elems(flat: dict, *, skip_pos: bool) -> int:
    return sum(int(np.prod(np.shape(v))) for k, v in flat.items() if not (skip_pos and k.endswith("pos_embedding")))


def read_export(params_path: str | Path) -> dict:
    """A raw export's flat ``.npz`` (or a directory holding ``params.npz``)
    as {path: array}, the ``params/`` prefix dropped."""
    path = Path(params_path)
    if path.is_dir():
        path = path / NPZ_FILE
    return {k: recover_dtype(v) for k, v in convert.read_params_npz(path).items()}


@dataclasses.dataclass(frozen=True)
class Gemma3ScanCompatibleWeightLoader:
    params_path: str
    # Params not present in the source checkpoint keep their init (the action
    # expert's `_1` branches, projections, adaRMS Dense, LoRA).
    missing_regex: str = r".*(_1($|/).*|action_.*|time_mlp.*|state_proj.*|Dense_0.*|lora.*)"

    def load(self, params_shape: dict) -> dict:
        flat = flatten(read_export(self.params_path))
        n_src = _n_elems(flat, skip_pos=False)
        remapped = remap_gemma3_export(flat)

        flat_shape = flatten(params_shape)
        for key in list(remapped):
            if key.endswith("pos_embedding") and key in flat_shape:
                want, have = flat_shape[key].shape[-2], np.shape(remapped[key])[-2]
                if want != have:
                    logger.info("resizing %s pos embedding %d -> %d tokens", key, have, want)
                    remapped[key] = resize_pos_embedding(_float_array(remapped[key]), want)

        # Parameter-count conservation: the remap never duplicates a source
        # array; the pos-embedding resize is the only size-changing step, and
        # extra source keys may be discarded.
        n_out = _n_elems(remapped, skip_pos=True)
        n_src_no_pos = _n_elems(flat, skip_pos=True)
        if n_out > n_src_no_pos:
            raise ValueError(f"gemma3 remap GAINED parameters ({n_src_no_pos:,} -> {n_out:,}): duplication bug")
        logger.info("gemma3 loader: %d source params, %d after remap (discarded %d)",
                    n_src, n_out, n_src_no_pos - n_out)
        return merge_params(unflatten(remapped), params_shape, missing_regex=self.missing_regex)


def _float_array(a: np.ndarray) -> np.ndarray:
    """A bfloat16 leaf stored as 2-byte void as f32 values; others as they are."""
    a = np.asarray(a)
    return convert._to_tensor(a).float().numpy() if a.dtype.kind == "V" else a
