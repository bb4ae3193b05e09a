"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs and parameters are made with numpy from a seed and handed to both
the JAX package and the port, since the two frameworks' RNGs differ.
"""

from __future__ import annotations

import math

import numpy as np

TORCH_THREADS = 2  # the suite runs 6 xdist workers; keep each one small


def flatten(tree, parent=""):
    out = {}
    for k, v in tree.items():
        key = f"{parent}/{k}" if parent else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat):
    out = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def randomize_params(tree: dict, seed: int) -> dict:
    """Replace every leaf with seeded non-zero random values of a sane scale.

    Nothing stays zero: JAX zero-initialises the norm scales and the adaRMS
    modulation, which would make every action-expert layer an identity and
    leave attention untested.
    """
    rng = np.random.default_rng(seed)
    flat = flatten(tree)
    out = {}
    for key in sorted(flat):
        shape = np.shape(flat[key])
        leaf = key.rsplit("/", 1)[-1]
        stacked = "/layers/" in key or "/Transformer_encoderblock/" in key
        dims = shape[1:] if stacked else shape
        layer_norm = "LayerNorm" in key or "encoder_norm" in key
        if leaf == "scale":
            val = (1.0 if layer_norm else 0.0) + 0.2 * rng.standard_normal(shape)
        elif leaf == "bias":
            val = 0.1 * rng.standard_normal(shape)
        elif leaf == "input_embedding":
            val = 0.1 * rng.standard_normal(shape)
        elif leaf == "pos_embedding":
            val = 0.5 * rng.standard_normal(shape)
        else:
            fan_in = math.prod(dims[:-1]) if len(dims) > 1 else 1
            val = rng.standard_normal(shape) / math.sqrt(fan_in)
        out[key] = val.astype(np.float32)
    return unflatten(out)


def tiny_lap_config_kwargs(**overrides) -> dict:
    """The dummy flagship-architecture config of tests/test_golden_parity.py."""
    kw = dict(
        dtype="float32",
        paligemma_variant="dummy",
        action_expert_variant="dummy",
        siglip_variant="dummy",
        action_dim=7,
        action_horizon=4,
        max_token_len=16,
        image_resolution=(28, 28),
        enable_action_training=True,
    )
    kw.update(overrides)
    return kw


def random_obs_arrays(seed: int, *, batch: int, valid: list[int], cfg_kw: dict) -> dict:
    """A model-ready batch: float images in [-1, 1], state, unequal prompt padding."""
    rng = np.random.default_rng(seed)
    h, w = cfg_kw["image_resolution"]
    t = cfg_kw["max_token_len"]
    keys = ("base_0_rgb", "left_wrist_0_rgb")
    return dict(
        images={k: rng.uniform(-1, 1, (batch, h, w, 3)).astype(np.float32) for k in keys},
        image_masks={k: np.ones((batch,), bool) for k in keys},
        state=rng.standard_normal((batch, cfg_kw["action_dim"])).astype(np.float32),
        tokenized_prompt=rng.integers(0, 257_152, (batch, t)).astype(np.int32),
        tokenized_prompt_mask=np.arange(t)[None, :] < np.asarray(valid)[:, None],
        tokenized_langact_mask=np.zeros((batch, t), bool),
    )
