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


def replay_augment_draws(rng, batch: int, height: int, width: int) -> dict:
    """The values ``lap_tpu.models.preprocessing.augment_images(images, rng)``
    draws for a batch, key by key: crop offsets, angle (radians) and the three
    jitter factors, each [batch]."""
    import jax
    import jax.numpy as jnp

    ch, cw = int(height * 0.95), int(width * 0.95)
    cols = {n: [] for n in ("crop_y", "crop_x", "angle", "brightness", "contrast", "saturation")}
    for sample_key in jax.random.split(rng, batch):
        k1, k2, k3 = jax.random.split(sample_key, 3)
        ky, kx = jax.random.split(k1)
        cols["crop_y"].append(jax.random.randint(ky, (), 0, height - ch + 1))
        cols["crop_x"].append(jax.random.randint(kx, (), 0, width - cw + 1))
        cols["angle"].append(jax.random.uniform(k2, (), minval=-5.0, maxval=5.0) * jnp.pi / 180.0)
        kb, kc, ks = jax.random.split(k3, 3)
        for name, k in (("brightness", kb), ("contrast", kc), ("saturation", ks)):
            cols[name].append(1.0 + jax.random.uniform(k, (), minval=-0.2, maxval=0.2))
    return {n: np.asarray(jnp.stack(v)) for n, v in cols.items()}


def replay_preprocess_draws(rng, *, image_keys, batch: int, resolution) -> dict:
    """Per camera, what ``preprocess_observation(rng, ..., train=True)`` draws
    (it folds the camera's index into ``rng``)."""
    import jax

    return {
        key: replay_augment_draws(jax.random.fold_in(rng, i), batch, *resolution)
        for i, key in enumerate(image_keys)
    }


def jax_loss_randomness(rng, *, image_keys, batch: int, resolution, action_shape) -> dict:
    """The random values ``lap_tpu``'s ``compute_loss(rng, ..., train=True)``
    draws, replayed key by key so the port can be fed the same ones: per
    camera the augmentation draws, then the flow noise and time."""
    import jax

    preprocess_rng, _, noise_rng, time_rng = jax.random.split(rng, 4)
    aug = replay_preprocess_draws(preprocess_rng, image_keys=image_keys, batch=batch, resolution=resolution)
    noise = np.asarray(jax.random.normal(noise_rng, action_shape))
    time = np.asarray(jax.random.uniform(time_rng, action_shape[:-2]) ** (1.0 / 1.5) * 0.999 + 0.001)
    return dict(aug=aug, noise=noise, time=time)


def port_aug_params(aug: dict) -> dict:
    """``jax_loss_randomness()["aug"]`` as the port's ``AugmentParams``."""
    import torch

    from lap_tpu_torch.models.preprocessing import AugmentParams

    return {k: AugmentParams(**{n: torch.from_numpy(np.array(v)) for n, v in vals.items()})
            for k, vals in aug.items()}


def train_obs_arrays(seed: int, *, batch: int, valid: list[int], cfg_kw: dict, langact_from: int = 4) -> dict:
    """``random_obs_arrays`` plus what the training loss reads: a causal
    language-action span, a token loss mask, and small vocabulary ids."""
    arrays = random_obs_arrays(seed, batch=batch, valid=valid, cfg_kw=cfg_kw)
    t = cfg_kw["max_token_len"]
    rng = np.random.default_rng(seed + 1000)
    arrays["tokenized_langact_mask"] = np.broadcast_to(np.arange(t)[None, :] >= langact_from, (batch, t)).copy()
    arrays["token_loss_mask"] = rng.random((batch, t)) < 0.8
    return arrays


def port_observation(arrays: dict):
    """A port ``CoTObservation`` on the CPU from a dict of numpy arrays."""
    import torch

    from lap_tpu_torch.models.types import CoTObservation

    def conv(v):
        return {k: conv(x) for k, x in v.items()} if isinstance(v, dict) else torch.from_numpy(np.array(v))

    return CoTObservation(**{k: conv(v) for k, v in arrays.items()})


def jax_observation(arrays: dict):
    import jax
    import jax.numpy as jnp

    from lap_tpu.models.types import CoTObservation

    return CoTObservation(**{k: jax.tree.map(jnp.asarray, v) for k, v in arrays.items()})


def holder(**modules):
    """Port modules under the names the weight bridge gives them (llm, img)."""
    from torch import nn

    out = nn.Module()
    for name, module in modules.items():
        setattr(out, name, module)
    return out
