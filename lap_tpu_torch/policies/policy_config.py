"""Build inference policies from a TrainConfig and a checkpoint directory
(port of ``lap_tpu/policies/policy_config.py``).

The checkpoint directory is a step directory: ``params/`` holds the port's
params file ``model.pt`` (what the port's trainer writes, the EMA view, or
``training/checkpoints.save_params``) or ``params.npz`` (a JAX orbax
``params/`` directory exported by ``scripts/export_jax_params.py``), and
``assets/<asset_id>/norm_stats.json`` is the JAX package's layout. The
input stack is [InjectDefaultPrompt -> data
transforms (``CoTInputs``) -> Normalize -> model transforms (tokenizer,
``PadStates``)]; the output stack is ``Unnormalize`` for flow, and
``DetokenizeReasoning`` then ``CoTOutputs`` for AR. The stacks and the
tokenizer guard come before the restore, so a missing tokenizer fails in
milliseconds instead of after a multi-GB read.

The restore builds the model empty on its device (``init_seed=None``) in the
config's dtype (bf16 for a bf16 model), with the training-only
``stop_action_to_vlm_grad`` off, and fills it from the params file (cast
to the model's dtype); ``quantize`` then adds int8/int4 copies of the
decode weights through ``LAP.quantize_``.

Tensor-parallel serving (``tp > 1``, ``:85-146``) runs inside a process
group of ``tp`` ranks (``serve_policy --serve_tp N`` starts them, or
``torchrun`` does), one a card: the model is built on the ``meta`` device,
its attention heads and MLP hidden dims are split over a tp mesh
(``parallel.sharding``), each rank reads only its slices of the params file
(``checkpoints.restore_params_sharded``), cast to the model's dtype, so the
whole model is never staged on one rank's device. Rank 0 takes the
requests and the other ranks run ``policy.serve_followers``. ``tp > 1`` with
``quantize`` raises, as in JAX: the dequant kernels take whole weights.
``gs://`` checkpoint directories wait for item 21.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

from lap_tpu_torch.policies.model_transforms import InjectDefaultPrompt, Normalize, Unnormalize
from lap_tpu_torch.policies.policy import ARPolicy, Policy

logger = logging.getLogger(__name__)


def _load_norm_stats(checkpoint_dir: Path, asset_id: str | None):
    from lap_tpu_torch.training.checkpoints import load_norm_stats

    assets_dir = checkpoint_dir / "assets"
    if not assets_dir.exists():
        logger.warning("no assets dir at %s; skipping normalization", assets_dir)
        return None
    if asset_id:
        stats = load_norm_stats(assets_dir, asset_id)
        if stats is not None:
            return stats
    # Fall back to the first asset dir with norm stats.
    for sub in sorted(assets_dir.iterdir()):
        if (sub / "norm_stats.json").exists():
            return load_norm_stats(assets_dir, sub.name)
    return None


def _build_transform_stacks(train_config, norm_stats, *, default_prompt=None, ar: bool):
    data_cfg = train_config.data
    model_cfg = train_config.model
    data_group = data_cfg.data_transforms(model_cfg)
    model_group = data_cfg.model_transforms(model_cfg, include_outputs=ar)
    norm_type = data_cfg.action_proprio_normalization_type

    input_stack = [
        InjectDefaultPrompt(default_prompt),
        *data_group.inputs,
        Normalize(norm_stats, normalization_type=norm_type),
        *model_group.inputs,
    ]
    if ar:
        # Detokenize -> parse reasoning to deltas (raw, physical units).
        output_stack = [*model_group.outputs, *data_group.outputs]
    else:
        output_stack = [Unnormalize(norm_stats, normalization_type=norm_type)]
    return input_stack, output_stack


def _require_real_tokenizer(stacks, *, allow_test_vocab: bool):
    """Serving a trained checkpoint through the built-in test vocabulary
    produces garbage reasoning text (the vocab is NOT byte-compatible with
    released checkpoints). Hard-fail unless the caller explicitly opts in
    (tests / benchmarks on fabricated checkpoints)."""
    if allow_test_vocab:
        return
    for stack in stacks:
        for transform in stack:
            tok = getattr(transform, "tokenizer", None)
            proc = getattr(tok, "_tokenizer", None)
            if getattr(proc, "is_test_vocab", False):
                raise RuntimeError(
                    "Refusing to serve a trained checkpoint with the built-in "
                    "TEST tokenizer vocabulary: reasoning/token outputs would "
                    "be garbage. Point LAP_TPU_TOKENIZER_MODEL (or "
                    "LAP_TPU_GEMMA3_TOKENIZER_MODEL) at the real tokenizer "
                    ".model file, or pass allow_test_vocab=True "
                    "(--allow_test_vocab on the CLI) for test checkpoints."
                )


def _restore(train_config, checkpoint_dir: Path, *, quantize: str | None = None, tp: int = 1, device=None):
    from lap_tpu_torch.training.checkpoints import restore_params

    if tp > 1 and quantize is not None:
        raise ValueError(
            "quantized serving (int8/int4) is single-card (the dequant "
            "kernels take whole weights); use tp=1 or quantize=None"
        )
    # Inference disables the training-only stop-gradient.
    model_cfg = dataclasses.replace(train_config.model, stop_action_to_vlm_grad=False)
    if tp > 1:
        return _restore_tp(model_cfg, checkpoint_dir, tp, device)
    model = model_cfg.create_module(device=device, init_seed=None)
    restore_params(checkpoint_dir / "params", model)
    if quantize is not None:
        model.quantize_(quantize)
    return model


def _restore_tp(model_cfg, checkpoint_dir: Path, tp: int, device):
    """The model sharded over a tp mesh of the process group's ``tp`` ranks,
    each filled with its slices of the params file."""
    import torch.distributed as dist

    from lap_tpu_torch.device import resolve_device
    from lap_tpu_torch.parallel import mesh as mesh_lib
    from lap_tpu_torch.parallel.sharding import parallelize_
    from lap_tpu_torch.training.checkpoints import restore_params_sharded

    if not dist.is_initialized() or dist.get_world_size() != tp:
        raise RuntimeError(
            f"tensor-parallel serving (tp={tp}) runs in a process group of {tp} ranks, one a card: "
            f"start it with serve_policy --serve_tp {tp} (or under torchrun), and call create_trained_policy "
            f"on every rank"
        )
    device = resolve_device(device)
    mesh = mesh_lib.make_mesh(1, tp, device_type=device.type)
    model = model_cfg.create_module(device="meta", init_seed=None)
    parallelize_(model, mesh)
    model.to_empty(device=device)
    restore_params_sharded(checkpoint_dir / "params", model, mesh)
    return model


def _resolve_checkpoint_dir(checkpoint_dir) -> Path:
    """Local paths pass through; remote (gs://) directories wait for the
    port of ``utils/download.py`` (ROADMAP queue A, item 21)."""
    if str(checkpoint_dir).startswith("gs://"):
        raise NotImplementedError(
            f"{checkpoint_dir}: restoring from gs:// is not ported yet (ROADMAP queue A, item 21); "
            "copy the checkpoint to a local directory"
        )
    return Path(checkpoint_dir)


def create_trained_policy(
    train_config,
    checkpoint_dir: str | Path,
    *,
    default_prompt: str | None = None,
    num_steps: int = 10,
    allow_test_vocab: bool = False,
    quantize: str | None = None,
    tp: int = 1,
    token_bucket: int | None = None,
    device=None,
    seed: int = 0,
) -> Policy:
    checkpoint_dir = _resolve_checkpoint_dir(checkpoint_dir)
    norm_stats = _load_norm_stats(checkpoint_dir, train_config.data.asset_id)
    inputs, outputs = _build_transform_stacks(train_config, norm_stats, default_prompt=default_prompt, ar=False)
    _require_real_tokenizer([inputs, outputs], allow_test_vocab=allow_test_vocab)
    model = _restore(train_config, checkpoint_dir, quantize=quantize, tp=tp, device=device)
    return Policy(
        model,
        input_transforms=inputs,
        output_transforms=outputs,
        num_steps=num_steps,
        token_bucket=token_bucket,
        seed=seed,
        metadata={"config": train_config.name, "mode": "flow"},
    )


def create_trained_policy_ar(
    train_config,
    checkpoint_dir: str | Path,
    *,
    default_prompt: str | None = None,
    max_decoding_steps: int = 390,
    temperature: float = 0.0,
    allow_test_vocab: bool = False,
    quantize: str | None = None,
    tp: int = 1,
    token_bucket: int | None = None,
    device=None,
    seed: int = 0,
) -> ARPolicy:
    checkpoint_dir = _resolve_checkpoint_dir(checkpoint_dir)
    norm_stats = _load_norm_stats(checkpoint_dir, train_config.data.asset_id)
    inputs, outputs = _build_transform_stacks(train_config, norm_stats, default_prompt=default_prompt, ar=True)
    _require_real_tokenizer([inputs, outputs], allow_test_vocab=allow_test_vocab)
    model = _restore(train_config, checkpoint_dir, quantize=quantize, tp=tp, device=device)
    return ARPolicy(
        model,
        input_transforms=inputs,
        output_transforms=outputs,
        max_decoding_steps=max_decoding_steps,
        temperature=temperature,
        token_bucket=token_bucket,
        seed=seed,
        metadata={"config": train_config.name, "mode": "ar"},
    )
