"""Training configs (port of ``lap_tpu/training/config.py``): the model, the
data config with its transform factories (what the serving stack builds its
input and output transforms from) and the fields of the ``fake`` loader, the
weight loader, the schedule, the optimizer, the batch, ``param_dtype``, the
EMA choice, ``freeze_vlm``, the seed, and the fields the training loop and
offline eval read (``:216-286``): run names and directories, checkpoint
interval and retention, resume / overwrite, validation and ``eval_*``.
``cli()`` resolves ``<config> [--field value ...]`` as JAX's does.

Named configs: all 13 of JAX's: ``lap``, ``pi05_replicated`` (FAST action
tokens), ``pi0_replicated``, ``lap_gemma3_4b``, ``fast_gemma3_4b``,
``lap_gemma3_12b``, ``lap_gemma3_27b``, ``vla0_replicated`` and
``vla0_replicated_libero`` (the VLM-only model), ``lap_libero``,
``lap_cotrain``, ``lap_gemma3_4b_libero`` and ``debug``. With ``use_fast``
the model transforms are the FAST group (``TokenizeFASTInputs`` in,
``ExtractFASTActions`` out), built as JAX builds it. The optimizer is
``AdamW`` or ``SGDConfig`` (``--optimizer SGDConfig``). The mesh fields
``fsdp_devices``, ``tp_devices`` and ``sequence_parallel`` are JAX's
(``:253-266``); left out: ``pp_devices``/``pp_microbatches`` (item 13b),
the RLDS pipeline's data fields (ROADMAP item 19) and wandb (item 21). Every config but ``debug`` reads ``oxe`` or ``libero``,
which the loader refuses until item 19; ``--data.repo_id fake`` trains any
of them on synthetic batches. Defaults equal JAX's; a test compares them
field by field.
"""

from __future__ import annotations

import dataclasses
import difflib
import math
import pathlib
from typing import Literal

from lap_tpu_torch.data.helpers import ActionEncoding, NormalizationType, StateEncoding
from lap_tpu_torch.models.lap_model import LAPConfig
from lap_tpu_torch.policies.input_transforms import CoTInputs
from lap_tpu_torch.policies.model_transforms import (
    DetokenizeReasoning,
    Group,
    InjectDefaultPrompt,
    PadStates,
    TokenizePromptAndReasoning,
)
from lap_tpu_torch.policies.output_transforms import CoTOutputs
from lap_tpu_torch.policies.question_types import QuestionConfig
from lap_tpu_torch.training import optimizer as _optimizer
from lap_tpu_torch.training import weight_loaders
from lap_tpu_torch.utils import cli as _cli


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Data configuration (``lap_tpu/training/config.py:35-133``): every
    field, with the JAX defaults, in its order. The loader reads the RLDS
    pipeline's (the samplers, the sample probabilities, the encodings and
    horizons, the images, the DROID and bbox inputs, the norm stats)."""

    repo_id: str | None = "oxe"
    asset_id: str | None = "oxe"
    shuffle_buffer_size: int = 1_000_000
    max_samples: int | None = None
    val_max_samples: int | None = None
    val_fraction: float | None = 0.025
    use_wrist_image: bool = True
    wrist_image_dropout_prob: float = 0.1
    state_encoding: StateEncoding = StateEncoding.POS_EULER
    action_encoding: ActionEncoding = ActionEncoding.EEF_POS
    action_proprio_normalization_type: NormalizationType = NormalizationType.BOUNDS_Q99
    resize_resolution: tuple[int, int] = (224, 224)
    force_recompute_stats: bool = False
    # Cap on episodes per dataset for the norm-stats pass; None = full pass
    # (the reference default). Set small for quick debug runs.
    norm_stats_max_episodes: int | None = None
    # Robot-frame grounding QA (reference vqa/bbox/): directory holding
    # per-dataset subdirs of JSONL bbox annotations; frames with annotations
    # become bbox/direction QA samples with probability grounding_prob.
    bbox_annotations_dir: str | None = None
    grounding_prob: float = 0.3
    want_full_determinism: bool = False
    data_mix: str | None = "oxe_magic_soup"
    balance_weights: bool = True
    rlds_data_dir: str = "./data"

    aggressive_aug: bool = False
    aug_wrist_image: bool = True
    random_base_prob: float = 0.0
    random_mask_prob: float = 0.2
    not_rotate_wrist_prob: float = 0.0
    use_rough_scale: bool = False

    language_action_format_name: str = "verbose_eef_with_rotation"
    transform_strategy: Literal["standard", "vla0"] = "standard"
    horizon_seconds: tuple[float, ...] = (1.0,)

    max_prediction_horizon: int = 30
    pred_prob: float = 0.3
    primary_pred_prob: float = 0.8

    enable_diverse_questions: bool = True
    question_type_weights: dict | None = None
    delta_motion_format_weights: dict | None = None
    use_diverse_prompts: bool = True

    direction_prob: float = 0.0
    droid_dataset_name: Literal["droid", "droid_100"] = "droid"
    gemma3_tokenizer_path: str | None = None

    # Injected default prompt at inference when the request has none.
    default_prompt: str | None = None

    def data_transforms(self, model_config: LAPConfig) -> Group:
        """Policy-side transforms (reference RLDSDataConfig:321-359)."""
        question_config = None
        if self.enable_diverse_questions:
            question_config = QuestionConfig(
                type_weights=self.question_type_weights,
                delta_motion_format_weights=self.delta_motion_format_weights,
                use_diverse_prompts=self.use_diverse_prompts,
            )
        return Group(
            inputs=(
                CoTInputs(
                    action_dim=model_config.action_dim,
                    model_type=model_config.model_type,
                    wrist_image_dropout_prob=self.wrist_image_dropout_prob,
                    action_encoding=self.action_encoding,
                    language_action_format=self.language_action_format_name,
                    random_mask_prob=self.random_mask_prob,
                    random_base_prob=self.random_base_prob,
                    use_rough_scale=self.use_rough_scale,
                    transform_strategy=self.transform_strategy,
                    enable_langact_training=model_config.enable_langact_training,
                    enable_diverse_questions=self.enable_diverse_questions,
                    question_config=question_config,
                ),
            ),
            outputs=(
                CoTOutputs(
                    language_action_format=self.language_action_format_name,
                    transform_strategy=self.transform_strategy,
                ),
            ),
        )

    def model_transforms(self, model_config: LAPConfig, *, include_outputs: bool = True) -> Group:
        return ModelTransformFactory(
            prompt_format=model_config.prompt_format,
            prediction_format=model_config.prediction_format,
            include_outputs=include_outputs,
            gemma3_tokenizer_path=self.gemma3_tokenizer_path,
            default_prompt=self.default_prompt,
        )(model_config)


@dataclasses.dataclass(frozen=True)
class ModelTransformFactory:
    """Builds the tokenizer and model transform Group per model type
    (``lap_tpu/training/config.py:135-213``). ``fast_tokenizer_path``
    is JAX's field; as there, nothing reads it (the codec is the DCT-only
    ``make_fast_tokenizer``)."""

    prompt_format: str = "lap"
    prediction_format: str = "default"
    include_outputs: bool = True
    fast_tokenizer_path: str = "physical-intelligence/fast"
    gemma3_tokenizer_path: str | None = None
    default_prompt: str | None = None

    def _create_tokenizer(self, model_config: LAPConfig, reasoning_mask_prob: float):
        from lap_tpu_torch.models.tokenizer import Gemma3Tokenizer, PaligemmaTokenizer

        kwargs = dict(
            max_len=model_config.max_token_len,
            prompt_format=self.prompt_format,
            prediction_format=self.prediction_format,
            reasoning_mask_prob=reasoning_mask_prob,
        )
        if "gemma3" in model_config.paligemma_variant:
            import os

            if self.gemma3_tokenizer_path:
                os.environ.setdefault("LAP_TPU_GEMMA3_TOKENIZER_MODEL", self.gemma3_tokenizer_path)
            return Gemma3Tokenizer(num_images=len(model_config.image_keys), **kwargs)
        return PaligemmaTokenizer(**kwargs)

    def __call__(self, model_config: LAPConfig) -> Group:
        if model_config.use_fast:
            from lap_tpu_torch.models.fast_tokenizer import (
                ExtractFASTActions,
                TokenizeFASTInputs,
                make_fast_tokenizer,
            )

            fast_tok = make_fast_tokenizer(
                model_config,
                prompt_format=self.prompt_format,
                prediction_format=self.prediction_format,
                gemma3_tokenizer_path=self.gemma3_tokenizer_path,
            )
            return Group(
                inputs=(
                    InjectDefaultPrompt(self.default_prompt),
                    TokenizeFASTInputs(
                        fast_tok,
                        discrete_state_input=model_config.discrete_state_input,
                        state_dropout=model_config.state_dropout,
                    ),
                ),
                outputs=(
                    ExtractFASTActions(
                        fast_tok,
                        action_horizon=model_config.action_horizon,
                        action_dim=model_config.action_dim,
                    ),
                ),
            )
        outputs = ()
        if self.include_outputs:
            outputs = (DetokenizeReasoning(self._create_tokenizer(model_config, 0.0)),)
        return Group(
            inputs=(
                InjectDefaultPrompt(self.default_prompt),
                TokenizePromptAndReasoning(
                    self._create_tokenizer(model_config, model_config.reasoning_mask_prob),
                    discrete_state_input=model_config.discrete_state_input,
                    verbose_mode=model_config.verbose_mode,
                    state_dropout=model_config.state_dropout,
                ),
                PadStates(model_config.action_dim),
            ),
            outputs=outputs,
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    name: str = "lap"
    exp_name: str = "default"
    project_name: str = "lap_tpu"

    model: LAPConfig = dataclasses.field(default_factory=LAPConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    weight_loader: weight_loaders.WeightLoaderChoice = dataclasses.field(
        default_factory=weight_loaders.WeightLoaderChoice
    )
    lr_schedule: _optimizer.CosineDecaySchedule = dataclasses.field(
        default_factory=lambda: _optimizer.CosineDecaySchedule(
            warmup_steps=5_000, peak_lr=1e-4, decay_steps=40_000, decay_lr=1e-5
        )
    )
    optimizer: _optimizer.AdamW | _optimizer.SGDConfig = dataclasses.field(
        default_factory=lambda: _optimizer.AdamW(weight_decay=0.0001)
    )

    # The global batch; each data rank (dp x fsdp) loads its share.
    batch_size: int = 2048
    num_train_steps: int = 40_000
    save_interval: int = 1000
    log_interval: int = 50
    keep_period: int | None = 5000
    resume: bool = True
    overwrite: bool = False
    seed: int = 0

    ema_decay: float | None = 0.999
    ema_schedule_choice: _optimizer.EmaScheduleChoice = dataclasses.field(
        default_factory=lambda: _optimizer.EmaScheduleChoice(kind="cosine_delayed", start_step=5000)
    )

    # The (dp, fsdp, tp) mesh under torchrun (``parallel.mesh``): fsdp *
    # tp ranks hold one model, the remaining factor is data parallelism.
    # ``pp_devices``/``pp_microbatches`` come with ROADMAP item 13b.
    fsdp_devices: int = 1
    tp_devices: int = 1
    # Megatron-style sequence parallelism under tp: the residual stream stays
    # token-sharded between the attention and MLP regions. Numerically the
    # same as tp alone.
    sequence_parallel: bool = False
    param_dtype: str = "float32"

    checkpoint_base_dir: str = "./checkpoints"
    assets_base_dir: str = "./assets"

    use_validation: bool = False
    val_interval: int = 2000
    allow_partial_weights: bool = True
    freeze_vlm: bool = False

    eval_checkpoint_step: int | None = None
    eval_checkpoint_steps: tuple[int, ...] | None = None
    eval_all_checkpoints: bool = True
    eval_start_from_step: int | None = None
    num_eval_batches: int | None = 500
    eval_use_ema: bool = True
    eval_split: Literal["val", "train"] = "val"

    def __post_init__(self):
        if self.fsdp_devices < 1 or self.tp_devices < 1:
            raise ValueError("fsdp_devices and tp_devices must be >= 1")

    @property
    def assets_dirs(self) -> pathlib.Path:
        return pathlib.Path(self.assets_base_dir) / self.name

    @property
    def checkpoint_dir(self) -> pathlib.Path:
        if not self.exp_name:
            raise ValueError("--exp_name must be set")
        return pathlib.Path(self.checkpoint_base_dir) / self.name / self.exp_name

    def get_ema_decay_for_step(self, step: int) -> tuple[float, bool]:
        """(decay, enabled) at ``step``, including the cosine-delayed ramp."""
        if self.ema_schedule_choice.kind == "cosine_delayed":
            if self.ema_decay is None:
                return 0.0, False
            start = self.ema_schedule_choice.start_step
            duration = max(self.num_train_steps - start, 1)
            progress = min(max((step - start) / duration, 0.0), 1.0)
            decay = self.ema_decay * (1.0 - math.cos(math.pi * progress)) / 2.0
            return decay, step >= start
        schedule = self.ema_schedule_choice.build(decay=self.ema_decay)
        if schedule is not None:
            return schedule.get_decay_for_step(step)
        if self.ema_decay is None:
            return 0.0, False
        return self.ema_decay, True

    @property
    def has_ema(self) -> bool:
        return self.ema_decay is not None and self.ema_schedule_choice.kind != "disabled"


_FINETUNE_LR = _optimizer.CosineDecaySchedule(warmup_steps=1000, peak_lr=5e-5, decay_steps=40_000, decay_lr=5e-5)


def _libero_data(**kw) -> DataConfig:
    return DataConfig(
        shuffle_buffer_size=100_000,
        repo_id="libero",
        asset_id="libero",
        data_mix="libero_finetune",
        val_fraction=0.0,
        **kw,
    )


def _gemma3_model(vlm: str, expert: str, **kw) -> LAPConfig:
    return LAPConfig(
        action_dim=7,
        action_horizon=kw.pop("action_horizon", 16),
        enable_action_training=True,
        enable_langact_training=True,
        max_token_len=800,
        paligemma_variant=vlm,
        action_expert_variant=expert,
        **kw,
    )


_CONFIGS = [
    TrainConfig(
        name="lap",
        data=DataConfig(random_base_prob=0.5),
        model=LAPConfig(
            action_dim=7,
            action_horizon=16,
            max_token_len=180,
            enable_action_training=True,
            stop_action_to_vlm_grad=True,
        ),
        batch_size=2048,
    ),
    TrainConfig(
        name="pi05_replicated",
        model=LAPConfig(
            action_dim=7,
            action_horizon=16,
            max_token_len=220,
            use_fast=True,
            enable_action_training=True,
            stop_action_to_vlm_grad=True,
        ),
        batch_size=2048,
    ),
    TrainConfig(
        name="pi0_replicated",
        model=LAPConfig(
            action_dim=7,
            action_horizon=16,
            max_token_len=220,
            enable_action_training=True,
            enable_langact_training=False,
        ),
        batch_size=2048,
    ),
    TrainConfig(
        name="vla0_replicated",
        model=LAPConfig(
            action_dim=7,
            action_horizon=10,
            max_token_len=390,
            pi05=True,
            discrete_state_input=True,
            enable_action_training=False,
            enable_langact_training=True,
            prompt_format="vla0_chunked",
        ),
        data=DataConfig(language_action_format_name="vla0_chunked", transform_strategy="vla0"),
        batch_size=2048,
    ),
    TrainConfig(
        name="vla0_replicated_libero",
        model=LAPConfig(
            action_dim=7,
            action_horizon=10,
            max_token_len=390,
            enable_action_training=False,
            enable_langact_training=True,
            prompt_format="vla0_chunked",
            reasoning_mask_prob=0.2,
        ),
        data=_libero_data(language_action_format_name="vla0_chunked", transform_strategy="vla0"),
        lr_schedule=_FINETUNE_LR,
        save_interval=2000,
        keep_period=2000,
        num_train_steps=40_001,
        batch_size=256,
        ema_schedule_choice=_optimizer.EmaScheduleChoice(kind="cosine_delayed", start_step=1000),
    ),
    TrainConfig(
        name="lap_cotrain",
        model=LAPConfig(
            action_dim=7,
            action_horizon=16,
            max_token_len=220,
            enable_action_training=True,
            enable_prediction_training=True,
            stop_action_to_vlm_grad=True,
        ),
        batch_size=2048,
    ),
    TrainConfig(
        name="lap_libero",
        model=LAPConfig(
            action_dim=7,
            action_horizon=10,
            max_token_len=180,
            enable_action_training=True,
            stop_action_to_vlm_grad=False,
            language_loss_weight=0.4,
            enable_image_augmentation=False,
        ),
        data=_libero_data(),
        lr_schedule=_FINETUNE_LR,
        weight_loader=weight_loaders.WeightLoaderChoice(kind="checkpoint", params_path="checkpoints/lap/params"),
        save_interval=2000,
        keep_period=2000,
        num_train_steps=40_001,
        batch_size=256,
        ema_schedule_choice=_optimizer.EmaScheduleChoice(kind="constant"),
    ),
    # The Gemma3 family (LAPGemma3). The 4B config names no params_path: its
    # gemma3 weight loader raises until one is given (--weight_loader.params_path).
    TrainConfig(
        name="lap_gemma3_4b",
        model=_gemma3_model("gemma3_4b", "gemma3_300m"),
        batch_size=2048,
        weight_loader=weight_loaders.WeightLoaderChoice(kind="gemma3"),
    ),
    TrainConfig(
        name="fast_gemma3_4b",
        model=_gemma3_model("gemma3_4b", "gemma3_300m", use_fast=True),
        weight_loader=weight_loaders.WeightLoaderChoice(kind="gemma3"),
        batch_size=2048,
    ),
    TrainConfig(
        name="lap_gemma3_12b",
        model=_gemma3_model("gemma3_12b", "gemma3_300m_48"),
        weight_loader=weight_loaders.WeightLoaderChoice(kind="gemma3", params_path="checkpoints/gemma3-12b-it"),
        batch_size=2048,
    ),
    TrainConfig(
        name="lap_gemma3_27b",
        model=_gemma3_model("gemma3_27b", "gemma3_300m_62"),
        weight_loader=weight_loaders.WeightLoaderChoice(kind="gemma3", params_path="checkpoints/gemma3-27b-it"),
        batch_size=2048,
    ),
    TrainConfig(
        name="lap_gemma3_4b_libero",
        model=_gemma3_model("gemma3_4b", "gemma3_300m", action_horizon=10, language_loss_weight=0.4,
                            enable_image_augmentation=False),
        batch_size=2048,
        weight_loader=weight_loaders.WeightLoaderChoice(kind="gemma3", params_path="checkpoints/gemma3-4b-it"),
        data=_libero_data(),
        lr_schedule=_FINETUNE_LR,
        save_interval=2000,
        keep_period=2000,
        num_train_steps=40_001,
        ema_schedule_choice=_optimizer.EmaScheduleChoice(kind="cosine_delayed", start_step=1000),
    ),
    # Debug config: tiny model + synthetic data, runs anywhere.
    TrainConfig(
        name="debug",
        model=LAPConfig(
            dtype="float32",
            paligemma_variant="dummy",
            action_expert_variant="dummy",
            siglip_variant="dummy",
            action_dim=7,
            action_horizon=4,
            max_token_len=160,
            image_resolution=(56, 56),
            enable_action_training=True,
            enable_langact_training=True,
        ),
        data=DataConfig(repo_id="fake", asset_id="fake", data_mix=None, val_fraction=0.0),
        lr_schedule=_optimizer.CosineDecaySchedule(
            warmup_steps=10, peak_lr=1e-3, decay_steps=100, decay_lr=1e-4
        ),
        batch_size=8,
        num_train_steps=20,
        save_interval=10,
        log_interval=5,
        ema_decay=None,
    ),
]

if len({c.name for c in _CONFIGS}) != len(_CONFIGS):
    raise ValueError("Config names must be unique.")
_CONFIGS_DICT = {c.name: c for c in _CONFIGS}


def get_config(config_name: str) -> TrainConfig:
    if config_name in _CONFIGS_DICT:
        return _CONFIGS_DICT[config_name]
    closest = difflib.get_close_matches(config_name, _CONFIGS_DICT.keys(), n=3, cutoff=0.0)
    hint = f" Did you mean one of: {', '.join(map(repr, closest))}?" if closest else ""
    raise ValueError(f"Config {config_name!r} not found.{hint}")


def cli(argv: list[str] | None = None) -> TrainConfig:
    """``<config-name> [--field value ...]`` -> the resolved config."""
    return _cli.overridable_config_cli(_CONFIGS_DICT, argv)
