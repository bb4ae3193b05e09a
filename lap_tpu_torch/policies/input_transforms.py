"""CoTInputs: raw data samples -> model-ready inputs.

Capability parity with lihzha/lap ``policies/transforms/`` (input_transforms,
image_handler, text_utils, action_processor, sample_handlers): image
collection with wrist dropout and zero-image masking, text parsing, action
summarization (standard / VLA0), EEF-frame routing with random base-frame
selection, and the VQA / prediction / robot sample handlers.

Copied from ``lap_tpu/policies/input_transforms.py``; its imports point at
the port's copies.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np

from lap_tpu_torch.data.helpers import ActionEncoding
from lap_tpu_torch.models.types import IMAGE_KEYS
from lap_tpu_torch.policies.action_text import (
    describe_language_action_scale,
    is_idle_language_action,
    summarize_bimanual_numeric_actions,
    summarize_numeric_actions,
)
from lap_tpu_torch.policies.frame_transforms import transform_actions_to_eef_frame
from lap_tpu_torch.policies.lang_action_formats import (
    VERBOSE_EEF_WITH_ROTATION_FORMAT,
    LanguageActionFormat,
    get_language_action_format,
)
from lap_tpu_torch.policies.question_types import (
    AnswerFormat,
    QuestionConfig,
    QuestionType,
    compute_dominant_directions,
    compute_gripper_change,
    compute_motion_magnitude,
    format_delta_motion,
    get_embodiment_name,
)

# ---------------------------------------------------------------------------
# Small host-side helpers (text/image parsing)
# ---------------------------------------------------------------------------


def decode_text(value, default: str = "") -> str:
    if isinstance(value, bytes):
        return value.decode("utf-8")
    if isinstance(value, str):
        return value
    return default


def parse_dataset_name(data: dict) -> str:
    return decode_text(data.get("dataset_name"), default="")


def parse_prompt(data: dict) -> str:
    prompt = data.get("prompt")
    if prompt is None:
        raise ValueError("Prompt missing from data")
    prompt_str = decode_text(prompt, default="")
    if "r1_lite" in parse_dataset_name(data):
        prompt_str = prompt_str.split("@")[-1]
    return prompt_str


def parse_caption(data: dict) -> str:
    return decode_text(data.get("caption"), default="")


def parse_image(image) -> np.ndarray | None:
    if image is None:
        return None
    img = np.asarray(image)
    if img.dtype != np.uint8 and np.issubdtype(img.dtype, np.floating):
        # keep floats as-is; Observation.from_dict handles ranges
        return img
    return img


def pad_to_dim(x, dim: int):
    x = np.asarray(x)
    if x.shape[-1] >= dim:
        return x
    pad = [(0, 0)] * (x.ndim - 1) + [(0, dim - x.shape[-1])]
    return np.pad(x, pad)


# ---------------------------------------------------------------------------
# Image collection (image_handler.py parity)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ImageHandler:
    wrist_image_dropout_prob: float = 0.0
    random_mask_prob: float = 0.0

    @staticmethod
    def create_image_mask(image: np.ndarray, random_mask_prob: float = 0.0):
        if np.all(image == 0.0):
            if random_mask_prob > 0.0 and np.random.rand() < random_mask_prob:
                return np.True_
            return np.False_
        return np.True_

    @staticmethod
    def parse_base_image(data: dict) -> np.ndarray:
        raw = data["observation"].get(IMAGE_KEYS[0])
        if isinstance(raw, (str, bytes)) and len(raw) == 0:
            return np.zeros((224, 224, 3), dtype=np.uint8)
        img = parse_image(raw)
        if img is None:
            return np.zeros((224, 224, 3), dtype=np.uint8)
        return img

    def collect_images(
        self,
        data: dict,
        base_image: np.ndarray,
        *,
        is_prediction_sample: bool = False,
        pred_use_primary: bool = False,
        is_vqa_sample: bool = False,
    ) -> tuple[list[np.ndarray], list]:
        obs = data.get("observation", {})
        images, masks = [], []

        def add(image, mask_prob=0.0):
            images.append(image)
            masks.append(self.create_image_mask(image, mask_prob))

        mask_prob = 0.0 if is_vqa_sample else self.random_mask_prob

        if not is_prediction_sample:
            add(base_image)
            for key in IMAGE_KEYS[1:]:
                add(self._wrist(obs, key, base_image, is_vqa_sample), mask_prob)
        elif not pred_use_primary:
            for key in IMAGE_KEYS:
                img = parse_image(obs[key]) if key in obs else np.zeros_like(base_image)
                add(img)
        else:
            add(base_image)
            for key in IMAGE_KEYS[1:]:
                img = parse_image(obs[key]) if key in obs else np.zeros_like(base_image)
                add(img)
        return images, masks

    def _wrist(self, obs, key, base_image, is_vqa_sample):
        if key not in obs:
            return np.zeros_like(base_image)
        img = parse_image(obs[key])
        dropout = (
            not is_vqa_sample
            and self.wrist_image_dropout_prob > 0.0
            and np.random.rand() < float(self.wrist_image_dropout_prob)
        )
        return np.zeros_like(base_image) if dropout else img


# ---------------------------------------------------------------------------
# Action summarization (action_processor.py parity)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ActionProcessor:
    language_action_format: LanguageActionFormat
    random_base_prob: float = 0.0

    def _should_use_eef_frame(self, initial_state, has_wrist_image):
        use_eef = self.language_action_format.use_eef_frame and initial_state is not None
        if self.random_base_prob > 0.0:
            use_eef = use_eef and has_wrist_image and random.random() < (1 - self.random_base_prob)
        return use_eef, ("end-effector frame" if use_eef else "robot base frame")

    def transform_to_frame(
        self, raw_actions, initial_state, dataset_name, rotation_applied, has_wrist_image
    ):
        use_eef, frame = self._should_use_eef_frame(initial_state, has_wrist_image)
        if use_eef:
            raw_actions = transform_actions_to_eef_frame(
                raw_actions, initial_state, dataset_name, rotation_applied
            )
        return raw_actions, frame

    def summarize_language_actions(
        self,
        data: dict,
        lang_action_key: str = "language_actions",
        initial_state=None,
        dataset_name=None,
        rotation_applied: bool = False,
    ) -> tuple[str | None, str]:
        language_actions = data[lang_action_key]
        is_bimanual = data.get("is_bimanual", False)
        is_navigation = data.get("is_navigation", False)
        has_wrist_image = data.get("has_wrist_image", False)

        use_eef, frame = self._should_use_eef_frame(initial_state, has_wrist_image)
        if use_eef:
            language_actions = transform_actions_to_eef_frame(
                language_actions, initial_state, dataset_name, rotation_applied
            )

        fmt = self.language_action_format
        if is_bimanual:
            summed = summarize_bimanual_numeric_actions(
                language_actions, fmt.get_sum_decimal(), fmt.include_rotation
            )
        elif is_navigation:
            summed = summarize_numeric_actions(
                language_actions, "nearest_10", include_rotation=True, rotation_precision=10
            )
        else:
            summed = summarize_numeric_actions(
                language_actions,
                sum_decimal=fmt.get_sum_decimal(),
                include_rotation=fmt.include_rotation,
            )
        return summed, frame

    @staticmethod
    def extract_motion_components(language_actions) -> dict:
        arr = np.asarray(language_actions, dtype=float)
        if arr.ndim == 2:
            arr = arr[0]
        get = lambda i, scale, default=0.0: float(arr[i]) * scale if len(arr) > i else default
        return {
            "dx_cm": get(0, 100.0),
            "dy_cm": get(1, 100.0),
            "dz_cm": get(2, 100.0),
            "droll_deg": get(3, 180.0 / np.pi),
            "dpitch_deg": get(4, 180.0 / np.pi),
            "dyaw_deg": get(5, 180.0 / np.pi),
            "gripper": float(arr[6]) if len(arr) > 6 else 0.5,
        }


# ---------------------------------------------------------------------------
# Sample handlers (sample_handlers.py parity)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VQASampleHandler:
    enable_diverse_questions: bool = False

    def process(self, data: dict, inputs: dict) -> dict:
        inputs["language_actions"] = parse_caption(data)
        inputs["sample_mask"] = True
        return inputs


@dataclasses.dataclass
class PredictionSampleHandler:
    question_config: QuestionConfig
    action_processor: ActionProcessor

    def process(self, data, inputs, dataset_name, rotation_applied) -> dict:
        raw = data.get("language_actions")
        if raw is None:
            inputs["sample_mask"] = True
            return inputs
        raw = np.asarray(raw, dtype=float)
        initial_state = np.asarray(data.get("raw_state", np.zeros(10)))
        has_wrist = data.get("has_wrist_image", False)

        transformed, frame = self.action_processor.transform_to_frame(
            raw, initial_state, dataset_name, rotation_applied, has_wrist
        )
        mc = ActionProcessor.extract_motion_components(transformed)
        rng = np.random.default_rng()
        qtype = self.question_config.sample_question_type(rng)
        prompt, answer = self._qa(data, inputs, qtype, mc, dataset_name, initial_state, frame, rng)

        if qtype == QuestionType.TEMPORAL_ORDERING and inputs.pop("_temporal_swap", False):
            self._swap_images(inputs)
        inputs.pop("_temporal_swap", None)

        inputs["prompt"] = prompt
        inputs["language_actions"] = answer
        inputs["frame_description"] = frame
        inputs["sample_mask"] = True
        return inputs

    def _qa(self, data, inputs, qtype, mc, dataset_name, initial_state, frame, rng):
        cfg = self.question_config
        grip_action = "open gripper" if mc["gripper"] >= 0.5 else "close gripper"
        args = (mc["dx_cm"], mc["dy_cm"], mc["dz_cm"], mc["droll_deg"], mc["dpitch_deg"], mc["dyaw_deg"])

        if qtype == QuestionType.TASK_PREDICTION:
            template = cfg.get_prompt_template(qtype, rng)
            desc = format_delta_motion(*args, grip_action, answer_format=AnswerFormat.VERBOSE)
            return template.format(action=desc), parse_prompt(data)
        if qtype == QuestionType.DIRECTION_CLASSIFICATION:
            return cfg.get_prompt_template(qtype, rng), compute_dominant_directions(
                mc["dx_cm"], mc["dy_cm"], mc["dz_cm"]
            )
        if qtype == QuestionType.GRIPPER_PREDICTION:
            initial_gripper = initial_state[6] if len(initial_state) > 6 else 0.5
            return cfg.get_prompt_template(qtype, rng), compute_gripper_change(
                initial_gripper, mc["gripper"]
            )
        if qtype == QuestionType.MAGNITUDE_ESTIMATION:
            return cfg.get_prompt_template(qtype, rng), compute_motion_magnitude(
                mc["dx_cm"], mc["dy_cm"], mc["dz_cm"]
            )
        if qtype == QuestionType.TEMPORAL_ORDERING:
            template = cfg.get_prompt_template(qtype, rng)
            desc = format_delta_motion(*args, grip_action, answer_format=AnswerFormat.VERBOSE)
            swap = rng.random() < 0.5
            inputs["_temporal_swap"] = swap
            return template.format(action=desc), ("second" if swap else "first")
        if qtype == QuestionType.EMBODIMENT_IDENTIFICATION:
            return cfg.get_prompt_template(qtype, rng), get_embodiment_name(dataset_name)
        # DELTA_MOTION (default)
        answer_format = cfg.sample_answer_format(rng)
        prompt = cfg.get_prompt_template(QuestionType.DELTA_MOTION, rng, frame_description=frame)
        return prompt, format_delta_motion(*args, grip_action, answer_format=answer_format)

    @staticmethod
    def _swap_images(inputs):
        images = inputs.get("image")
        if not images or len(images) < 2:
            return
        k0, k1 = list(images.keys())[:2]
        images[k0], images[k1] = images[k1], images[k0]
        masks = inputs.get("image_mask")
        if masks:
            masks[k0], masks[k1] = masks[k1], masks[k0]


@dataclasses.dataclass
class RobotSampleHandler:
    language_action_format: LanguageActionFormat
    action_processor: ActionProcessor
    enable_langact_training: bool = True
    use_rough_scale: bool = False
    enable_diverse_questions: bool = False
    transform_strategy: str = "standard"

    def process(self, data, inputs, dataset_name, rotation_applied) -> dict:
        if self.transform_strategy == "vla0":
            if "actions" in inputs:
                inputs["language_actions"] = self.language_action_format.summarize_actions(
                    inputs["actions"]
                )
            else:
                inputs["language_actions"] = ""
            inputs["frame_description"] = "normalized"
            inputs["sample_mask"] = True
            return inputs

        if "language_actions" in data and self.enable_langact_training:
            initial_state = np.asarray(data["raw_state"])
            lang, frame = self.action_processor.summarize_language_actions(
                data, "language_actions", initial_state, dataset_name, rotation_applied
            )
            inputs["language_actions"] = lang
            inputs["frame_description"] = frame
            if self.use_rough_scale:
                inputs["language_actions"] = describe_language_action_scale(lang)
                inputs["sample_mask"] = True
            else:
                fmt = self.language_action_format
                inputs["sample_mask"] = not is_idle_language_action(
                    inputs["language_actions"], fmt.get_sum_decimal(), fmt.include_rotation
                )
            return inputs

        inputs["sample_mask"] = True
        return inputs


# ---------------------------------------------------------------------------
# The main input transform
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CoTInputs:
    """Transform raw data samples into model-ready inputs (lap_tpu flavor of
    reference CoTInputs, input_transforms.py:25-249)."""

    action_dim: int
    language_action_format: LanguageActionFormat | str = dataclasses.field(
        default_factory=lambda: VERBOSE_EEF_WITH_ROTATION_FORMAT
    )
    wrist_image_dropout_prob: float = 0.0
    model_type: str = "lap"
    action_encoding: ActionEncoding = ActionEncoding.EEF_POS
    enable_langact_training: bool = True
    use_rough_scale: bool = False
    transform_strategy: str = "standard"
    random_base_prob: float = 0.0
    random_mask_prob: float = 0.0
    enable_diverse_questions: bool = False
    question_config: QuestionConfig | None = None

    def __post_init__(self):
        fmt = self.language_action_format
        if isinstance(fmt, str):
            object.__setattr__(self, "language_action_format", get_language_action_format(fmt))
        if self.enable_diverse_questions and self.question_config is None:
            object.__setattr__(self, "question_config", QuestionConfig())

    def _action_processor(self):
        return ActionProcessor(
            language_action_format=self.language_action_format,
            random_base_prob=self.random_base_prob,
        )

    def _prepare_inputs(self, data: dict) -> tuple[dict, bool]:
        if self.model_type not in ("lap", "lap_fast", "pi0_fast"):
            raise ValueError(f"unsupported model type: {self.model_type}")
        if "observation" not in data:
            raise ValueError("data missing 'observation'")

        handler = ImageHandler(
            wrist_image_dropout_prob=self.wrist_image_dropout_prob,
            random_mask_prob=self.random_mask_prob,
        )
        dataset_name = parse_dataset_name(data)
        is_prediction_sample = data.get("is_prediction_sample", False)
        pred_use_primary = data.get("pred_use_primary", False)
        is_vqa_sample = data.get("is_vqa_sample", False)

        base_image = ImageHandler.parse_base_image(data)
        images, image_masks = handler.collect_images(
            data,
            base_image,
            is_prediction_sample=is_prediction_sample,
            pred_use_primary=pred_use_primary,
            is_vqa_sample=is_vqa_sample,
        )
        if self.model_type == "lap_fast":
            image_masks = [np.True_ for _ in image_masks]

        inputs = {
            "state": data["observation"]["state"],
            "image": dict(zip(IMAGE_KEYS, images, strict=True)),
            "image_mask": dict(zip(IMAGE_KEYS, image_masks, strict=True)),
            "prompt": parse_prompt(data),
            "is_prediction_sample": is_prediction_sample,
        }
        if dataset_name:
            inputs["dataset_name"] = dataset_name
        if "frame_description" in data:
            inputs["frame_description"] = decode_text(
                data["frame_description"], default="robot base frame"
            )
        if "actions" in data:
            inputs["actions"] = np.array(pad_to_dim(data["actions"], self.action_dim))
        return inputs, data.get("rotation_applied", False)

    def __call__(self, data: dict) -> dict:
        inputs, rotation_applied = self._prepare_inputs(data)
        dataset_name = parse_dataset_name(data)
        is_vqa_sample = data.get("is_vqa_sample", False)
        is_prediction_sample = data.get("is_prediction_sample", False)

        inputs["is_vqa_sample"] = is_vqa_sample
        inputs["time_horizon_seconds"] = data.get("time_horizon_seconds")
        inputs["vqa_dataset_id"] = data.get("vqa_dataset_id", 0)

        if is_vqa_sample:
            return VQASampleHandler(self.enable_diverse_questions).process(data, inputs)

        if is_prediction_sample:
            inputs["prompt"] = "predict the robot's action between two images in the prediction"
            if self.enable_diverse_questions and self.question_config is not None:
                return PredictionSampleHandler(
                    question_config=self.question_config,
                    action_processor=self._action_processor(),
                ).process(data, inputs, dataset_name, rotation_applied)

        if self.language_action_format.include_rotation and self.action_encoding != ActionEncoding.EEF_POS:
            raise ValueError("Rotation only supported for EEF_POS encoding")

        return RobotSampleHandler(
            language_action_format=self.language_action_format,
            action_processor=self._action_processor(),
            enable_langact_training=self.enable_langact_training,
            use_rough_scale=self.use_rough_scale,
            enable_diverse_questions=self.enable_diverse_questions,
            transform_strategy=self.transform_strategy,
        ).process(data, inputs, dataset_name, rotation_applied)
