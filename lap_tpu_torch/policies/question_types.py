"""Prediction-training question generation.

Behavioral parity with lihzha/lap ``policies/question_types.py``: seven
question types with weighted sampling, prompt-template pools, and the delta-
motion answer formats (verbose / compact / qualitative / component / json /
sentence / direction-only).

Copied from ``lap_tpu/policies/question_types.py``; its imports point at the
port's copies.
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass

import numpy as np


class QuestionType(enum.Enum):
    DELTA_MOTION = "delta_motion"
    TASK_PREDICTION = "task_prediction"
    DIRECTION_CLASSIFICATION = "direction_classification"
    GRIPPER_PREDICTION = "gripper_prediction"
    MAGNITUDE_ESTIMATION = "magnitude_estimation"
    TEMPORAL_ORDERING = "temporal_ordering"
    EMBODIMENT_IDENTIFICATION = "embodiment_identification"


class AnswerFormat(enum.Enum):
    VERBOSE = "verbose"
    VERBOSE_WITH_ROTATION = "verbose_with_rotation"
    COMPACT = "compact"
    COMPACT_WITH_ROTATION = "compact_with_rotation"
    QUALITATIVE = "qualitative"
    COMPONENT = "component"
    JSON = "json"
    SENTENCE = "sentence"
    DIRECTION_ONLY = "direction_only"


DELTA_MOTION_PROMPTS = [
    "Describe the robot's motion between these two frames{frame_ref}",
    "What movement did the robot make from the first image to the second{frame_ref}?",
    "Predict the change in robot position shown in these images{frame_ref}",
    "Given these before and after images, what action was taken{frame_ref}?",
    "Analyze the visual difference and describe the robot's movement{frame_ref}",
    "What is the delta motion between these two images{frame_ref}?",
    "Describe how the robot end-effector moved between frames{frame_ref}",
    "What movement occurred between these two observations{frame_ref}?",
    "Characterize the robot motion from the image pair{frame_ref}",
    "From image 1 to image 2, describe the robot's action{frame_ref}",
]
TASK_PREDICTION_PROMPTS = [
    "What task is the robot performing given this motion: {action}?",
    "Based on the action '{action}', what is the robot trying to accomplish?",
    "Given the robot moved as follows: {action}, what is the task?",
    "Identify the task from this robot motion: {action}",
    "The robot performed: {action}. What task does this correspond to?",
    "What goal is the robot working towards with this action: {action}?",
]
DIRECTION_CLASSIFICATION_PROMPTS = [
    "What is the dominant motion direction shown in these images?",
    "In which direction(s) did the robot primarily move?",
    "Classify the main movement direction between these frames",
    "What are the primary motion axes in this image pair?",
    "Describe the dominant direction of robot movement",
]
GRIPPER_PREDICTION_PROMPTS = [
    "Did the gripper open, close, or stay the same between these images?",
    "What happened to the gripper state?",
    "Predict the gripper state change from image 1 to image 2",
    "How did the gripper position change?",
    "Was there a gripper action between these frames?",
]
MAGNITUDE_ESTIMATION_PROMPTS = [
    "How much did the robot move between these images?",
    "Estimate the magnitude of the robot's motion",
    "Is the movement between these frames small, moderate, or large?",
    "Characterize the distance traveled by the robot",
    "What is the scale of the robot's displacement?",
]
TEMPORAL_ORDERING_PROMPTS = [
    "Given the robot action '{action}', which image shows the earlier state - the first or second image?",
    "The robot performed: {action}. In what order do these images appear in the trajectory?",
    "Between these frames the robot did: {action}. Which frame came first chronologically?",
    "Given the motion '{action}', determine the temporal order of these two observations",
    "The robot moved as follows: {action}. Is image 1 before or after image 2 in the sequence?",
]
EMBODIMENT_IDENTIFICATION_PROMPTS = [
    "What robot or dataset is this image from?",
    "Identify the robot embodiment shown in this image",
    "What type of robot is performing this task?",
    "Which dataset does this observation come from?",
    "Classify the robot platform shown here",
]

_PROMPT_POOLS = {
    QuestionType.DELTA_MOTION: DELTA_MOTION_PROMPTS,
    QuestionType.TASK_PREDICTION: TASK_PREDICTION_PROMPTS,
    QuestionType.DIRECTION_CLASSIFICATION: DIRECTION_CLASSIFICATION_PROMPTS,
    QuestionType.GRIPPER_PREDICTION: GRIPPER_PREDICTION_PROMPTS,
    QuestionType.MAGNITUDE_ESTIMATION: MAGNITUDE_ESTIMATION_PROMPTS,
    QuestionType.TEMPORAL_ORDERING: TEMPORAL_ORDERING_PROMPTS,
    QuestionType.EMBODIMENT_IDENTIFICATION: EMBODIMENT_IDENTIFICATION_PROMPTS,
}


def _round_to_nearest_n(value: float, n: int = 5) -> int:
    return int(round(value / n) * n)


def _format_numeric(val: float, decimals: int = 0) -> str:
    return f"{val:.{decimals}f}"


_ONES = "zero one two three four five six seven eight nine ten eleven twelve thirteen fourteen fifteen sixteen seventeen eighteen nineteen".split()
_TENS = "zero ten twenty thirty forty fifty sixty seventy eighty ninety".split()


def _num_to_words(n: int) -> str:
    n = int(n)
    if n < 0:
        return "minus " + _num_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, ones = divmod(n, 10)
        return _TENS[tens] + (f"-{_ONES[ones]}" if ones else "")
    return str(n)


# Per-axis description tables: (value key, positive word, negative word).
_TRANS_AXES = (("dx", "forward", "backward"), ("dy", "left", "right"), ("dz", "up", "down"))
_ROT_AXES = (
    ("droll", "tilt left", "tilt right"),
    ("dpitch", "tilt back", "tilt forward"),
    ("dyaw", "rotate counterclockwise", "rotate clockwise"),
)


def format_delta_motion_verbose(
    dx_cm, dy_cm, dz_cm, droll_deg=0, dpitch_deg=0, dyaw_deg=0,
    gripper_action="", include_rotation=False, decimals=0,
) -> str:
    parts = []
    # Order matches the reference: x, z, y.
    for raw, pos, neg in ((dx_cm, "move forward", "move back"),
                          (dz_cm, "move up", "move down"),
                          (dy_cm, "move left", "move right")):
        mag = round(abs(raw), decimals)
        if raw > 0 and mag != 0:
            parts.append(f"{pos} {_format_numeric(mag, decimals)} cm")
        elif raw < 0 and mag != 0:
            parts.append(f"{neg} {_format_numeric(mag, decimals)} cm")
    if include_rotation:
        for raw, pos, neg in ((droll_deg, "tilt left", "tilt right"),
                              (dpitch_deg, "tilt back", "tilt forward"),
                              (dyaw_deg, "rotate counterclockwise", "rotate clockwise")):
            mag = _round_to_nearest_n(abs(raw), 10)
            if raw > 0 and mag != 0:
                parts.append(f"{pos} {mag} degrees")
            elif raw < 0 and mag != 0:
                parts.append(f"{neg} {mag} degrees")
    if gripper_action:
        parts.append(gripper_action)
    return ", ".join(parts) if parts else "no movement"


def format_delta_motion_compact(
    dx_cm, dy_cm, dz_cm, droll_deg=0, dpitch_deg=0, dyaw_deg=0,
    gripper_binary=0, include_rotation=False,
) -> str:
    parts = [f"{int(round(v)):+03d}" for v in (dx_cm, dy_cm, dz_cm)]
    if include_rotation:
        parts += [f"{_round_to_nearest_n(v, 5):+03d}" for v in (droll_deg, dpitch_deg, dyaw_deg)]
    parts.append(str(gripper_binary))
    return "<" + " ".join(parts) + ">"


def format_delta_motion_qualitative(
    dx_cm, dy_cm, dz_cm, droll_deg=0, dpitch_deg=0, dyaw_deg=0,
    gripper_action="", include_rotation=False,
) -> str:
    def trans_word(cm):
        cm = abs(cm)
        return "slightly" if cm < 1.5 else ("moderately" if cm < 5 else "significantly")

    def rot_word(deg):
        deg = abs(deg)
        return "slightly" if deg < 10 else ("moderately" if deg < 30 else "significantly")

    parts = []
    trans = []
    for raw, pos, neg in ((dx_cm, "forward", "backward"), (dy_cm, "left", "right"), (dz_cm, "up", "down")):
        if abs(raw) >= 0.5:
            trans.append(f"{trans_word(raw)} {pos if raw > 0 else neg}")
    if trans:
        parts.append("move " + " and ".join(trans))
    if include_rotation:
        rots = []
        for raw, pos, neg in ((droll_deg, "tilt left", "tilt right"),
                              (dpitch_deg, "tilt back", "tilt forward"),
                              (dyaw_deg, "rotate counterclockwise", "rotate clockwise")):
            if abs(raw) >= 5:
                rots.append(f"{rot_word(raw)} {pos if raw > 0 else neg}")
        if rots:
            parts.append(" and ".join(rots))
    if gripper_action:
        parts.append(f"then {gripper_action}" if parts else gripper_action)
    return ", ".join(parts) if parts else "remain stationary"


def format_delta_motion_component(
    dx_cm, dy_cm, dz_cm, droll_deg=0, dpitch_deg=0, dyaw_deg=0,
    gripper_action="", include_rotation=False, decimals=1,
) -> str:
    parts = [
        f"translation: ({round(dx_cm, decimals)}, {round(dy_cm, decimals)}, {round(dz_cm, decimals)}) cm"
    ]
    if include_rotation:
        parts.append(
            f"rotation: ({round(droll_deg, decimals)}, {round(dpitch_deg, decimals)}, {round(dyaw_deg, decimals)}) deg"
        )
    if gripper_action:
        parts.append(f"gripper: {gripper_action}")
    return "; ".join(parts)


def format_delta_motion_json(
    dx_cm, dy_cm, dz_cm, droll_deg=0, dpitch_deg=0, dyaw_deg=0,
    gripper_action="", include_rotation=False, decimals=1,
) -> str:
    data = {
        "dx_cm": round(dx_cm, decimals),
        "dy_cm": round(dy_cm, decimals),
        "dz_cm": round(dz_cm, decimals),
    }
    if include_rotation:
        data["droll_deg"] = round(droll_deg, decimals)
        data["dpitch_deg"] = round(dpitch_deg, decimals)
        data["dyaw_deg"] = round(dyaw_deg, decimals)
    if gripper_action:
        data["gripper"] = gripper_action
    return json.dumps(data)


def format_delta_motion_sentence(
    dx_cm, dy_cm, dz_cm, droll_deg=0, dpitch_deg=0, dyaw_deg=0,
    gripper_action="", include_rotation=False,
) -> str:
    parts = []
    for raw, pos, neg in ((dx_cm, "forward", "backward"), (dy_cm, "left", "right"), (dz_cm, "up", "down")):
        mag = int(round(abs(raw)))
        if mag >= 1:
            word = pos if raw > 0 else neg
            parts.append(f"{word} by {_num_to_words(mag)} centimeter{'s' if mag != 1 else ''}")
    if not parts:
        sentence = "The robot remained stationary"
    elif len(parts) == 1:
        sentence = f"The robot moved {parts[0]}"
    elif len(parts) == 2:
        sentence = f"The robot moved {parts[0]} and {parts[1]}"
    else:
        sentence = f"The robot moved {', '.join(parts[:-1])}, and {parts[-1]}"
    if gripper_action == "open gripper":
        sentence += " while opening the gripper"
    elif gripper_action == "close gripper":
        sentence += " while closing the gripper"
    return sentence + "."


def format_delta_motion_direction_only(
    dx_cm, dy_cm, dz_cm, droll_deg=0, dpitch_deg=0, dyaw_deg=0,
    gripper_action="", include_rotation=False,
) -> str:
    parts = []
    for raw, pos, neg in ((dx_cm, "forward", "backward"), (dy_cm, "left", "right"), (dz_cm, "up", "down")):
        if abs(raw) >= 0.5:
            parts.append(pos if raw > 0 else neg)
    if include_rotation:
        for raw, pos, neg in ((droll_deg, "tilt left", "tilt right"),
                              (dpitch_deg, "tilt back", "tilt forward"),
                              (dyaw_deg, "rotate counterclockwise", "rotate clockwise")):
            if abs(raw) >= 5:
                parts.append(pos if raw > 0 else neg)
    if gripper_action:
        parts.append(gripper_action)
    return ", ".join(parts) if parts else "no movement"


def compute_dominant_directions(dx_cm, dy_cm, dz_cm, threshold_cm=1.0) -> str:
    directions = []
    for raw, pos, neg in ((dx_cm, "forward", "backward"), (dy_cm, "left", "right"), (dz_cm, "up", "down")):
        if raw > threshold_cm:
            directions.append(pos)
        elif raw < -threshold_cm:
            directions.append(neg)
    return " and ".join(directions) if directions else "stationary"


def compute_gripper_change(gripper_start: float, gripper_end: float) -> str:
    if gripper_end > 0.5 >= gripper_start:
        return "opened"
    if gripper_end <= 0.5 < gripper_start:
        return "closed"
    return "unchanged"


def compute_motion_magnitude(dx_cm, dy_cm, dz_cm) -> str:
    l2 = float(np.sqrt(dx_cm**2 + dy_cm**2 + dz_cm**2))
    if l2 < 2.0:
        return "small movement"
    if l2 < 6.0:
        return "moderate movement"
    return "large movement"


_EMBODIMENTS = {
    "droid": "DROID (Franka Panda)",
    "bridge": "Bridge (WidowX)",
    "bridge_dataset": "Bridge (WidowX)",
    "fractal": "Fractal (Google Robot)",
    "rt_1_x": "RT-1 (Google Robot)",
    "kuka": "KUKA Robot",
    "fmb": "FMB (Franka Manipulation Benchmark)",
    "taco_play": "TACO Play",
    "jaco_play": "Jaco Play (Kinova Jaco)",
    "berkeley_autolab_ur5": "Berkeley Autolab (UR5)",
    "furniture_bench": "Furniture Bench (Franka)",
    "austin_buds": "Austin BUDS (Franka)",
    "austin_sirius": "Austin Sirius (Franka)",
    "austin_sailor": "Austin Sailor (Franka)",
    "utaustin_mutex": "UT Austin MUTEX (Franka)",
    "viola": "VIOLA (Franka)",
    "cmu_stretch": "CMU Stretch (Hello Robot)",
    "dobbe": "DOBBE (Hello Robot)",
    "iamlab_cmu_pickup_insert": "CMU IAM Lab (Franka)",
}


def get_embodiment_name(dataset_name: str) -> str:
    low = dataset_name.lower()
    for key, value in _EMBODIMENTS.items():
        if key in low:
            return value
    return dataset_name


@dataclass
class QuestionConfig:
    """Weighted sampling over question types / delta-motion answer formats."""

    type_weights: dict | None = None
    delta_motion_format_weights: dict | None = None
    use_diverse_prompts: bool = True

    def __post_init__(self):
        if self.type_weights is None:
            self.type_weights = {
                QuestionType.DELTA_MOTION.value: 0.55,
                QuestionType.TASK_PREDICTION.value: 0.15,
                QuestionType.DIRECTION_CLASSIFICATION.value: 0.15,
                QuestionType.GRIPPER_PREDICTION.value: 0.05,
                QuestionType.MAGNITUDE_ESTIMATION.value: 0.05,
                QuestionType.TEMPORAL_ORDERING.value: 0.05,
            }
        if self.delta_motion_format_weights is None:
            self.delta_motion_format_weights = {
                AnswerFormat.VERBOSE.value: 0.35,
                AnswerFormat.VERBOSE_WITH_ROTATION.value: 0.15,
                AnswerFormat.QUALITATIVE.value: 0.2,
                AnswerFormat.COMPACT.value: 0.0,
                AnswerFormat.COMPACT_WITH_ROTATION.value: 0.05,
                AnswerFormat.COMPONENT.value: 0.08,
                AnswerFormat.JSON.value: 0.05,
                AnswerFormat.SENTENCE.value: 0.05,
                AnswerFormat.DIRECTION_ONLY.value: 0.02,
            }

    def _weighted_choice(self, table: dict, rng) -> str:
        keys = list(table.keys())
        w = np.array([table[k] for k in keys], dtype=float)
        return rng.choice(keys, p=w / w.sum())

    def sample_question_type(self, rng=None) -> QuestionType:
        rng = rng or np.random.default_rng()
        return QuestionType(self._weighted_choice(self.type_weights, rng))

    def sample_answer_format(self, rng=None) -> AnswerFormat:
        rng = rng or np.random.default_rng()
        return AnswerFormat(self._weighted_choice(self.delta_motion_format_weights, rng))

    def get_prompt_template(self, question_type, rng=None, frame_description="") -> str:
        rng = rng or np.random.default_rng()
        prompts = _PROMPT_POOLS.get(question_type, DELTA_MOTION_PROMPTS)
        template = rng.choice(prompts) if self.use_diverse_prompts else prompts[0]
        if question_type == QuestionType.DELTA_MOTION and "{frame_ref}" in template:
            frame_ref = f" (in {frame_description})" if frame_description else ""
            template = template.format(frame_ref=frame_ref)
        return template


_FORMATTERS = {
    AnswerFormat.VERBOSE: (format_delta_motion_verbose, False),
    AnswerFormat.VERBOSE_WITH_ROTATION: (format_delta_motion_verbose, True),
    # None = rotation included only when significant (>= 5 deg on any axis);
    # the reference's dynamic set is EXACTLY component/json/qualitative
    # (question_types.py:707-715) — sentence and direction_only never
    # include rotation.
    AnswerFormat.QUALITATIVE: (format_delta_motion_qualitative, None),
    AnswerFormat.COMPONENT: (format_delta_motion_component, None),
    AnswerFormat.JSON: (format_delta_motion_json, None),
    AnswerFormat.SENTENCE: (format_delta_motion_sentence, False),
    AnswerFormat.DIRECTION_ONLY: (format_delta_motion_direction_only, False),
}


def format_delta_motion(
    dx_cm, dy_cm, dz_cm, droll_deg=0, dpitch_deg=0, dyaw_deg=0,
    gripper_action="", answer_format=AnswerFormat.VERBOSE,
) -> str:
    has_rotation = abs(droll_deg) >= 5 or abs(dpitch_deg) >= 5 or abs(dyaw_deg) >= 5
    gripper_binary = 1 if "open" in gripper_action.lower() else 0
    if answer_format in (AnswerFormat.COMPACT, AnswerFormat.COMPACT_WITH_ROTATION):
        return format_delta_motion_compact(
            dx_cm, dy_cm, dz_cm, droll_deg, dpitch_deg, dyaw_deg,
            gripper_binary,
            include_rotation=answer_format == AnswerFormat.COMPACT_WITH_ROTATION,
        )
    fn, fixed_rot = _FORMATTERS.get(answer_format, _FORMATTERS[AnswerFormat.VERBOSE])
    include_rotation = fixed_rot if fixed_rot is not None else has_rotation
    return fn(
        dx_cm, dy_cm, dz_cm, droll_deg, dpitch_deg, dyaw_deg,
        gripper_action, include_rotation=include_rotation,
    )
