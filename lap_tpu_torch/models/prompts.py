"""Prompt construction: modular formats, state discretization, token checkers.

Capability parity with lihzha/lap ``src/lap/models/prompt_utils/``
(prompt.py, state.py, checkers.py): composable Prefix/Task/State/Action
modules, the LAP prompt format ("Task: ...; State: ...; Answer: "), VLA0's
integer-grid format, the seven prediction-question formats, 256-bin state
discretization over [-1, 1] with zero-pad trimming, and the critical /
number / direction token-piece checkers.

Copied from ``lap_tpu/models/prompts.py``; its imports point at the port's
copies.
"""

from __future__ import annotations

import dataclasses
import random
import re
from collections.abc import Callable

import numpy as np

# ---------------------------------------------------------------------------
# Token-piece checkers (checkers.py parity)
# ---------------------------------------------------------------------------


def is_number(piece: str) -> bool:
    return bool(re.search(r"[0-9]", piece))


_DIRECTIONAL_WORDS = (
    "right", "left", "forward", "up", "down", "back", "clockwise", "counterclockwise",
)


def is_direction_natural(piece: str) -> bool:
    low = piece.lower()
    return any(w in low for w in _DIRECTIONAL_WORDS)


def is_direction_schema(piece: str) -> bool:
    return "+" in piece or "-" in piece


def is_direction_none(piece: str) -> bool:
    return False


def is_critical_directional(piece: str) -> bool:
    return is_number(piece) or is_direction_natural(piece)


def is_critical_schema(piece: str) -> bool:
    return is_number(piece) or is_direction_schema(piece)


def is_critical_default(piece: str) -> bool:
    return is_number(piece)


# ---------------------------------------------------------------------------
# State discretization (state.py parity)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StateDiscretizationConfig:
    bins: int = 256
    min_dim: int = 10  # keep at least this many dims when trimming zero pad
    range_min: float = -1.0
    range_max: float = 1.0

    def discretize_state(self, state: np.ndarray) -> str:
        state_arr = np.asarray(state)
        eps = 1e-8
        if state_arr.ndim == 1:
            nz = np.abs(state_arr) > eps
            last = int(np.nonzero(nz)[0][-1]) + 1 if np.any(nz) else 0
            trimmed = state_arr[: max(last, self.min_dim)]
        else:
            flat = state_arr.reshape(-1, state_arr.shape[-1])
            nz = np.any(np.abs(flat) > eps, axis=0)
            last = int(np.nonzero(nz)[0][-1]) + 1 if np.any(nz) else 0
            trimmed = state_arr[..., : max(last, self.min_dim)].reshape(-1)
        if trimmed.size == 0:
            return ""
        bins = np.linspace(self.range_min, self.range_max, self.bins + 1)[:-1]
        disc = np.digitize(trimmed, bins=bins) - 1
        return " ".join(map(str, disc))


@dataclasses.dataclass
class StateModule:
    discretization: StateDiscretizationConfig
    state_prefix_template: str = "State{state_label}: {state}"
    include_state_type: bool = True

    def format_state(self, state=None, state_type: str | None = None) -> str:
        if state is None or state_type == "none":
            label = "None" if self.include_state_type else ""
            return self.state_prefix_template.format(state="", state_label=label)
        state_str = self.discretization.discretize_state(state)
        labels = {"joint_pos": " (joint position)", "eef_pose": " (end-effector pose)"}
        label = labels.get(state_type, state_type) if state_type else ""
        if not self.include_state_type:
            label = ""
        return self.state_prefix_template.format(state=state_str, state_label=label)


# ---------------------------------------------------------------------------
# Prompt modules (prompt.py parity)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PrefixModule:
    text: str

    def format_prefix(self) -> str:
        return self.text


@dataclasses.dataclass
class TaskModule:
    template: str = "Task: {prompt}, predict the robot's action in the {frame_description}"
    include_time_horizon: bool = False
    time_horizon_template: str = (
        "predict the robot's action in the future {time_horizon_seconds} seconds in the {frame_description}"
    )

    def format_task(self, prompt, time_horizon_seconds=None, frame_description="robot base frame"):
        cleaned = prompt.strip().replace("_", " ").replace("\n", " ").rstrip(".")
        if self.include_time_horizon:
            if time_horizon_seconds is None:
                raise ValueError("time horizon required")
            cleaned += ", " + self.time_horizon_template.format(
                time_horizon_seconds=round(time_horizon_seconds * 2) / 2.0
            )
        return self.template.format(prompt=cleaned, frame_description=frame_description)


@dataclasses.dataclass
class ActionModule:
    prefix: str = "Action: "

    def format_action_prefix(self) -> str:
        return self.prefix


@dataclasses.dataclass
class PromptFormat:
    name: str
    prefix_module: PrefixModule | None = None
    task_module: TaskModule | None = None
    state_module: StateModule | None = None
    action_module: ActionModule | None = None
    separator: str = ""
    critical_token_checker: Callable[[str], bool] | None = is_critical_default
    direction_token_checker: Callable[[str], bool] | None = is_direction_none

    @property
    def include_state(self) -> bool:
        return self.state_module is not None

    def format_prompt(
        self,
        prompt: str,
        state=None,
        state_type=None,
        time_horizon_seconds=None,
        frame_description: str = "robot base frame",
        state_dropout: float = 0.0,
    ) -> str:
        parts = []
        if self.prefix_module is not None:
            parts.append(self.prefix_module.format_prefix())
        if self.task_module is not None:
            parts.append(
                self.task_module.format_task(
                    prompt=prompt,
                    time_horizon_seconds=time_horizon_seconds,
                    frame_description=frame_description,
                )
            )
        add_state = not (
            self.state_module is None
            or state is None
            or (state_dropout > 0.0 and random.random() < state_dropout)
        )
        if add_state:
            state_str = self.state_module.format_state(state=state, state_type=state_type)
            if state_str:
                parts.append(state_str)
        if self.action_module is not None:
            parts.append(self.action_module.format_action_prefix())
        return self.separator.join(parts)


_STATE_256 = StateModule(
    discretization=StateDiscretizationConfig(bins=256),
    state_prefix_template="State{state_label}: {state}",
    include_state_type=False,
)

LAP_PROMPT_FORMAT = PromptFormat(
    name="lap",
    task_module=TaskModule(include_time_horizon=False),
    state_module=_STATE_256,
    action_module=ActionModule(prefix="Answer: "),
    separator="; ",
    critical_token_checker=is_critical_directional,
    direction_token_checker=is_direction_natural,
)

DEFAULT_PREDICTION_PROMPT_FORMAT = PromptFormat(
    name="default_prediction",
    state_module=_STATE_256,
    task_module=TaskModule(template="Task: {prompt}", include_time_horizon=False),
    separator="; ",
    action_module=ActionModule(prefix="Answer: "),
    critical_token_checker=is_critical_schema,
    direction_token_checker=is_direction_schema,
)

DEFAULT_VQA_PROMPT_FORMAT = PromptFormat(
    name="default_vqa",
    state_module=None,
    task_module=TaskModule(template="Task: {prompt}", include_time_horizon=False),
    action_module=ActionModule(prefix="Answer: "),
    separator="; ",
    critical_token_checker=None,
    direction_token_checker=None,
)

VLA0_CHUNKED_PROMPT_FORMAT = PromptFormat(
    name="vla0_chunked",
    prefix_module=PrefixModule(
        "Analyze the input image and predict robot actions for the next 10 timesteps. "
        "Each action has 7 dimensions. Output a single sequence of 70 integers (0-1000 each), "
        "representing the 10 timesteps sequentially. Provide only space-separated numbers. Nothing else."
    ),
    task_module=TaskModule(template="Task: {prompt}", include_time_horizon=False),
    state_module=None,
    action_module=ActionModule(prefix=""),
    separator="\n",
    critical_token_checker=is_number,
    direction_token_checker=is_direction_none,
)


def _simple_prediction_format(name, critical=None, direction=None):
    return PromptFormat(
        name=name,
        state_module=None,
        task_module=TaskModule(template="Task: {prompt}", include_time_horizon=False),
        action_module=ActionModule(prefix="Answer: "),
        separator="; ",
        critical_token_checker=critical,
        direction_token_checker=direction,
    )


PROMPT_FORMAT_REGISTRY = {
    "lap": LAP_PROMPT_FORMAT,
    "vla0_chunked": VLA0_CHUNKED_PROMPT_FORMAT,
}

PREDICTION_PROMPT_FORMAT_REGISTRY = {
    "default": DEFAULT_PREDICTION_PROMPT_FORMAT,
    "task_prediction": _simple_prediction_format("task_prediction"),
    "direction_classification": _simple_prediction_format(
        "direction_classification", is_direction_natural, is_direction_natural
    ),
    "gripper_prediction": _simple_prediction_format("gripper_prediction"),
    "magnitude_estimation": _simple_prediction_format("magnitude_estimation"),
    "temporal_ordering": _simple_prediction_format("temporal_ordering"),
    "embodiment_identification": _simple_prediction_format("embodiment_identification"),
}
