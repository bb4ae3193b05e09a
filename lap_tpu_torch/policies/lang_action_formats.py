"""Language-action formats: formatting styles + parsers back to deltas.

Behavioral parity with lihzha/lap ``policies/lang_action_formats.py``:
verbose / compact styles with the reference's regex grammar and sign
conventions, optional EEF-frame transform on parse, and the VLA-0
integer-grid format (1000 bins over [-1, 1], chunked horizons).

Copied from ``lap_tpu/policies/lang_action_formats.py``; its imports point
at the port's copies.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from typing import Literal

import numpy as np

from lap_tpu_torch.policies.frame_transforms import transform_actions_from_eef_frame

logger = logging.getLogger(__name__)

# Parser conventions (reference lang_action_formats.py:64-109).
_MOVE_AXIS = {
    "forward": (0, +1.0),
    "backward": (0, -1.0),
    "back": (0, -1.0),
    "left": (1, +1.0),
    "right": (1, -1.0),
    "up": (2, +1.0),
    "down": (2, -1.0),
}
_ROT_AXIS = {
    "tilt left": (0, +1.0),
    "tilt right": (0, -1.0),
    "tilt down": (1, +1.0),
    "tilt back": (1, +1.0),
    "tilt up": (1, -1.0),
    "tilt forward": (1, -1.0),
    "rotate counterclockwise": (2, +1.0),
    "rotate clockwise": (2, -1.0),
}
_ROT_RE = re.compile(
    r"(tilt left|tilt right|tilt up|tilt down|tilt back|tilt forward|rotate clockwise|rotate counterclockwise)\s+([\d.]+)\s*degrees",
    re.IGNORECASE,
)
_GRIP_SET_RE = re.compile(r"set\s+gripper\s+to\s+([\-+]?\d+\.?\d*)", re.IGNORECASE)
_COMPACT_ROT_RE = re.compile(
    r"<([+\-]\d+)\s+([+\-]\d+)\s+([+\-]\d+)\s+([+\-]\d+)\s+([+\-]\d+)\s+([+\-]\d+)\s+(\d)>"
)


@dataclasses.dataclass(frozen=True)
class LanguageActionFormat:
    name: str
    style: Literal["verbose", "compact", "vla0"] = "verbose"
    decimal_places: int = 0
    include_rotation: bool = False
    translation_unit: str = "cm"
    use_eef_frame: bool = False

    def get_sum_decimal(self) -> str:
        if self.style == "compact":
            return "compact"
        return f"{self.decimal_places}f"

    def parse_language_to_deltas(
        self,
        reasoning: str,
        *,
        initial_state: np.ndarray | None = None,
    ) -> tuple[np.ndarray, float | None]:
        """Parse text to ([dx,dy,dz,droll,dpitch,dyaw], gripper or None)."""
        movement = np.zeros(6, dtype=float)
        gripper = None

        if self.style == "compact":
            if self.include_rotation:
                m = _COMPACT_ROT_RE.search(reasoning)
                if m:
                    g = m.groups()
                    movement[:3] = np.array(g[:3], dtype=float) / 100.0
                    movement[3:6] = np.array(g[3:6], dtype=float) * np.pi / 180.0
                    gripper = float(g[-1])
        else:
            text = (
                reasoning.replace("slightly", "1.5 cm")
                .replace("moderately", "5 cm")
                .replace("a lot", "10 cm")
            )
            move_re = re.compile(
                rf"move\s+(right|left|forward|backward|back|up|down)(?:\s+([\-\d\.]+)\s*{self.translation_unit})?",
                re.IGNORECASE,
            )
            cm = np.zeros(3)
            for m in move_re.finditer(text):
                axis, sign = _MOVE_AXIS[m.group(1).lower()]
                value = float(m.group(2)) if m.group(2) is not None else 0.0
                cm[axis] += sign * value
            movement[:3] = cm / 100.0

            if self.include_rotation:
                deg = np.zeros(3)
                for m in _ROT_RE.finditer(text):
                    axis, sign = _ROT_AXIS[m.group(1).lower()]
                    deg[axis] += sign * float(m.group(2))
                movement[3:6] = deg * np.pi / 180.0

            low = text.lower()
            set_match = _GRIP_SET_RE.search(text)
            if "open gripper" in low:
                gripper = 1.0
            elif "close gripper" in low:
                gripper = 0.0
            elif set_match:
                gripper = float(set_match.group(1))

        if self.use_eef_frame and initial_state is not None:
            movement = transform_actions_from_eef_frame(movement, initial_state)[0]
        return movement, gripper


@dataclasses.dataclass(frozen=True)
class VLA0ActionFormat(LanguageActionFormat):
    """Actions as space-separated integers in [0, num_bins] over [-1, 1]."""

    name: str = "vla0"
    style: Literal["vla0"] = "vla0"
    num_bins: int = 1000
    action_horizon: int = 1
    action_dim: int = 7

    def get_sum_decimal(self) -> str:
        return "vla0"

    def summarize_actions(self, actions: np.ndarray) -> str:
        actions = np.asarray(actions, dtype=float)
        if actions.ndim == 1:
            actions = actions[None, :]
        disc = np.round((np.clip(actions, -1, 1) + 1.0) / 2.0 * self.num_bins)
        disc = np.clip(disc.astype(int), 0, self.num_bins)
        return " ".join(map(str, disc.flatten()))

    def _parse_ints(self, reasoning) -> np.ndarray | None:
        if isinstance(reasoning, list):
            reasoning = " ".join(reasoning)
        try:
            ints = [int(x) for x in reasoning.split()]
        except ValueError:
            return None
        return np.array(ints, dtype=float) if ints else None

    def parse_to_full_actions(self, reasoning) -> np.ndarray:
        ints = self._parse_ints(reasoning)
        if ints is None:
            logger.info("Failed to parse VLA0 format: %s", reasoning)
            return np.zeros((self.action_horizon, self.action_dim), dtype=float)
        cont = ints / self.num_bins * 2.0 - 1.0
        want = self.action_horizon * self.action_dim
        if len(cont) < want:
            cont = np.pad(cont, (0, want - len(cont)))
        return cont[:want].reshape(self.action_horizon, self.action_dim)

    def parse_language_to_deltas(self, reasoning, *, initial_state=None):
        actions = self.parse_to_full_actions(reasoning)
        movement = actions[0, :6] if actions.shape[1] >= 6 else np.zeros(6)
        gripper = float(actions[0, 6]) if actions.shape[1] >= 7 else None
        return movement, gripper


VERBOSE_WITH_ROTATION_FORMAT = LanguageActionFormat(
    name="verbose_with_rotation", style="verbose", decimal_places=0, include_rotation=True
)
VERBOSE_EEF_WITH_ROTATION_FORMAT = LanguageActionFormat(
    name="verbose_eef_with_rotation",
    style="verbose",
    decimal_places=0,
    include_rotation=True,
    use_eef_frame=True,
)
VLA0_CHUNKED_FORMAT = VLA0ActionFormat(
    name="vla0_chunked", num_bins=1000, action_horizon=10, action_dim=7
)

LANGUAGE_ACTION_FORMAT_REGISTRY = {
    fmt.name: fmt
    for fmt in (
        VERBOSE_WITH_ROTATION_FORMAT,
        VERBOSE_EEF_WITH_ROTATION_FORMAT,
        VLA0_CHUNKED_FORMAT,
    )
}


def get_language_action_format(name: str) -> LanguageActionFormat:
    if name not in LANGUAGE_ACTION_FORMAT_REGISTRY:
        raise ValueError(
            f"Unknown language action format: {name}."
            f" Available: {list(LANGUAGE_ACTION_FORMAT_REGISTRY)}"
        )
    return LANGUAGE_ACTION_FORMAT_REGISTRY[name]
