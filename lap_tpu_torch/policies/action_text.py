"""Language-action text codecs: deltas -> text and text -> deltas.

Behavioral parity with lihzha/lap ``policies/transforms/action_text.py``:
verbose ("move forward 5 cm, tilt left 10 degrees, close gripper"), compact
("<+05 -02 +00 1>"), no-number, nearest-10 and bimanual variants, rough-scale
annotation ("slightly/moderately/a lot"), and the idle thresholds
(1 cm translation / 10 deg rotation). Direction/sign conventions are encoded
as tables (axis, positive-word, negative-word).

Copied from ``lap_tpu/policies/action_text.py``; its imports point at the
port's copies.
"""

from __future__ import annotations

import re

import numpy as np

# (axis index, positive phrase, negative phrase), metres -> cm.
# Numeric summaries emit x, z, y; the no_number style emits x, y, z —
# matching the reference's two branches (action_text.py:83-139).
_TRANSLATION_TABLE = (
    (0, "move forward", "move back"),
    (2, "move up", "move down"),
    (1, "move left", "move right"),
)
_TRANSLATION_TABLE_NO_NUMBER = (
    (0, "move forward", "move back"),
    (1, "move left", "move right"),
    (2, "move up", "move down"),
)
# Rotation axes in radians -> degrees. NOTE: the textual convention for pitch
# is inverted between summarize (tilt back = +pitch) and parse (tilt back =
# +pitch here too; see _ROTATION_PARSE below matching the reference parser).
_ROTATION_TABLE = (
    (3, "tilt left", "tilt right"),
    (4, "tilt back", "tilt forward"),
    (5, "rotate counterclockwise", "rotate clockwise"),
)

_MOVE_WORD_DELTAS = {
    "forward": (0, +1.0),
    "backward": (0, -1.0),
    "back": (0, -1.0),
    "left": (1, +1.0),
    "right": (1, -1.0),
    "up": (2, +1.0),
    "down": (2, -1.0),
}
# Parser convention (lang_action_formats.py:98-109): tilt down/back -> +pitch.
_ROTATION_PARSE = {
    "tilt left": (3, +1.0),
    "tilt right": (3, -1.0),
    "tilt down": (4, +1.0),
    "tilt back": (4, +1.0),
    "tilt up": (4, -1.0),
    "tilt forward": (4, -1.0),
    "rotate counterclockwise": (5, +1.0),
    "rotate clockwise": (5, -1.0),
}


def _round_to_nearest_n(value: float, n: int = 5) -> int:
    return int(round(value / n) * n)


def _format_numeric(val: float, sum_decimal: str) -> str:
    if sum_decimal == "no_number":
        return ""
    if sum_decimal == "nearest_10":
        return str(int(round(val / 10) * 10))
    m = re.fullmatch(r"(\d+)f", sum_decimal)
    decimals = int(m.group(1)) if m else 0
    return f"{val:.{decimals}f}"


def _compact(arr: np.ndarray, include_rotation: bool) -> str:
    sums = arr.sum(axis=0)
    parts = [f"{int(round(float(sums[i]) * 100.0)):+03d}" for i in (0, 1, 2)]
    if include_rotation:
        parts += [
            f"{_round_to_nearest_n(float(sums[i]) * 180.0 / np.pi, 5):+03d}"
            for i in (3, 4, 5)
        ]
    parts.append(str(1 if float(arr[-1, 6]) >= 0.5 else 0))
    return "<" + " ".join(parts) + ">"


def summarize_numeric_actions(
    arr_like,
    sum_decimal: str,
    include_rotation: bool = False,
    rotation_precision: int = 10,
) -> str | None:
    """Sum deltas over the chunk and describe them in natural language."""
    arr = np.asarray(arr_like, dtype=float)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.shape[-1] < 7:
        return None
    if sum_decimal == "compact":
        return _compact(arr, include_rotation)

    sums = arr.sum(axis=0)
    parts: list[str] = []
    table = (
        _TRANSLATION_TABLE_NO_NUMBER if sum_decimal == "no_number" else _TRANSLATION_TABLE
    )
    for axis, pos_word, neg_word in table:
        raw_m = float(sums[axis])
        mag_cm = abs(raw_m * 100.0)
        if sum_decimal == "no_number":
            mag = round(mag_cm, 0)
            if raw_m > 0 and mag != 0:
                parts.append(pos_word)
            elif raw_m < 0 and mag != 0:
                parts.append(neg_word)
        else:
            decimals = 0 if sum_decimal == "nearest_10" else int(
                re.fullmatch(r"(\d+)f", sum_decimal).group(1)
            )
            mag = round(mag_cm, decimals)
            txt = _format_numeric(mag, sum_decimal)
            if raw_m > 0 and mag != 0:
                parts.append(f"{pos_word} {txt} cm")
            elif raw_m < 0 and mag != 0:
                parts.append(f"{neg_word} {txt} cm")
    if include_rotation:
        for axis, pos_word, neg_word in _ROTATION_TABLE:
            raw_rad = float(sums[axis])
            deg = _round_to_nearest_n(abs(raw_rad * 180.0 / np.pi), rotation_precision)
            if sum_decimal == "no_number":
                if raw_rad > 0:
                    parts.append(pos_word)
                elif raw_rad < 0:
                    parts.append(neg_word)
            else:
                if raw_rad > 0 and deg != 0:
                    parts.append(f"{pos_word} {deg} degrees")
                elif raw_rad < 0 and deg != 0:
                    parts.append(f"{neg_word} {deg} degrees")
    parts.append("open gripper" if float(arr[-1, 6]) >= 0.5 else "close gripper")
    return ", ".join(parts)


def summarize_bimanual_numeric_actions(
    arr_like, sum_decimal: str, include_rotation: bool = False
) -> str | None:
    arr = np.asarray(arr_like, dtype=float)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.shape[-1] < 14:
        return None
    left, right = arr[..., :7], arr[..., 7:14]
    if sum_decimal == "compact":
        lc = _compact(left, include_rotation)[1:-1]
        rc = _compact(right, include_rotation)[1:-1]
        return f"<L {lc} R {rc}>"
    ls = summarize_numeric_actions(left, sum_decimal, include_rotation)
    rs = summarize_numeric_actions(right, sum_decimal, include_rotation)
    if ls is None or rs is None:
        return None
    return f"Left arm: {ls}. Right arm: {rs}"


_TRANSLATION_SCALE_RE = re.compile(
    r"(move\s+(?:forward|back|left|right|up|down))\s+([+\-]?\d+(?:\.\d+)?)\s*cm"
)
_ROTATION_SCALE_RE = re.compile(
    r"((?:tilt\s+(?:left|right|back|forward))|(?:rotate\s+(?:clockwise|counterclockwise)))\s+([+\-]?\d+(?:\.\d+)?)\s*degrees"
)


def describe_language_action_scale(language_action: str | None) -> str | None:
    """Replace numeric magnitudes with rough scale words."""
    if language_action is None:
        return None
    if not isinstance(language_action, str) or not language_action.strip():
        return language_action

    def translation_word(cm):
        return "slightly" if cm <= 3.0 else ("moderately" if cm < 8.0 else "a lot")

    def rotation_word(deg):
        return "slightly" if deg < 10.0 else ("moderately" if deg < 30.0 else "a lot")

    def sub(pattern, describe, text):
        def repl(m):
            try:
                return f"{m.group(1)} {describe(float(m.group(2)))}"
            except ValueError:
                return m.group(0)

        return pattern.sub(repl, text)

    out = sub(_TRANSLATION_SCALE_RE, translation_word, language_action)
    return sub(_ROTATION_SCALE_RE, rotation_word, out)


_MOVE_RE = re.compile(
    r"move\s+(right|left|forward|backward|back|up|down)\s+([\d.]+)\s*cm", re.IGNORECASE
)
_MOVE_NO_NUMBER_RE = re.compile(
    r"move\s+(right|left|forward|backward|back|up|down)(?!\s+[\d.])", re.IGNORECASE
)
_ROTATION_RE = re.compile(
    r"(tilt left|tilt right|tilt up|tilt down|tilt back|tilt forward|rotate clockwise|rotate counterclockwise)\s+([\d.]+)\s*degrees",
    re.IGNORECASE,
)
_ROTATION_NO_NUMBER_RE = re.compile(
    r"(tilt left|tilt right|tilt up|tilt down|tilt back|tilt forward|rotate clockwise|rotate counterclockwise)(?!\s+[\d.])",
    re.IGNORECASE,
)
_COMPACT_RE = re.compile(r"<([+\-]\d+)\s+([+\-]\d+)\s+([+\-]\d+)\s+\d>")
_COMPACT_ROT_RE = re.compile(
    r"<([+\-]\d+)\s+([+\-]\d+)\s+([+\-]\d+)\s+([+\-]\d+)\s+([+\-]\d+)\s+([+\-]\d+)\s+\d>"
)


def parse_translation_cm(text: str) -> np.ndarray:
    """Accumulate [dx, dy, dz] in cm from verbose move phrases.

    Sign convention differs from the formats parser: this follows the idle
    check (action_text.py:257-274): up -> +z, left -> +y, forward -> +x.
    """
    out = np.zeros(3)
    for m in _MOVE_RE.finditer(text):
        axis, sign = _MOVE_WORD_DELTAS[m.group(1).lower()]
        out[axis] += sign * float(m.group(2))
    return out


def parse_rotation_deg(text: str) -> np.ndarray:
    """Accumulate [droll, dpitch, dyaw] in degrees (idle-check convention:
    tilt up/forward -> +pitch; action_text.py:287-298)."""
    out = np.zeros(3)
    table = {
        "tilt left": (0, +1.0),
        "tilt right": (0, -1.0),
        "tilt up": (1, +1.0),
        "tilt forward": (1, +1.0),
        "tilt down": (1, -1.0),
        "tilt back": (1, -1.0),
        "rotate counterclockwise": (2, +1.0),
        "rotate clockwise": (2, -1.0),
    }
    for m in _ROTATION_RE.finditer(text):
        axis, sign = table[m.group(1).lower()]
        out[axis] += sign * float(m.group(2))
    return out


def is_idle_language_action(
    language_action: str,
    sum_decimal: str,
    include_rotation: bool = False,
    translation_threshold: float = 1.0,
    rotation_threshold_deg: float = 10.0,
) -> bool:
    """True when the described motion is below the idle thresholds."""
    if not language_action or not isinstance(language_action, str):
        return True

    if sum_decimal == "compact":
        pattern = _COMPACT_ROT_RE if include_rotation else _COMPACT_RE
        m = pattern.search(language_action)
        if not m:
            return True
        vals = [int(g) for g in m.groups()]
        trans = float(np.linalg.norm(vals[:3]))
        if not include_rotation:
            return trans < translation_threshold
        rot = float(np.linalg.norm(vals[3:6]))
        return trans < translation_threshold and rot < rotation_threshold_deg

    if sum_decimal == "no_number":
        has_move = bool(_MOVE_NO_NUMBER_RE.search(language_action))
        if not include_rotation:
            return not has_move
        has_rot = bool(_ROTATION_NO_NUMBER_RE.search(language_action))
        return not (has_move or has_rot)

    trans = float(np.linalg.norm(parse_translation_cm(language_action)))
    if not include_rotation:
        return trans < translation_threshold
    rot = float(np.linalg.norm(parse_rotation_deg(language_action)))
    return trans < translation_threshold and rot < rotation_threshold_deg
