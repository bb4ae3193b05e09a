"""State/action encoding enums and conversions.

Parity with lihzha/lap ``datasets/utils/helpers.py:13-37``.

Copied from ``lap_tpu/data/helpers.py``; its imports point at the port's
copies.
"""

from __future__ import annotations

import enum


class StateEncoding(enum.IntEnum):
    NONE = -1
    POS_EULER = 1  # xyz + rpy + pad + gripper
    POS_QUAT = 2  # xyz + quat + gripper
    JOINT = 3  # 7 joints + pad + gripper
    JOINT_BIMANUAL = 4
    EEF_R6 = 5  # xyz + rot6d + gripper


class ActionEncoding(enum.IntEnum):
    EEF_POS = 1  # xyz delta + rpy delta + gripper
    JOINT_POS = 2
    JOINT_POS_BIMANUAL = 3
    EEF_R6 = 4
    ABS_EEF_POS = 5


class NormalizationType(str, enum.Enum):
    NORMAL = "normal"  # mean/std
    BOUNDS = "bounds"  # min/max -> [-1, 1]
    BOUNDS_Q99 = "bounds_q99"  # q01/q99 -> [-1, 1]
    NONE = "none"


STATE_DIM_BY_ENCODING = {
    StateEncoding.NONE: 0,
    StateEncoding.POS_EULER: 8,
    StateEncoding.POS_QUAT: 8,
    StateEncoding.JOINT: 8,
    StateEncoding.JOINT_BIMANUAL: 16,
    StateEncoding.EEF_R6: 10,
}
