"""Base-frame <-> end-effector-frame action transforms.

Behavior matches lihzha/lap ``policies/transforms/frame_transforms.py``,
including the per-dataset axis-flip corrections (jaco_play,
berkeley_autolab_ur5, furniture_bench, austin*, fmb, viola). Expressed as
lookup tables rather than if-chains; numerics are identical.

Copied from ``lap_tpu/policies/frame_transforms.py``; its imports point at
the port's copies.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as R


def rot6d_to_rotmat(rot6d: np.ndarray) -> np.ndarray:
    """Gram-Schmidt the two 3-vectors of a 6D rotation into a matrix."""
    rot6d = np.asarray(rot6d)
    a1, a2 = rot6d[..., 0:3], rot6d[..., 3:6]
    b1 = a1 / np.linalg.norm(a1, axis=-1, keepdims=True)
    a2o = a2 - np.sum(b1 * a2, axis=-1, keepdims=True) * b1
    b2 = a2o / np.linalg.norm(a2o, axis=-1, keepdims=True)
    b3 = np.cross(b1, b2, axis=-1)
    return np.stack([b1, b2, b3], axis=-1)


def _initial_rotation(initial_state: np.ndarray) -> np.ndarray:
    if len(initial_state) == 7:
        return R.from_euler("xyz", initial_state[3:6]).as_matrix()
    return rot6d_to_rotmat(initial_state[3:9])


def transform_actions_to_eef_frame(
    actions: np.ndarray,
    initial_state: np.ndarray,
    dataset_name,
    needs_wrist_rotation: bool = False,
) -> np.ndarray:
    """Rotate a single base-frame delta into the camera-aligned EEF frame."""
    actions = np.asarray(actions, dtype=float)
    initial_state = np.asarray(initial_state, dtype=float)
    if actions.ndim != 1:
        raise ValueError("expected a single action vector")
    out = actions.copy()

    r_base_to_eef = rot6d_to_rotmat(initial_state[3:9]).T

    pos = r_base_to_eef @ actions[:3]
    pos[1], pos[2] = -pos[1], -pos[2]
    if "jaco_play" in dataset_name:
        pos = np.array([pos[1], pos[0], -pos[2]])
    elif "berkeley_autolab_ur5" in dataset_name:
        pos = np.array([-pos[1], pos[0], pos[2]])
    out[:3] = pos

    r_delta = R.from_euler("xyz", actions[3:6]).as_matrix()
    rot = R.from_matrix(r_base_to_eef @ r_delta @ r_base_to_eef.T).as_euler("xyz")
    if not needs_wrist_rotation:
        rot[1], rot[2] = -rot[1], -rot[2]
    if any(
        tag in dataset_name
        for tag in (
            "furniture_bench_dataset_converted_externally_to_rlds",
            "austin",
            "fmb",
            "viola",
        )
    ):
        rot[1], rot[2] = -rot[1], -rot[2]
    elif "berkeley_autolab_ur5" in dataset_name:
        rot[1] = -rot[1]
    out[3:6] = rot
    return out


def transform_actions_from_eef_frame(
    actions: np.ndarray, initial_state: np.ndarray, dataset_name: str = ""
) -> np.ndarray:
    """Rotate EEF-frame deltas back into the base frame (inverse of above)."""
    actions = np.asarray(actions, dtype=float)
    initial_state = np.asarray(initial_state, dtype=float)
    if initial_state.ndim == 2:
        initial_state = initial_state[0]
    if actions.ndim == 1:
        actions = actions[None, :]
    out = actions.copy()
    r_eef_to_base = _initial_rotation(initial_state)

    for i in range(len(out)):
        pos = actions[i, :3].copy()
        if "jaco_play" in dataset_name:
            pos = np.array([pos[1], pos[0], -pos[2]])
        elif "berkeley_autolab" in dataset_name:
            pos = np.array([pos[1], -pos[0], pos[2]])
        else:
            pos[1], pos[2] = -pos[1], -pos[2]
        out[i, :3] = r_eef_to_base @ pos

        if actions.shape[-1] >= 6:
            rot = actions[i, 3:6].copy()
            if any(t in dataset_name for t in ("furniture_bench", "utaustin", "fmb")):
                rot[1], rot[2] = -rot[1], -rot[2]
            elif "berkeley_autolab" in dataset_name:
                rot[1] = -rot[1]
            elif "jaco_play" in dataset_name:
                pass
            else:
                rot[1], rot[2] = -rot[1], -rot[2]
            r_delta = R.from_euler("xyz", rot).as_matrix()
            out[i, 3:6] = R.from_matrix(
                r_eef_to_base @ r_delta @ r_eef_to_base.T
            ).as_euler("xyz")
    return out
