"""Rotation algebra (numpy), matching the reference's TF-graph conventions.

Parity with lihzha/lap ``datasets/utils/rotation_utils.py``: extrinsic XYZ
Euler angles (R = Rz(yaw) @ Ry(pitch) @ Rx(roll)), 6D rotation = first two
matrix COLUMNS, the same gimbal-lock fallbacks, and the composition-based
``euler_diff`` / windowed ``sum_actions``.

Copied from ``lap_tpu/data/rotation.py``; its imports point at the port's
copies.
"""

from __future__ import annotations

import numpy as np


def euler_to_matrix(euler: np.ndarray) -> np.ndarray:
    """(..., 3) [roll, pitch, yaw] extrinsic XYZ -> (..., 3, 3)."""
    euler = np.asarray(euler, dtype=np.float64)
    roll, pitch, yaw = euler[..., 0], euler[..., 1], euler[..., 2]
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    row0 = np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1)
    row1 = np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1)
    row2 = np.stack([-sp, cp * sr, cp * cr], axis=-1)
    return np.stack([row0, row1, row2], axis=-2)


def matrix_to_euler(rot: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """(..., 3, 3) -> (..., 3) extrinsic XYZ with gimbal fallback."""
    rot = np.asarray(rot, dtype=np.float64)
    r00, r10 = rot[..., 0, 0], rot[..., 1, 0]
    r11, r12 = rot[..., 1, 1], rot[..., 1, 2]
    r20, r21, r22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    sy = np.sqrt(np.maximum(r00 * r00 + r10 * r10, eps))
    singular = sy < eps
    roll = np.where(singular, np.arctan2(-r12, r11), np.arctan2(r21, r22))
    pitch = np.arctan2(-r20, sy)
    yaw = np.where(singular, np.zeros_like(r00), np.arctan2(r10, r00))
    return np.stack([roll, pitch, yaw], axis=-1)


def euler_diff(angles1: np.ndarray, angles2: np.ndarray) -> np.ndarray:
    """Relative angles s.t. R(angles2) @ R(rel) = R(angles1)."""
    r1 = euler_to_matrix(angles1)
    r2 = euler_to_matrix(angles2)
    rel = np.swapaxes(r2, -1, -2) @ r1
    return matrix_to_euler(rel)


def matrix_to_r6(rot: np.ndarray) -> np.ndarray:
    """First two columns, column-major: [c0x c0y c0z c1x c1y c1z]."""
    rot = np.asarray(rot)
    return np.concatenate([rot[..., :, 0], rot[..., :, 1]], axis=-1)


def euler_to_r6(euler: np.ndarray) -> np.ndarray:
    return matrix_to_r6(euler_to_matrix(euler))


def r6_to_matrix(r6: np.ndarray) -> np.ndarray:
    r6 = np.asarray(r6, dtype=np.float64)
    a1, a2 = r6[..., 0:3], r6[..., 3:6]
    b1 = a1 / np.linalg.norm(a1, axis=-1, keepdims=True)
    a2o = a2 - np.sum(b1 * a2, axis=-1, keepdims=True) * b1
    b2 = a2o / np.linalg.norm(a2o, axis=-1, keepdims=True)
    b3 = np.cross(b1, b2, axis=-1)
    return np.stack([b1, b2, b3], axis=-1)


def r6_to_euler(r6: np.ndarray) -> np.ndarray:
    return matrix_to_euler(r6_to_matrix(r6))


def quat_to_euler(quat: np.ndarray, *, scalar_first: bool = False) -> np.ndarray:
    """Quaternion (xyzw by default) -> extrinsic XYZ Euler."""
    from scipy.spatial.transform import Rotation as R

    quat = np.asarray(quat, dtype=np.float64)
    if scalar_first:
        quat = np.concatenate([quat[..., 1:], quat[..., :1]], axis=-1)
    return matrix_to_euler(R.from_quat(quat.reshape(-1, 4)).as_matrix().reshape(*quat.shape[:-1], 3, 3))


def euler_to_quat(euler: np.ndarray, *, scalar_first: bool = False) -> np.ndarray:
    """Euler -> quaternion, replicating the reference's exact half-angle
    formula (rotation_utils.py:168-191).

    NOTE: the reference composes half-angles in INTRINSIC XYZ order here
    (qw = cx*cy*cz - sx*sy*sz), which is inconsistent with its own
    euler_to_rotation_matrix (extrinsic XYZ).  Data/checkpoint parity
    requires matching its actual behavior, not its docstring."""
    euler = np.asarray(euler, dtype=np.float64)
    rx, ry, rz = euler[..., 0], euler[..., 1], euler[..., 2]
    cx, sx = np.cos(rx * 0.5), np.sin(rx * 0.5)
    cy, sy = np.cos(ry * 0.5), np.sin(ry * 0.5)
    cz, sz = np.cos(rz * 0.5), np.sin(rz * 0.5)
    qw = cx * cy * cz - sx * sy * sz
    qx = sx * cy * cz + cx * sy * sz
    qy = cx * sy * cz - sx * cy * sz
    qz = cx * cy * sz + sx * sy * cz
    quat = np.stack([qx, qy, qz, qw], axis=-1)
    if scalar_first:
        quat = np.concatenate([quat[..., 3:], quat[..., :3]], axis=-1)
    return quat


def axis_angle_to_euler(axis_angle: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation as R

    aa = np.asarray(axis_angle, dtype=np.float64)
    mat = R.from_rotvec(aa.reshape(-1, 3)).as_matrix().reshape(*aa.shape[:-1], 3, 3)
    return matrix_to_euler(mat)


def zxy_to_xyz(angles: np.ndarray) -> np.ndarray:
    """Intrinsic Z-X-Y Euler angles (az, ax, ay) -> extrinsic XYZ (rpy)
    (reference rotation_utils.py:475-501; used by dlr_edan_shared_control)."""
    from scipy.spatial.transform import Rotation as R

    a = np.asarray(angles, dtype=np.float64)
    mats = R.from_euler("ZXY", a.reshape(-1, 3)).as_matrix()
    return matrix_to_euler(mats.reshape(*a.shape[:-1], 3, 3))


def matrix_to_r6_rows(rot: np.ndarray) -> np.ndarray:
    """First two ROWS: [r00 r01 r02 r10 r11 r12].

    The reference carries two R6 conventions: transforms.py:38-100 uses
    rows (sample_r1_lite / agibot standardization), rotation_utils.py:303
    uses columns (the R6 state encoding).  Keep both, explicitly."""
    rot = np.asarray(rot)
    return np.concatenate([rot[..., 0, :], rot[..., 1, :]], axis=-1)


def _axis_angle_to_matrix(axis_angle: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation as R

    aa = np.asarray(axis_angle, dtype=np.float64)
    return R.from_rotvec(aa.reshape(-1, 3)).as_matrix().reshape(*aa.shape[:-1], 3, 3)


def axis_angle_to_r6(axis_angle: np.ndarray) -> np.ndarray:
    """Axis-angle -> first two rotation-matrix ROWS
    (reference transforms.py:66-100; used by sample_r1_lite)."""
    return matrix_to_r6_rows(_axis_angle_to_matrix(axis_angle))


def axis_angle_to_r6_cols(axis_angle: np.ndarray) -> np.ndarray:
    """Axis-angle -> first two rotation-matrix COLUMNS
    (reference rotation_utils.py:542-559)."""
    return matrix_to_r6(_axis_angle_to_matrix(axis_angle))


def _wxyz_to_matrix(quat: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation as R

    q = np.asarray(quat, dtype=np.float64)
    xyzw = np.concatenate([q[..., 1:4], q[..., 0:1]], axis=-1)
    return R.from_quat(xyzw.reshape(-1, 4)).as_matrix().reshape(*q.shape[:-1], 3, 3)


def quat_wxyz_to_r6(quat: np.ndarray) -> np.ndarray:
    """wxyz quaternion -> first two rotation-matrix ROWS
    (reference transforms.py:38-63; used by sample_r1_lite)."""
    return matrix_to_r6_rows(_wxyz_to_matrix(quat))


def quat_wxyz_to_r6_cols(quat: np.ndarray) -> np.ndarray:
    """wxyz quaternion -> first two rotation-matrix COLUMNS
    (reference rotation_utils.py:593-607)."""
    return matrix_to_r6(_wxyz_to_matrix(quat))


def matrix_state_to_xyzrpy(mat: np.ndarray) -> np.ndarray:
    """4x4 (or flattened 16) homogeneous transform -> [xyz, rpy]."""
    mat = np.asarray(mat, dtype=np.float64)
    if mat.shape[-1] == 16:
        mat = mat.reshape(*mat.shape[:-1], 4, 4)
    xyz = mat[..., :3, 3]
    rpy = matrix_to_euler(mat[..., :3, :3])
    return np.concatenate([xyz, rpy], axis=-1)


def sum_actions(actions: np.ndarray, valid_lengths: np.ndarray | None = None) -> np.ndarray:
    """Sum windows of deltas: translations add, rotations compose
    (R_total = R_total @ R_step), trailing dims (gripper) take the last value
    (reference base_dataset.py:722-777).

    Args:
        actions: [T, W, A] windows; A >= 6 gets rotation composition.
        valid_lengths: [T] number of valid deltas per window.
    """
    actions = np.asarray(actions, dtype=np.float64)
    t, w, a = actions.shape
    if valid_lengths is None:
        valid_lengths = np.full((t,), w, dtype=np.int64)
    valid_lengths = np.clip(np.asarray(valid_lengths, dtype=np.int64), 1, w)

    out = np.zeros((t, a), dtype=actions.dtype)
    for i in range(t):
        length = int(valid_lengths[i])
        window = actions[i, :length]
        if a < 6:
            window = np.pad(window, ((0, 0), (0, 6 - a)))
        out[i, :3] = window[:, :3].sum(axis=0)
        r_total = np.eye(3)
        for rpy in window[:, 3:6]:
            r_total = r_total @ euler_to_matrix(rpy)
        out[i, 3 : min(6, a)] = matrix_to_euler(r_total)[: max(min(6, a) - 3, 0)]
        if a > 6:
            out[i, 6:] = window[-1, 6:a]
    return out


def gather_with_padding(
    data: np.ndarray,
    window_size: int,
    *,
    per_timestep_windows: np.ndarray | None = None,
    last_value_padding: bool = False,
) -> np.ndarray:
    """[T, A] -> [T, W, A] sliding windows; pad past the end with zeros or the
    final value; optional per-timestep window limits
    (reference tfdata_pipeline.py:18-111)."""
    data = np.asarray(data)
    t = data.shape[0]
    base = np.broadcast_to(np.arange(window_size)[None, :], (t, window_size))
    if last_value_padding:
        # repeat the last valid value instead of zero-padding
        if per_timestep_windows is not None:
            base = np.minimum(base, np.asarray(per_timestep_windows).reshape(t, 1) - 1)
        idx = base + np.arange(t)[:, None]
        return data[np.minimum(idx, t - 1)]
    idx = base + np.arange(t)[:, None]
    valid = idx < t
    if per_timestep_windows is not None:
        valid = valid & (base < np.asarray(per_timestep_windows).reshape(t, 1))
    out = data[np.minimum(idx, t - 1)]
    return np.where(valid[..., None], out, 0.0)


# Per-dataset coordinate-frame corrections (reference rotation_utils.py:382-444):
# x' = C @ x for translations, R' = C @ R @ C^T for rotations.
TRANSFORM_BCZ = np.array([[0.0, -1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, -1.0]])
TRANSFORM_DOBBE = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
TRANSFORM_JACO = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])


def apply_coordinate_transform(movement: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Rotate [..., 6] (xyz + extrinsic-XYZ rpy) into another frame."""
    movement = np.asarray(movement, dtype=np.float64)
    xyz = movement[..., :3] @ c.T
    rot = euler_to_matrix(movement[..., 3:6])
    rot_new = np.einsum("ij,...jk,lk->...il", c, rot, c)
    return np.concatenate([xyz, matrix_to_euler(rot_new)], axis=-1)


def coordinate_transform_bcz(movement: np.ndarray) -> np.ndarray:
    return apply_coordinate_transform(movement, TRANSFORM_BCZ)


def coordinate_transform_dobbe(movement: np.ndarray) -> np.ndarray:
    return apply_coordinate_transform(movement, TRANSFORM_DOBBE)


def coordinate_transform_jaco(movement: np.ndarray) -> np.ndarray:
    return apply_coordinate_transform(movement, TRANSFORM_JACO)
