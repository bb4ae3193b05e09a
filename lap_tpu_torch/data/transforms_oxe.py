"""Per-dataset RLDS standardization transforms (numpy).

Each transform converts one raw RLDS episode into the canonical trajectory
dict used by the pipeline:

    observation: {base_0_rgb: [bytes]*T, left_wrist_0_rgb: [bytes]*T,
                  state: [T, 7] (xyz, rpy, gripper)}
    raw_state:   [T, 7]
    action:      [T, 7] (chunker converts absolutes to deltas)
    language_action: [T, 7] per-step deltas + gripper
    language_instruction: [str]*T

Conventions are behavioral parity with lihzha/lap
``datasets/utils/transforms.py`` (gripper inversions/binarization per
dataset, coordinate fixes). This file carries the core OXE magic-soup
members + LIBERO + DROID; the long tail of the reference's 60+ transforms
follows the same recipe and is being filled in dataset-by-dataset.

Copied from ``lap_tpu/data/transforms_oxe.py``; its imports point at the port's
copies.
"""

from __future__ import annotations

import numpy as np

from lap_tpu_torch.data import rotation
from lap_tpu_torch.data.registry import register_dataset
from lap_tpu_torch.data.transform_helpers import (
    binarize_gripper_actions,
    compute_padded_movement_actions,
    fill_empty_instructions,
    invert_gripper_actions,
    rel2abs_gripper_actions,
)


def _steps(episode: dict) -> dict:
    return episode.get("steps", episode)


def _g(mapping: dict, key: str, default=None):
    """Fetch a feature that may be stored flat ("a/b" literal key, as TFDS
    emits it) or nested ({"a": {"b": ...}}, as our reader's unflatten emits
    it for slash-containing names)."""
    if key in mapping:
        return mapping[key]
    node = mapping
    for part in key.split("/"):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node


def _instructions(steps: dict, key: str = "language_instruction") -> list[str]:
    inst = steps.get(key)
    if inst is None:
        obs = steps.get("observation", {})
        inst = obs.get("natural_language_instruction", [""])
    if isinstance(inst, str):
        inst = [inst]
    return [i.decode() if isinstance(i, bytes) else str(i) for i in inst]


def _canonical(
    *,
    base_imgs,
    wrist_imgs,
    eef_state: np.ndarray,  # [T, 6] xyz+rpy
    gripper_state: np.ndarray,  # [T, 1] 0..1 (1 = open)
    action: np.ndarray,  # [T, 7]
    gripper_action: np.ndarray,  # [T, 1]
    instructions: list[str],
    language_action: np.ndarray | None = None,  # override (e.g. commanded deltas)
) -> dict:
    t = len(action)
    state = np.concatenate([eef_state, gripper_state], axis=-1).astype(np.float32)
    if language_action is None:
        language_action = np.concatenate(
            [compute_padded_movement_actions(eef_state), np.clip(gripper_action, 0, 1)],
            axis=-1,
        )
    language_action = np.asarray(language_action, np.float32)
    if base_imgs is None:  # camera-less fixtures / datasets
        base_imgs = [b""] * t
    if wrist_imgs is None:
        wrist_imgs = [b""] * t
    return {
        "observation": {
            "base_0_rgb": list(base_imgs),
            "left_wrist_0_rgb": list(wrist_imgs),
            "state": state,
        },
        "raw_state": state.copy(),
        "action": np.asarray(action, dtype=np.float32),
        "language_action": language_action,
        "language_instruction": instructions,
    }


# ---------------------------------------------------------------------------
# LIBERO (reference transforms.py:1453-1481)
# ---------------------------------------------------------------------------


@register_dataset("libero", exact=False, control_frequency=5.0)
def libero_dataset_transform(episode: dict) -> dict:
    steps = _steps(episode)
    obs = steps["observation"]
    action = np.asarray(steps["action"], dtype=np.float32)
    # Gripper action in -1(open)..1(close): clip to 0..1, invert -> 1 = open.
    grip = invert_gripper_actions(np.clip(action[:, -1:], 0, 1))
    state = np.asarray(obs["state"], dtype=np.float32)
    euler = rotation.axis_angle_to_euler(state[:, 3:6]).astype(np.float32)
    grip_state = np.clip(state[:, -2:-1] / 0.04, 0, 1)
    eef_state = np.concatenate([state[:, :3], euler], axis=-1)
    return _canonical(
        base_imgs=obs.get("image"),
        wrist_imgs=obs.get("wrist_image"),
        eef_state=eef_state,
        gripper_state=grip_state,
        action=np.concatenate([action[:, :6], grip], axis=-1),
        gripper_action=grip,
        instructions=_instructions(steps),
    )


# ---------------------------------------------------------------------------
# DROID (reference transforms.py:757-790)
# ---------------------------------------------------------------------------


@register_dataset("droid", exact=False, needs_wrist_rotation=True, control_frequency=15.0)
def droid_dataset_transform(episode: dict) -> dict:
    steps = _steps(episode)
    obs = steps["observation"]
    cartesian = np.asarray(obs["cartesian_position"], dtype=np.float32)
    grip_obs = np.asarray(obs["gripper_position"], dtype=np.float32)
    if grip_obs.ndim == 1:
        grip_obs = grip_obs[:, None]
    grip_state = binarize_gripper_actions(
        invert_gripper_actions(grip_obs[:, -1]), threshold=0.5
    )[:, None]
    grip_action_raw = np.asarray(steps["action_dict"]["gripper_position"], dtype=np.float32)
    if grip_action_raw.ndim == 1:
        grip_action_raw = grip_action_raw[:, None]
    grip_action = binarize_gripper_actions(
        invert_gripper_actions(grip_action_raw[:, -1]), threshold=0.5
    )[:, None]
    return _canonical(
        base_imgs=obs.get("exterior_image_1_left"),
        wrist_imgs=obs.get("wrist_image_left"),
        eef_state=cartesian[:, :6],
        gripper_state=grip_state,
        action=np.concatenate([cartesian[:, :6], np.clip(grip_action, 0, 1)], axis=-1),
        gripper_action=grip_action,
        instructions=_instructions(steps),
    )


# ---------------------------------------------------------------------------
# Bridge V2 (reference transforms.py:245-272)
# ---------------------------------------------------------------------------


@register_dataset("bridge", exact=False, control_frequency=5.0)
def bridge_dataset_transform(episode: dict) -> dict:
    steps = _steps(episode)
    obs = steps["observation"]
    # First timestep has an all-zero action: drop it.
    action = np.asarray(steps["action"], dtype=np.float32)[1:]
    state = np.asarray(obs["state"], dtype=np.float32)[1:]
    base = list(obs.get("image_0", obs.get("image", [])))[1:]
    instructions = _instructions(steps)[1:] or [""]
    grip = binarize_gripper_actions(action[:, -1])[:, None]
    eef = state[:, :6]
    return _canonical(
        base_imgs=base,
        wrist_imgs=None,
        eef_state=eef,
        gripper_state=np.clip(state[:, -1:], 0, 1),
        action=np.concatenate([eef, grip], axis=-1),
        gripper_action=grip,
        instructions=instructions,
    )


@register_dataset("bridge_orig")
@register_dataset("bridge_dataset")
def bridge_orig_dataset_transform(episode: dict) -> dict:
    """Original-website Bridge V2 (reference transforms.py:245-272).

    Unlike ``bridge_v2_oxe`` this variant relabels actions from reached
    proprioceptive state (reference ``relabel_bridge_actions``,
    transforms.py:165-172): after dropping the all-zero first step, the
    movement action at t becomes state[t+1, :6] - state[t, :6] and the last
    (action-less) step is discarded, leaving T-2 steps. The gripper state
    column is kept UNclipped here (reference :271).
    """
    steps = _steps(episode)
    obs = steps["observation"]
    # First timestep has an all-zero action: drop it.
    action = np.asarray(steps["action"], dtype=np.float32)[1:]
    state = np.asarray(obs["state"], dtype=np.float32)[1:]
    base = list(obs.get("image_0", obs.get("image", [])))[1:]
    instructions = _instructions(steps)[1:] or [""]
    grip = binarize_gripper_actions(action[:, -1])[:, None]
    # relabel_bridge_actions: reached-state deltas; discard the final step.
    movement = state[1:, :6] - state[:-1, :6]
    eef = state[:-1, :6]
    return _canonical(
        base_imgs=base[:-1],
        wrist_imgs=None,
        eef_state=eef,
        gripper_state=state[:-1, -1:],
        action=np.concatenate([movement, grip[:-1]], axis=-1),
        gripper_action=grip[:-1],
        instructions=instructions[:-1] or [""],
    )


# ---------------------------------------------------------------------------
# RT-1 / fractal (reference transforms.py:288-328)
# ---------------------------------------------------------------------------


@register_dataset("fractal", exact=False, control_frequency=3.0)
@register_dataset("rt_1", exact=False, control_frequency=3.0)
def rt1_dataset_transform(episode: dict) -> dict:
    steps = _steps(episode)
    obs = steps["observation"]
    act = steps["action"]
    grip_rel = np.asarray(act["gripper_closedness_action"], dtype=np.float32)
    if grip_rel.ndim == 2:
        grip_rel = grip_rel[:, 0]
    grip = rel2abs_gripper_actions(grip_rel)[:, None]
    pose = np.asarray(obs["base_pose_tool_reached"], dtype=np.float32)
    eef = np.concatenate(
        [pose[:, :3], rotation.quat_to_euler(pose[:, 3:7]).astype(np.float32)], axis=-1
    )
    grip_state = np.clip(
        invert_gripper_actions(np.asarray(obs["gripper_closed"], dtype=np.float32).reshape(-1, 1)),
        0,
        1,
    )
    return _canonical(
        base_imgs=obs.get("image"),
        wrist_imgs=None,
        eef_state=eef,
        gripper_state=grip_state,
        action=np.concatenate([eef, grip], axis=-1),
        gripper_action=grip,
        instructions=_instructions(steps),
    )


# ---------------------------------------------------------------------------
# Generic fallback: canonical-format datasets pass through.
# ---------------------------------------------------------------------------


@register_dataset(".*", exact=False, priority=-100)
def generic_dataset_transform(episode: dict) -> dict:
    """Datasets already shaped like the canonical schema (e.g. our test
    fixtures): observation.state [T, 7] xyz+rpy+gripper, action [T, 7]."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], dtype=np.float32)
    action = np.asarray(steps["action"], dtype=np.float32)
    grip = np.clip(action[:, -1:], 0, 1)
    return _canonical(
        base_imgs=obs.get("image", obs.get("base_0_rgb")),
        wrist_imgs=obs.get("wrist_image", obs.get("left_wrist_0_rgb")),
        eef_state=state[:, :6],
        gripper_state=np.clip(state[:, -1:], 0, 1),
        action=action[:, :7],
        gripper_action=grip,
        instructions=_instructions(steps),
    )


# ---------------------------------------------------------------------------
# OXE magic-soup members (conventions per reference transforms.py)
# ---------------------------------------------------------------------------


def _get_imgs(obs: dict, primary: str, wrist: str | None = None):
    return obs.get(primary), (obs.get(wrist) if wrist else None)


def _canonical_delta(
    *, base_imgs, wrist_imgs, action, instructions, t=None, eef_state=None, gripper_state=None
) -> dict:
    """Datasets whose actions stay per-step deltas and that carry no
    language-action supervision (e.g. cable routing, roboturk, toto).
    Proprio is optional: zeros when the raw episode has no usable EEF pose."""
    t = t if t is not None else len(action)
    if eef_state is None:
        state = np.zeros((t, 7), np.float32)
    else:
        if gripper_state is None:
            gripper_state = np.zeros((t, 1), np.float32)
        state = np.concatenate(
            [np.asarray(eef_state, np.float32), np.asarray(gripper_state, np.float32)],
            axis=-1,
        )
    if base_imgs is None:  # camera-less fixtures / datasets
        base_imgs = [b""] * t
    if wrist_imgs is None:
        wrist_imgs = [b""] * t
    return {
        "observation": {
            "base_0_rgb": list(base_imgs),
            "left_wrist_0_rgb": list(wrist_imgs),
            "state": state,
        },
        "raw_state": state.copy(),
        "action": np.asarray(action, dtype=np.float32),
        "language_instruction": instructions,
    }


@register_dataset("kuka", control_frequency=10.0)
def kuka_dataset_transform(episode: dict) -> dict:
    import zlib

    steps = _steps(episode)
    obs = steps["observation"]
    # State is ZLIB-compressed float32 [x y z qx qy qz qw].
    raw = _g(obs, "clip_function_input/base_pose_tool_reached")
    pose = np.stack(
        [np.frombuffer(zlib.decompress(r), np.float32).reshape(7) for r in raw]
    )
    grip_raw = _g(obs, "gripper_closed")
    grip_closed = np.stack(
        [np.frombuffer(zlib.decompress(r), np.float32).reshape(()) for r in grip_raw]
    )
    grip_state = np.clip(invert_gripper_actions(grip_closed)[:, None], 0, 1)
    eef = np.concatenate(
        [pose[:, :3], rotation.quat_to_euler(pose[:, 3:7]).astype(np.float32)], axis=-1
    )
    act = steps["action"]
    grip_action = rel2abs_gripper_actions(
        np.asarray(act["gripper_closedness_action"], np.float32).reshape(-1)
    )[:, None]
    return _canonical(
        base_imgs=obs.get("image"),
        wrist_imgs=None,
        eef_state=eef,
        gripper_state=grip_state,
        action=np.concatenate([eef, grip_action], axis=-1),
        gripper_action=grip_action,
        instructions=_instructions(steps),
    )


@register_dataset("taco_play", control_frequency=15.0)
def taco_play_dataset_transform(episode: dict) -> dict:
    steps = _steps(episode)
    obs = steps["observation"]
    robot_obs = np.asarray(obs["robot_obs"], np.float32)
    eef = robot_obs[:, :6]
    grip_state = np.clip(12.3903 * robot_obs[:, 6:7], 0, 1)
    rel = np.asarray(steps["action"]["rel_actions_world"], np.float32)
    grip_action = np.clip((rel[:, -1:] + 1) / 2, 0, 1)
    return _canonical(
        base_imgs=obs.get("rgb_static"),
        wrist_imgs=obs.get("rgb_gripper"),
        eef_state=eef,
        gripper_state=grip_state,
        action=np.concatenate([eef, grip_action], axis=-1),
        gripper_action=grip_action,
        instructions=_instructions(steps),
    )


@register_dataset("jaco_play", control_frequency=10.0)
def jaco_play_dataset_transform(episode: dict) -> dict:
    steps = _steps(episode)
    obs = steps["observation"]
    act = steps["action"]
    grip = rel2abs_gripper_actions(
        np.asarray(act["gripper_closedness_action"], np.float32).reshape(-1, 1)[:, 0]
    )[:, None]
    cart = np.asarray(obs["end_effector_cartesian_pos"], np.float32)
    eef = rotation.coordinate_transform_jaco(cart[:, :6]).astype(np.float32)
    grip_state = np.clip(cart[:, -1:] * 4.33, 0, 1)
    return _canonical(
        base_imgs=obs.get("image"),
        wrist_imgs=obs.get("image_wrist"),
        eef_state=eef,
        gripper_state=grip_state,
        action=np.concatenate([eef, grip], axis=-1),
        gripper_action=grip,
        instructions=_instructions(steps),
    )


@register_dataset("berkeley_cable_routing", control_frequency=10.0, state_encoding="none")
def berkeley_cable_routing_dataset_transform(episode: dict) -> dict:
    steps = _steps(episode)
    obs = steps["observation"]
    act = steps["action"]
    action = np.concatenate(
        [
            np.asarray(act["world_vector"], np.float32),
            np.asarray(act["rotation_delta"], np.float32),
            np.zeros((len(act["world_vector"]), 1), np.float32),
        ],
        axis=-1,
    )
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=obs.get("wrist45_image"),
        action=action, instructions=_instructions(steps),
    )


@register_dataset("roboturk", control_frequency=10.0, state_encoding="none")
def roboturk_dataset_transform(episode: dict) -> dict:
    steps = _steps(episode)
    obs = steps["observation"]
    act = steps["action"]
    grip = invert_gripper_actions(
        np.clip(np.asarray(act["gripper_closedness_action"], np.float32).reshape(-1, 1), 0, 1)
    )
    action = np.concatenate(
        [np.asarray(act["world_vector"], np.float32),
         np.asarray(act["rotation_delta"], np.float32), grip],
        axis=-1,
    )
    return _canonical_delta(
        base_imgs=obs.get("front_rgb"), wrist_imgs=None,
        action=action, instructions=_instructions(steps),
    )


@register_dataset("viola", control_frequency=20.0)
def viola_dataset_transform(episode: dict) -> dict:
    steps = _steps(episode)
    obs = steps["observation"]
    act = steps["action"]
    grip = invert_gripper_actions(
        np.clip(np.asarray(act["gripper_closedness_action"], np.float32).reshape(-1, 1), 0, 1)
    )
    # ee_states: column-major flattened 4x4 -> transpose to row-major.
    mats = np.asarray(obs["ee_states"], np.float32)[:, -16:].reshape(-1, 4, 4)
    mats = np.swapaxes(mats, -1, -2)
    eef = rotation.matrix_state_to_xyzrpy(mats).astype(np.float32)
    grip_state = np.clip(np.asarray(obs["gripper_states"], np.float32).reshape(-1, 1) / 0.079, 0, 1)
    return _canonical(
        base_imgs=obs.get("agentview_rgb"),
        wrist_imgs=obs.get("eye_in_hand_rgb"),
        eef_state=eef,
        gripper_state=grip_state,
        action=np.concatenate([eef, grip], axis=-1),
        gripper_action=grip,
        instructions=_instructions(steps),
    )


@register_dataset("berkeley_autolab_ur5", control_frequency=5.0)
def berkeley_autolab_ur5_dataset_transform(episode: dict) -> dict:
    steps = _steps(episode)
    obs = steps["observation"]
    act = steps["action"]
    robot_state = np.asarray(obs["robot_state"], np.float32)[:, 6:14]
    eef = np.concatenate(
        [robot_state[:, :3], rotation.quat_to_euler(robot_state[:, 3:7]).astype(np.float32)],
        axis=-1,
    )
    grip_state = np.clip(invert_gripper_actions(robot_state[:, -1:]), 0, 1)
    grip = rel2abs_gripper_actions(
        np.asarray(act["gripper_closedness_action"], np.float32).reshape(-1)
    )[:, None]
    return _canonical(
        base_imgs=obs.get("image"),
        wrist_imgs=obs.get("hand_image"),
        eef_state=eef,
        gripper_state=grip_state,
        action=np.concatenate([eef, grip], axis=-1),
        gripper_action=grip,
        instructions=_instructions(steps),
    )


@register_dataset("toto", control_frequency=30.0, state_encoding="none")
def toto_dataset_transform(episode: dict) -> dict:
    steps = _steps(episode)
    obs = steps["observation"]
    act = steps["action"]
    action = np.concatenate(
        [np.asarray(act["world_vector"], np.float32),
         np.asarray(act["rotation_delta"], np.float32),
         np.asarray(act["open_gripper"], np.float32).reshape(-1, 1)],
        axis=-1,
    )
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=None,
        action=action, instructions=_instructions(steps),
    )


@register_dataset("language_table", control_frequency=10.0, state_encoding="none")
def language_table_dataset_transform(episode: dict) -> dict:
    steps = _steps(episode)
    obs = steps["observation"]
    act2d = np.asarray(steps["action"], np.float32)
    t = len(act2d)
    action = np.concatenate(
        [act2d, np.zeros((t, 4), np.float32), np.ones((t, 1), np.float32)], axis=-1
    )[:, :7]
    # Instructions stored as padded unicode codepoints.
    raw = obs.get("instruction")
    instructions = []
    for row in (raw if raw is not None else []):
        arr = np.asarray(row).astype(np.int64)
        chars = [chr(c) for c in arr if c > 0]
        instructions.append("".join(chars))
    return _canonical_delta(
        base_imgs=obs.get("rgb"), wrist_imgs=None,
        action=action, instructions=instructions or [""] * t, t=t,
    )


@register_dataset("stanford_hydra", exact=False, control_frequency=10.0)
def stanford_hydra_dataset_transform(episode: dict) -> dict:
    steps = _steps(episode)
    obs = steps["observation"]
    action = np.asarray(steps["action"], np.float32)
    action = np.concatenate(
        [action[:, :6], invert_gripper_actions(action[:, -1:])], axis=-1
    )
    state = np.asarray(obs["state"], np.float32)
    eef = np.concatenate([state[:, :3], state[:, 7:10]], axis=-1)
    grip_state = np.clip(invert_gripper_actions(state[:, -3:-2]), 0, 1)
    return _canonical(
        base_imgs=obs.get("image"),
        wrist_imgs=obs.get("wrist_image"),
        eef_state=eef,
        gripper_state=grip_state,
        action=action,
        gripper_action=action[:, -1:],
        instructions=_instructions(steps),
    )


def _matrix_state_transform(
    episode: dict, *, gripper_scale: float = 0.079, fill_empty_lang: bool = False
) -> dict:
    """Austin-style datasets: state carries a flattened 4x4 EEF matrix in the
    last 16 dims and gripper joint at index 7."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    # column-major flattened 4x4 -> row-major (ref transform_helpers.py:56-82)
    mats = np.swapaxes(state[:, -16:].reshape(-1, 4, 4), -1, -2)
    eef = rotation.matrix_state_to_xyzrpy(mats).astype(np.float32)
    grip_state = np.clip(state[:, 7:8] / gripper_scale, 0, 1)
    action = np.asarray(steps["action"], np.float32)
    grip = invert_gripper_actions(np.clip(action[:, -1:], 0, 1))
    instructions = _instructions(steps)
    if fill_empty_lang:
        # ref transform_helpers.py:318: hash over the REBUILT 7-dim state.
        instructions = fill_empty_instructions(
            instructions, np.concatenate([eef, grip_state], axis=-1)[0]
        )
    return _canonical(
        base_imgs=obs.get("image"),
        wrist_imgs=obs.get("wrist_image"),
        eef_state=eef,
        gripper_state=grip_state,
        action=np.concatenate([eef, grip], axis=-1),
        gripper_action=grip,
        instructions=instructions,
    )


@register_dataset("austin_buds", exact=False, control_frequency=20.0)
def austin_buds_dataset_transform(episode: dict) -> dict:
    # ref transforms.py:716-729: buds fills empty language deterministically.
    return _matrix_state_transform(episode, fill_empty_lang=True)


@register_dataset("utaustin_mutex", exact=False, control_frequency=20.0)
def austin_dataset_transform(episode: dict) -> dict:
    return _matrix_state_transform(episode)


def _sailor_sirius_transform(episode: dict, *, deterministic_fallback: bool) -> dict:
    """reference transforms.py:869-926: the EEF matrix comes from the
    dedicated ``state_ee`` key (NOT the tail of ``state`` as in buds/mutex)
    and the gripper joint is the LAST column of ``state``. Both fill empty
    language instructions (sailor deterministically, sirius randomly)."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    state_ee = np.asarray(obs["state_ee"], np.float32)
    mats = np.swapaxes(state_ee[:, -16:].reshape(-1, 4, 4), -1, -2)
    eef = rotation.matrix_state_to_xyzrpy(mats).astype(np.float32)
    grip_state = np.clip(state[:, -1:] / 0.079, 0, 1)
    action = np.asarray(steps["action"], np.float32)
    grip = invert_gripper_actions(np.clip(action[:, -1:], 0, 1))
    instructions = fill_empty_instructions(
        _instructions(steps),
        np.concatenate([eef, grip_state], axis=-1)[0],
        deterministic=deterministic_fallback,
    )
    return _canonical(
        base_imgs=obs.get("image"),
        wrist_imgs=obs.get("wrist_image"),
        eef_state=eef,
        gripper_state=grip_state,
        action=np.concatenate([eef, grip], axis=-1),
        gripper_action=grip,
        instructions=instructions,
    )


@register_dataset("austin_sailor", exact=False, control_frequency=20.0)
def austin_sailor_dataset_transform(episode: dict) -> dict:
    return _sailor_sirius_transform(episode, deterministic_fallback=True)


@register_dataset("austin_sirius", exact=False, control_frequency=20.0)
def austin_sirius_dataset_transform(episode: dict) -> dict:
    return _sailor_sirius_transform(episode, deterministic_fallback=False)


@register_dataset("furniture_bench", exact=False, control_frequency=10.0)
def furniture_bench_dataset_transform(episode: dict) -> dict:
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    eef = np.concatenate(
        [state[:, :3], rotation.quat_to_euler(state[:, 3:7]).astype(np.float32)], axis=-1
    )
    grip_state = np.clip(state[:, -1:] / 0.079, 0, 1)
    action = np.asarray(steps["action"], np.float32)
    grip = invert_gripper_actions(np.clip(action[:, -1:], 0, 1))
    return _canonical(
        base_imgs=obs.get("image"),
        wrist_imgs=obs.get("wrist_image"),
        eef_state=eef,
        gripper_state=grip_state,
        action=np.concatenate([eef, grip], axis=-1),
        gripper_action=grip,
        instructions=_instructions(steps),
    )


@register_dataset("bc_z", control_frequency=10.0)
def bc_z_dataset_transform(episode: dict) -> dict:
    steps = _steps(episode)
    obs = steps["observation"]
    act = steps["action"]
    grip = invert_gripper_actions(
        np.asarray(_g(act, "future/target_close"), np.float32).reshape(len(_g(obs, "present/xyz")), -1)[:, :1]
    )
    present_euler = rotation.axis_angle_to_euler(
        np.asarray(_g(obs, "present/axis_angle"), np.float32)[:, :3]
    )
    eef = rotation.coordinate_transform_bcz(
        np.concatenate(
            [np.asarray(_g(obs, "present/xyz"), np.float32)[:, :3], present_euler], axis=-1
        )
    ).astype(np.float32)
    grip_state = np.clip(
        invert_gripper_actions(
            np.asarray(_g(obs, "present/sensed_close"), np.float32).reshape(-1, 1)
        ) / 0.8, 0, 1,
    )
    return _canonical(
        base_imgs=obs.get("image"),
        wrist_imgs=None,
        eef_state=eef,
        gripper_state=grip_state,
        action=np.concatenate([eef, grip], axis=-1),
        gripper_action=grip,
        instructions=_instructions(steps),
    )


@register_dataset("dobbe", control_frequency=4.0)
def dobbe_dataset_transform(episode: dict) -> dict:
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    eef = rotation.coordinate_transform_dobbe(state[:, :6]).astype(np.float32)
    grip_state = np.clip(state[:, -1:], 0, 1)
    action = np.asarray(steps["action"], np.float32)
    # reference transforms.py:1369-1394 keeps the raw (unclipped) gripper
    # action in both the action tail and the language action
    grip = action[:, -1:]
    return _canonical(
        base_imgs=obs.get("wrist_image", obs.get("image")),
        wrist_imgs=None,
        eef_state=eef,
        gripper_state=grip_state,
        action=np.concatenate([eef, grip], axis=-1),
        gripper_action=grip,
        language_action=np.concatenate(
            [compute_padded_movement_actions(eef), grip], axis=-1
        ),
        instructions=_instructions(steps),
    )


@register_dataset("cmu_stretch", control_frequency=10.0)
def cmu_stretch_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1284-1309: eef = xyz + zero rpy; the gripper
    joint angle (radians) maps to [0,1] via (g + pi) / 2pi and doubles as the
    gripper action."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    eef = np.concatenate([state[:, :3], np.zeros_like(state[:, :3])], axis=-1)
    grip_state = (state[:, -1:] + 3.14) / 6.28
    return _canonical(
        base_imgs=obs.get("image"),
        wrist_imgs=None,
        eef_state=eef,
        gripper_state=grip_state,
        action=np.concatenate([eef, grip_state], axis=-1),
        gripper_action=grip_state,
        language_action=np.concatenate(
            [compute_padded_movement_actions(eef), grip_state], axis=-1
        ),
        instructions=_instructions(steps),
    )


@register_dataset("fmb", control_frequency=10.0)
def fmb_dataset_transform(episode: dict) -> dict:
    steps = _steps(episode)
    obs = steps["observation"]
    eef_pose = np.asarray(obs["eef_pose"], np.float32)
    eef = np.concatenate(
        [eef_pose[:, :3], rotation.quat_to_euler(eef_pose[:, 3:7]).astype(np.float32)],
        axis=-1,
    )
    # reference transforms.py:1340-1367: BOTH grippers are inverted; the
    # state gripper is clipped after inversion, the action gripper is not.
    grip_state = np.clip(
        invert_gripper_actions(np.asarray(obs["state_gripper_pose"], np.float32).reshape(-1, 1)),
        0,
        1,
    )
    action = np.asarray(steps["action"], np.float32)
    grip = invert_gripper_actions(action[:, -1:])
    return _canonical(
        base_imgs=obs.get("image_side_1"),
        wrist_imgs=obs.get("image_wrist_1"),
        eef_state=eef,
        gripper_state=grip_state,
        action=np.concatenate([eef, grip], axis=-1),
        gripper_action=grip,
        instructions=_instructions(steps),
        # explicit: the reference does NOT clip the language-action gripper
        language_action=np.concatenate(
            [compute_padded_movement_actions(eef), grip], axis=-1
        ),
    )


@register_dataset("gnm", exact=False, control_frequency=4.0, is_navigation=True)
def gnm_dataset_transform(episode: dict) -> dict:
    """Navigation datasets: 2D position + yaw, no gripper."""
    steps = _steps(episode)
    obs = steps["observation"]
    pos = np.asarray(obs["position"], np.float32)
    yaw = np.asarray(obs["yaw"], np.float32).reshape(-1, 1)
    t = len(pos)
    eef = np.concatenate([pos[:, :2], np.zeros((t, 1), np.float32),
                          np.zeros((t, 2), np.float32), yaw], axis=-1)
    # Reference (transforms.py:1312-1335): the gripper column is ZERO for
    # navigation robots (no gripper), in state, action, and language_action.
    grip = np.zeros((t, 1), np.float32)
    return _canonical(
        base_imgs=obs.get("image"),
        wrist_imgs=None,
        eef_state=eef,
        gripper_state=grip,
        action=np.concatenate([eef, grip], axis=-1),
        gripper_action=grip,
        instructions=_instructions(steps),
    )


# ---------------------------------------------------------------------------
# OXE long tail (reference transforms.py:275-1658, registry :1662-1766).
# These carry per-step delta actions and optional proprio; gripper
# conventions follow the reference (1 = open after standardization).
# ---------------------------------------------------------------------------


@register_dataset("ppgm", exact=False, control_frequency=5.0)
def ppgm_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:275-285 (ppgm / ppgm_static / ppgm_wrist)."""
    steps = _steps(episode)
    obs = steps["observation"]
    action = np.asarray(steps["action"], np.float32)
    action = np.concatenate(
        [action[:, :6], binarize_gripper_actions(action[:, -1])[:, None]], axis=-1
    )
    cart = np.asarray(obs["cartesian_position"], np.float32)
    grip = np.asarray(obs["gripper_position"], np.float32).reshape(len(cart), -1)
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=obs.get("wrist_image"),
        action=action, instructions=_instructions(steps),
        eef_state=cart[:, :6], gripper_state=grip[:, -1:],
    )


@register_dataset("nyu_door_opening", exact=False, control_frequency=3.0, state_encoding="none")
def nyu_door_opening_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:514-531."""
    steps = _steps(episode)
    obs = steps["observation"]
    act = steps["action"]
    grip = rel2abs_gripper_actions(
        np.asarray(act["gripper_closedness_action"], np.float32).reshape(-1, 1)[:, 0]
    )[:, None]
    action = np.concatenate(
        [np.asarray(act["world_vector"], np.float32),
         np.asarray(act["rotation_delta"], np.float32), grip], axis=-1
    )
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=None,
        action=action, instructions=_instructions(steps),
    )


@register_dataset("columbia_cairlab_pusht_real", exact=False, control_frequency=10.0, state_encoding="none")
def pusht_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:659-669."""
    steps = _steps(episode)
    obs = steps["observation"]
    act = steps["action"]
    grip = np.asarray(act["gripper_closedness_action"], np.float32).reshape(-1, 1)
    action = np.concatenate(
        [np.asarray(act["world_vector"], np.float32),
         np.asarray(act["rotation_delta"], np.float32), grip], axis=-1
    )
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=obs.get("wrist_image"),
        action=action, instructions=_instructions(steps),
    )


@register_dataset("stanford_kuka_multimodal", exact=False, control_frequency=20.0, state_encoding="none")
def stanford_kuka_multimodal_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:672-682."""
    steps = _steps(episode)
    obs = steps["observation"]
    action = np.asarray(steps["action"], np.float32)
    t = len(action)
    action = np.concatenate(
        [action[:, :3], np.zeros((t, 3), np.float32), action[:, -1:]], axis=-1
    )
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=None,
        action=action, instructions=_instructions(steps),
    )


@register_dataset("nyu_rot_dataset", exact=False, control_frequency=3.0)
def nyu_rot_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:685-689."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    action = np.asarray(steps["action"], np.float32)[:, :7]
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=None,
        action=action, instructions=_instructions(steps),
        eef_state=state[:, :6], gripper_state=state[:, -1:],
    )


@register_dataset("nyu_franka_play", exact=False, control_frequency=3.0)
def nyu_franka_play_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:732-754."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    action = np.asarray(steps["action"], np.float32)
    action = np.concatenate(
        [action[:, -8:-2], np.clip(action[:, -2:-1], 0, 1)], axis=-1
    )
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=obs.get("image_additional_view"),
        action=action, instructions=_instructions(steps),
        eef_state=state[:, -6:],
    )


@register_dataset("maniskill_dataset", exact=False, control_frequency=20.0)
def maniskill_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:793-795."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    action = np.asarray(steps["action"], np.float32)
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=obs.get("wrist_image"),
        action=action, instructions=_instructions(steps),
        eef_state=np.zeros((len(action), 6), np.float32), gripper_state=state[:, 7:8],
    )


@register_dataset("cmu_franka_exploration", exact=False, control_frequency=10.0, state_encoding="none")
def cmu_franka_exploration_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:827-829 (drop trailing episode-phase dim)."""
    steps = _steps(episode)
    obs = steps["observation"]
    action = np.asarray(steps["action"], np.float32)[..., :-1]
    return _canonical_delta(
        base_imgs=obs.get("highres_image", obs.get("image")), wrist_imgs=None,
        action=action, instructions=_instructions(steps),
    )


@register_dataset("ucsd_kitchen_dataset", exact=False, control_frequency=2.0, state_encoding="none")
def ucsd_kitchen_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:832-852."""
    steps = _steps(episode)
    obs = steps["observation"]
    action = np.asarray(steps["action"], np.float32)[..., :-1]
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=None,
        action=action, instructions=_instructions(steps),
    )


@register_dataset("ucsd_pick_and_place_dataset", exact=False, control_frequency=3.0)
def ucsd_pick_place_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:855-866."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    action = np.asarray(steps["action"], np.float32)
    t = len(action)
    action = np.concatenate(
        [action[:, :3], np.zeros((t, 3), np.float32), action[:, -1:]], axis=-1
    )
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=None,
        action=action, instructions=_instructions(steps),
        eef_state=state[:, :6], gripper_state=state[:, -1:],
    )


@register_dataset("utokyo_pr2", exact=False, control_frequency=10.0)
def utokyo_pr2_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:969-980 (opening_fridge + tabletop share it)."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    action = np.asarray(steps["action"], np.float32)[..., :-1]
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=None,
        action=action, instructions=_instructions(steps),
        eef_state=state[:, :6], gripper_state=state[:, -1:],
    )


@register_dataset("utokyo_xarm_pick_and_place", exact=False, control_frequency=10.0, state_encoding="none")
def utokyo_xarm_pick_place_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:983-984 (identity)."""
    steps = _steps(episode)
    obs = steps["observation"]
    action = np.asarray(steps["action"], np.float32)
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=obs.get("hand_image"),
        action=action, instructions=_instructions(steps),
    )


@register_dataset("utokyo_xarm_bimanual", exact=False, control_frequency=10.0, state_encoding="none")
def utokyo_xarm_bimanual_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:987-989 (keep last arm's 7 dims)."""
    steps = _steps(episode)
    obs = steps["observation"]
    action = np.asarray(steps["action"], np.float32)[..., -7:]
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=None,
        action=action, instructions=_instructions(steps),
    )


@register_dataset("robo_net", exact=False, control_frequency=1.0)
def robo_net_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:992-1009 (4-DoF: xyz + yaw)."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    action = np.asarray(steps["action"], np.float32)
    t = len(action)
    eef = np.concatenate([state[:, :4], np.zeros((t, 2), np.float32)], axis=-1)
    action = np.concatenate(
        [action[:, :4], np.zeros((t, 2), np.float32), action[:, -1:]], axis=-1
    )
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=obs.get("image1"),
        action=action, instructions=_instructions(steps),
        eef_state=eef, gripper_state=state[:, -1:],
    )


@register_dataset("berkeley_mvp", exact=False, control_frequency=5.0, state_encoding="joint")
@register_dataset("berkeley_rpt", exact=False, control_frequency=30.0, state_encoding="joint")
def berkeley_mvp_rpt_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1012-1017 (identity; joint-space actions)."""
    steps = _steps(episode)
    obs = steps["observation"]
    action = np.asarray(steps["action"], np.float32)
    return _canonical_delta(
        base_imgs=obs.get("hand_image", obs.get("image")), wrist_imgs=None,
        action=action, instructions=_instructions(steps),
    )


@register_dataset("kaist_nonprehensile", exact=False, control_frequency=10.0)
def kaist_nonprehensile_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1020-1029."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)[:, -7:]
    action = np.asarray(steps["action"], np.float32)
    action = np.concatenate(
        [action[:, :6], np.zeros((len(action), 1), np.float32)], axis=-1
    )
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=None,
        action=action, instructions=_instructions(steps),
        eef_state=state[:, :6], gripper_state=state[:, -1:],
    )


@register_dataset("stanford_mask_vit", exact=False, control_frequency=1.0)
def stanford_mask_vit_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1032-1049 (4-DoF sawyer)."""
    steps = _steps(episode)
    obs = steps["observation"]
    pose = np.asarray(obs["end_effector_pose"], np.float32)
    action = np.asarray(steps["action"], np.float32)
    t = len(action)
    eef = np.concatenate([pose[:, :4], np.zeros((t, 2), np.float32)], axis=-1)
    action = np.concatenate(
        [action[:, :4], np.zeros((t, 2), np.float32), action[:, -1:]], axis=-1
    )
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=None,
        action=action, instructions=_instructions(steps),
        eef_state=eef, gripper_state=pose[:, -1:],
    )


@register_dataset("tokyo_u_lsmo", exact=False, control_frequency=10.0)
def tokyo_lsmo_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1052-1055."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    action = np.asarray(steps["action"], np.float32)
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=None,
        action=action, instructions=_instructions(steps),
        eef_state=state[:, :6], gripper_state=state[:, -1:],
    )


@register_dataset("dlr_sara_pour", exact=False, control_frequency=10.0, state_encoding="none")
def dlr_sara_pour_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1058-1059 (identity)."""
    steps = _steps(episode)
    obs = steps["observation"]
    action = np.asarray(steps["action"], np.float32)
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=None,
        action=action, instructions=_instructions(steps),
    )


@register_dataset("dlr_sara_grid_clamp", exact=False, control_frequency=10.0)
def dlr_sara_grid_clamp_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1062-1064."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)[:, :6]
    action = np.asarray(steps["action"], np.float32)
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=None,
        action=action, instructions=_instructions(steps),
        eef_state=state,
    )


@register_dataset("dlr_edan_shared_control", exact=False, control_frequency=5.0)
def dlr_edan_shared_control_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1067-1100 (intrinsic ZXY -> extrinsic XYZ)."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    action = np.asarray(steps["action"], np.float32)
    grip = np.clip(invert_gripper_actions(action[:, -1:]), 0, 1)
    eef = np.concatenate(
        [state[:, :3], rotation.zxy_to_xyz(state[:, 3:6]).astype(np.float32)], axis=-1
    )
    grip_state = invert_gripper_actions(state[:, -1:])
    return _canonical(
        base_imgs=obs.get("image"), wrist_imgs=None,
        eef_state=eef, gripper_state=grip_state,
        action=np.concatenate([eef, grip], axis=-1),
        gripper_action=grip, instructions=_instructions(steps),
    )


@register_dataset("asu_table_top", exact=False, control_frequency=12.5)
def asu_table_top_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1103-1106."""
    steps = _steps(episode)
    obs = steps["observation"]
    gts = episode.get("ground_truth_states", steps.get("ground_truth_states", {}))
    eef = np.asarray(gts.get("EE", np.zeros((len(steps["action"]), 6))), np.float32)
    state = np.asarray(obs["state"], np.float32)
    action = np.asarray(steps["action"], np.float32)
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=None,
        action=action, instructions=_instructions(steps),
        eef_state=eef[:, :6], gripper_state=state[:, -1:],
    )


@register_dataset("stanford_robocook", exact=False, control_frequency=5.0)
def robocook_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1109-1112."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    action = np.asarray(steps["action"], np.float32)
    return _canonical_delta(
        base_imgs=obs.get("image_1"), wrist_imgs=obs.get("image_2"),
        action=action, instructions=_instructions(steps),
        eef_state=state[:, :6], gripper_state=state[:, -1:],
    )


@register_dataset("imperialcollege_sawyer_wrist_cam", exact=False, control_frequency=10.0, state_encoding="none")
def imperial_wristcam_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1115-1117."""
    steps = _steps(episode)
    obs = steps["observation"]
    action = np.asarray(steps["action"], np.float32)[..., :-1]
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=obs.get("wrist_image"),
        action=action, instructions=_instructions(steps),
    )


@register_dataset("iamlab_cmu_pickup_insert", exact=False, control_frequency=20.0)
def iamlab_pick_insert_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1120-1133 (quat action -> euler)."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    action = np.asarray(steps["action"], np.float32)
    action = np.concatenate(
        [action[:, :3],
         rotation.quat_to_euler(action[:, 3:7]).astype(np.float32),
         action[:, 7:8]],
        axis=-1,
    )
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=obs.get("wrist_image"),
        action=action, instructions=_instructions(steps),
        eef_state=np.zeros((len(action), 6), np.float32), gripper_state=state[:, 7:8],
    )


@register_dataset("uiuc_d3field", exact=False, control_frequency=1.0, state_encoding="none")
def uiuc_d3field_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1136-1145 (xyz-only deltas)."""
    steps = _steps(episode)
    obs = steps["observation"]
    action = np.asarray(steps["action"], np.float32)
    t = len(action)
    action = np.concatenate([action, np.zeros((t, 4), np.float32)], axis=-1)[:, :7]
    return _canonical_delta(
        base_imgs=obs.get("image_1"), wrist_imgs=obs.get("image_2"),
        action=action, instructions=_instructions(steps),
    )


@register_dataset("berkeley_fanuc_manipulation", exact=False, control_frequency=10.0)
def berkeley_fanuc_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1209-1242 (gripper action from state; the
    language action keeps the commanded deltas rather than reached-state
    movements)."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    ee = np.asarray(obs["end_effector_state"], np.float32)
    raw_action = np.asarray(steps["action"], np.float32)
    # Reference clip/invert order (transforms.py:1215-1242) is subtle: the
    # language action inverts the RAW state gripper (unclipped); the state
    # column is clip(invert(raw)); and the action gripper re-inverts the
    # already-replaced state column — i.e. invert(clip(invert(raw))), which
    # equals clip(raw, 0, 1).
    grip_raw = invert_gripper_actions(state[:, 6:7])
    grip_state = np.clip(grip_raw, 0, 1)
    grip_action = invert_gripper_actions(grip_state)
    eef = np.concatenate(
        [ee[:, :3], rotation.quat_to_euler(ee[:, 3:7]).astype(np.float32)], axis=-1
    )
    return _canonical(
        base_imgs=obs.get("image"), wrist_imgs=obs.get("wrist_image"),
        eef_state=eef, gripper_state=grip_state,
        action=np.concatenate([eef, grip_action], axis=-1),
        gripper_action=grip_action, instructions=_instructions(steps),
        language_action=np.concatenate([raw_action[:, :6], grip_raw], axis=-1),
    )


@register_dataset("cmu_playing_with_food", exact=False, control_frequency=10.0, state_encoding="none")
def cmu_playing_with_food_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1259-1270 (quat action -> euler)."""
    steps = _steps(episode)
    obs = steps["observation"]
    action = np.asarray(steps["action"], np.float32)
    action = np.concatenate(
        [action[:, :3],
         rotation.quat_to_euler(action[:, 3:7]).astype(np.float32),
         action[:, -1:]],
        axis=-1,
    )
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=obs.get("finger_vision_1"),
        action=action, instructions=_instructions(steps),
    )


@register_dataset("cmu_play_fusion", exact=False, control_frequency=5.0, state_encoding="none")
def playfusion_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1273-1281."""
    steps = _steps(episode)
    obs = steps["observation"]
    action = np.asarray(steps["action"], np.float32)
    action = np.concatenate([action[:, :3], action[:, -4:]], axis=-1)
    return _canonical_delta(
        base_imgs=obs.get("image"), wrist_imgs=None,
        action=action, instructions=_instructions(steps),
    )


@register_dataset("roboset", exact=False, control_frequency=5.0, state_encoding="joint")
def roboset_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1397-1419 (8-dim joint actions, inverted
    gripper in both state and action)."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    action = np.asarray(steps["action"], np.float32)
    grip_action = invert_gripper_actions(np.clip(action[:, -1:], 0, 1))
    action = np.concatenate([action[:, :7], grip_action], axis=-1)
    eef = state[:, :6]
    grip_state = invert_gripper_actions(np.clip(state[:, -1:], 0, 1))
    return _canonical_delta(
        base_imgs=obs.get("image_left"), wrist_imgs=obs.get("image_wrist"),
        action=action, instructions=_instructions(steps),
        eef_state=eef, gripper_state=grip_state,
    )


@register_dataset("rh20t", exact=False, control_frequency=10.0)
def rh20t_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1422-1437."""
    steps = _steps(episode)
    obs = steps["observation"]
    act = steps["action"]
    tcp = np.asarray(act["tcp_base"], np.float32)
    grip = np.asarray(act["gripper"], np.float32).reshape(-1, 1)
    action = np.concatenate([tcp, grip], axis=-1)
    tcp_state = np.asarray(obs["tcp_base"], np.float32)
    width = np.asarray(obs["gripper_width"], np.float32).reshape(-1, 1)
    return _canonical_delta(
        base_imgs=obs.get("image_front"), wrist_imgs=obs.get("image_wrist"),
        action=action, instructions=_instructions(steps),
        eef_state=tcp_state[:, :6], gripper_state=width,
    )


@register_dataset("tdroid", exact=False, priority=10, control_frequency=15.0)
def tdroid_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1440-1450 (T-DROID task subsets)."""
    steps = _steps(episode)
    obs = steps["observation"]
    action = np.asarray(steps["action"], np.float32)
    action = np.concatenate(
        [action[:, :6], binarize_gripper_actions(action[:, -1])[:, None]], axis=-1
    )
    cart = np.asarray(obs["cartesian_position"], np.float32)
    grip = np.asarray(obs["gripper_position"], np.float32).reshape(len(cart), -1)
    return _canonical_delta(
        base_imgs=obs.get("static_image", obs.get("exterior_image_1_left", obs.get("image"))),
        wrist_imgs=obs.get("wrist_image", obs.get("wrist_image_left")),
        action=action, instructions=_instructions(steps),
        eef_state=cart[:, :6], gripper_state=grip[:, -1:],
    )


@register_dataset("ego4d", exact=False, control_frequency=5.0, state_encoding="none")
def human_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1484-1512 (human video: no robot actions)."""
    steps = _steps(episode)
    obs = steps["observation"]
    imgs = obs.get("image", [])
    t = len(imgs)
    action = np.zeros((t, 7), np.float32)
    return _canonical_delta(
        base_imgs=imgs, wrist_imgs=None,
        action=action, instructions=_instructions(steps),
    )


@register_dataset("sample_r1_lite", exact=False, is_bimanual=True, control_frequency=15.0)
def sample_r1_lite_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1515-1538 (bimanual EEF: [L xyzrpy, L grip,
    R xyzrpy, R grip] -> 14-dim per-step movement actions)."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    raw_action = np.asarray(steps["action"], np.float32)
    left = compute_padded_movement_actions(state[:, :6])
    right = compute_padded_movement_actions(state[:, 7:13])
    action = np.concatenate(
        [left, raw_action[:, 6:7] / 100, right, raw_action[:, 13:14] / 100], axis=-1
    ).astype(np.float32)
    t = len(action)
    base = obs.get("image_camera_head", obs.get("image"))
    return {
        "observation": {
            "base_0_rgb": list(base),
            "left_wrist_0_rgb": list(obs.get("image_camera_wrist_left", [b""] * t)),
            "right_wrist_0_rgb": list(obs.get("image_camera_wrist_right", [b""] * t)),
            "state": state[:, :14].astype(np.float32),
        },
        "raw_state": state[:, :14].astype(np.float32).copy(),
        "action": action,
        "language_action": action.copy(),
        "language_instruction": _instructions(steps),
    }


@register_dataset("agibot", exact=False, is_bimanual=True, control_frequency=30.0)
def agibot_large_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1541-1556 (bimanual; inverted grippers)."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    raw_action = np.asarray(steps["action"], np.float32)
    left = compute_padded_movement_actions(state[:, :6])
    right = compute_padded_movement_actions(state[:, 7:13])
    action = np.concatenate(
        [left, invert_gripper_actions(raw_action[:, 6:7]),
         right, invert_gripper_actions(raw_action[:, 13:14])], axis=-1
    ).astype(np.float32)
    t = len(action)
    base = obs.get("head_image", obs.get("image"))
    return {
        "observation": {
            "base_0_rgb": list(base),
            "left_wrist_0_rgb": list(obs.get("image_camera_wrist_left", [b""] * t)),
            "right_wrist_0_rgb": list(obs.get("image_camera_wrist_right", [b""] * t)),
            "state": state[:, :14].astype(np.float32),
        },
        "raw_state": state[:, :14].astype(np.float32).copy(),
        "action": action,
        "language_action": action.copy(),
        "language_instruction": _instructions(steps),
    }


@register_dataset("molmoact", exact=False, control_frequency=15.0)
def molmoact_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1184-1206."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    raw_action = np.asarray(steps["action"], np.float32)
    grip = invert_gripper_actions(raw_action[:, -1:])
    eef = state[:, :6]
    grip_state = invert_gripper_actions(state[:, -1:])
    return _canonical(
        base_imgs=obs.get("first_view_image", obs.get("image")),
        wrist_imgs=obs.get("wrist_image"),
        eef_state=eef, gripper_state=grip_state,
        action=np.concatenate([eef, grip], axis=-1),
        gripper_action=grip, instructions=_instructions(steps),
        language_action=np.concatenate([raw_action[:, :-1], grip], axis=-1),
    )


@register_dataset("planning_dataset", exact=False, control_frequency=5.0)
def planning_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1559-1582 (r6 rotation encoding in both
    state (wxyz quat) and action (axis-angle))."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    raw_action = np.asarray(steps["action"], np.float32)
    state = np.concatenate(
        [state[:, :6],
         rotation.quat_wxyz_to_r6(state[:, 6:10]).astype(np.float32),
         state[:, 10:]],
        axis=-1,
    )
    action = np.concatenate(
        [raw_action[:, :6],
         rotation.axis_angle_to_r6(raw_action[:, 6:9]).astype(np.float32),
         raw_action[:, 9:]],
        axis=-1,
    )
    t = len(action)
    return {
        "observation": {
            "base_0_rgb": list(obs.get("image", [])),
            "left_wrist_0_rgb": list(obs.get("wrist_image", [b""] * t)),
            "state": state.astype(np.float32),
        },
        "raw_state": state.astype(np.float32).copy(),
        "action": action.astype(np.float32),
        "language_instruction": _instructions(steps),
    }


@register_dataset("franka_dataset", control_frequency=15.0)
@register_dataset("franka_demo_dataset", control_frequency=15.0)
@register_dataset("franka_towel_demo_dataset", control_frequency=15.0)
@register_dataset("franka_rollout_dataset", control_frequency=15.0)
def franka_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1585-1608."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    raw_action = np.asarray(steps["action"], np.float32)
    eef = state[:, :6]
    grip_state = invert_gripper_actions(np.clip(state[:, 6:7], 0, 1))
    grip = invert_gripper_actions(np.clip(raw_action[:, -1:], 0, 1))
    return _canonical(
        base_imgs=obs.get("image", obs.get("exterior_image_1_left")),
        wrist_imgs=obs.get("wrist_image", obs.get("wrist_image_left")),
        eef_state=eef, gripper_state=grip_state,
        action=np.concatenate([eef, grip], axis=-1),
        gripper_action=grip, instructions=_instructions(steps),
    )


@register_dataset("yam_jointpos_dataset", control_frequency=15.0, state_encoding="joint")
@register_dataset("yam_jointpos_dataset_small", control_frequency=15.0, state_encoding="joint")
def yam_jointpos_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1611-1633 (joint actions kept; language
    action from state movement)."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    raw_action = np.asarray(steps["action"], np.float32)
    movement = compute_padded_movement_actions(state[:, :6])
    la = np.concatenate([movement, np.clip(raw_action[:, -1:], 0, 1)], axis=-1)
    t = len(raw_action)
    return {
        "observation": {
            "base_0_rgb": list(obs.get("image", [])),
            "left_wrist_0_rgb": list(obs.get("wrist_image", [b""] * t)),
            "state": state.astype(np.float32),
        },
        "raw_state": state.astype(np.float32).copy(),
        "action": raw_action.astype(np.float32),
        "language_action": la.astype(np.float32),
        "language_instruction": _instructions(steps),
    }


@register_dataset("yam_dataset", control_frequency=15.0)
@register_dataset("yam_demo_dataset", control_frequency=15.0)
@register_dataset("yam_rollout_dataset", control_frequency=15.0)
def yam_dataset_transform(episode: dict) -> dict:
    """reference transforms.py:1636-1658."""
    steps = _steps(episode)
    obs = steps["observation"]
    state = np.asarray(obs["state"], np.float32)
    raw_action = np.asarray(steps["action"], np.float32)
    eef = state[:, :6]
    grip = np.clip(raw_action[:, -1:], 0, 1)
    grip_state = np.clip(state[:, 6:7], 0, 1) if state.shape[-1] > 6 else grip
    return _canonical(
        base_imgs=obs.get("image"), wrist_imgs=obs.get("wrist_image"),
        eef_state=eef, gripper_state=grip_state,
        action=np.concatenate([eef, grip], axis=-1),
        gripper_action=grip, instructions=_instructions(steps),
    )
