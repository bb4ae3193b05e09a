"""Trajectory -> frame pipeline (numpy), the TPU-native tf.data replacement.

Reproduces the reference's RLDS trajectory processing order
(lihzha/lap ``datasets/base_dataset.py:228-353``):

  standardize -> trajectory id -> traj filters -> hash val split ->
  restructure -> state euler->rot6d -> action chunking (+euler deltas) ->
  pad dims -> variable-horizon language-action summation (rotation
  composition) -> prediction pairs -> repack -> flatten -> prediction-frame
  conversion -> frame filters -> image decode (resize-with-pad, wrist
  rotation)

Everything is plain numpy on host threads; randomness is seeded per
trajectory id so results are deterministic across runs/hosts.

Copied from ``lap_tpu/data/episode_pipeline.py``; its imports point at the port's
copies, and ``decode_image``/``encode_jpeg`` call the native codec
(``lap_tpu_torch/native.py``) where JAX calls ``cv2``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
from collections.abc import Callable, Iterator

import numpy as np

from lap_tpu_torch import native
from lap_tpu_torch.data import rotation
from lap_tpu_torch.data.helpers import ActionEncoding, StateEncoding

logger = logging.getLogger(__name__)

HASH_BUCKETS = 2_147_483_647


def stable_hash(text: str, buckets: int = HASH_BUCKETS) -> int:
    digest = hashlib.md5(text.encode()).digest()
    return int.from_bytes(digest[:8], "little") % buckets


def traj_rng(seed: int, traj_id: str) -> np.random.Generator:
    return np.random.default_rng((seed * 1_000_003 + stable_hash(traj_id)) % 2**63)


def in_val_split(traj_id: str, val_fraction: float, salt: str = "val_split") -> bool:
    """Deterministic salted hash-bucket split (reference mixins.py:80-141)."""
    if not val_fraction:
        return False
    bucket = stable_hash(traj_id + salt, 10_000)
    return bucket < int(val_fraction * 10_000)


def decode_image(data) -> np.ndarray:
    """Encoded JPEG/PNG bytes (or already-decoded array) -> uint8 HWC RGB.

    The port's native codec (``native.decode_image``), where JAX calls
    ``cv2.imdecode``: the same bits, on a host without OpenCV."""
    if isinstance(data, np.ndarray) and data.ndim >= 2:
        return data
    return native.decode_image(data)


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """RGB uint8 HWC -> baseline JPEG bytes through the native encoder (JAX
    calls ``cv2.imencode``; the bytes differ, any decoder reads them)."""
    return native.jpeg_encode(np.asarray(img), quality)


@dataclasses.dataclass
class PipelineConfig:
    action_horizon: int = 16
    action_dim: int = 32
    state_dim: int = 32
    action_encoding: ActionEncoding = ActionEncoding.EEF_POS
    state_encoding: StateEncoding = StateEncoding.POS_EULER
    horizon_seconds: tuple[float, ...] = (1.0,)
    control_frequency: float = 5.0
    seed: int = 0
    val_fraction: float = 0.0
    split: str = "train"
    enable_prediction_training: bool = False
    pred_prob: float = 0.3
    primary_pred_prob: float = 0.8
    resize_resolution: tuple[int, int] = (224, 224)
    needs_wrist_rotation: bool = False
    not_rotate_wrist_prob: float = 0.0
    primary_image_key: str = "base_0_rgb"
    wrist_image_key: str = "left_wrist_0_rgb"


class EpisodePipeline:
    """Applies the full trajectory->frames transform chain."""

    def __init__(
        self,
        config: PipelineConfig,
        *,
        standardize_fn: Callable[[dict], dict] | None = None,
        traj_filter: Callable[[dict], bool] | None = None,
        frame_filter: Callable[[dict], bool] | None = None,
        dataset_name: str = "",
        is_bimanual: bool = False,
        is_navigation: bool = False,
        normalize_fn: Callable[[dict], dict] | None = None,
        grounding_table: dict | None = None,
        grounding_key_fn: Callable[[dict], str | None] | None = None,
        grounding_prob: float = 0.3,
        grounding_direction_prob: float = 0.0,
    ):
        self.cfg = config
        self.standardize_fn = standardize_fn
        self.traj_filter = traj_filter
        self.frame_filter = frame_filter
        self.dataset_name = dataset_name
        self.is_bimanual = is_bimanual
        self.is_navigation = is_navigation
        self.normalize_fn = normalize_fn
        # Robot-frame grounding QA (reference vqa/bbox/table_builder.py):
        # frames with annotated objects become bbox/direction QA samples
        # with probability grounding_prob.
        self.grounding_table = grounding_table
        self.grounding_key_fn = grounding_key_fn
        self.grounding_prob = grounding_prob
        self.grounding_direction_prob = grounding_direction_prob
        self._grounding_key: str | None = None

    # ------------------------------------------------------------------
    def process_episode(self, episode: dict) -> Iterator[dict]:
        """Yield frame dicts for one raw RLDS episode."""
        # Episode-level grounding key must be read off the RAW episode
        # (episode_metadata is dropped by standardization).
        self._grounding_key = (
            self.grounding_key_fn(episode)
            if self.grounding_table is not None and self.grounding_key_fn is not None
            else None
        )
        traj = self.standardize_fn(episode) if self.standardize_fn else episode
        if traj is None:
            return
        traj_id = traj.get("trajectory_id") or self._traj_identifier(traj)

        if self.traj_filter and not self.traj_filter(traj):
            return
        if self.cfg.val_fraction:
            is_val = in_val_split(traj_id, self.cfg.val_fraction)
            if is_val != (self.cfg.split == "val"):
                return
        traj = self._state_to_rot6d(traj)
        traj = self._chunk_actions(traj)
        traj = self._pad_dims(traj)
        traj = self._group_language_actions(traj, traj_id)
        if self.cfg.enable_prediction_training:
            traj = self._add_prediction_pairs(traj, traj_id)
        yield from self._flatten(traj, traj_id)

    # ------------------------------------------------------------------
    def _traj_identifier(self, traj: dict) -> str:
        """Action-hash trajectory id (reference mixins.py:238-286)."""
        actions = np.asarray(traj["action"], dtype=np.float32)
        return hashlib.md5(actions.tobytes()).hexdigest()

    def _state_to_rot6d(self, traj: dict) -> dict:
        state = np.asarray(traj["observation"]["state"], dtype=np.float32)
        raw_state = np.asarray(traj.get("raw_state", state), dtype=np.float32)

        def convert(s):
            return np.concatenate(
                [s[:, :3], rotation.euler_to_r6(s[:, 3:6]).astype(np.float32), s[:, 6:]],
                axis=-1,
            ).astype(np.float32)

        traj["observation"]["state"] = convert(state)
        traj["raw_state"] = convert(raw_state)
        return traj

    def _chunk_actions(self, traj: dict) -> dict:
        """Window the action stream (reference base_dataset.py:387-427)."""
        actions = np.asarray(traj["action"], dtype=np.float32)
        h = self.cfg.action_horizon
        enc = self.cfg.action_encoding
        if enc in (ActionEncoding.JOINT_POS, ActionEncoding.JOINT_POS_BIMANUAL):
            traj["actions"] = rotation.gather_with_padding(
                actions, h, last_value_padding=True
            ).astype(np.float32)
        else:
            win = rotation.gather_with_padding(actions, h + 1, last_value_padding=True)
            traj["actions"] = np.concatenate(
                [
                    win[:, 1:, :3] - win[:, 0:1, :3],
                    rotation.euler_diff(win[:, 1:, 3:6], win[:, 0:1, 3:6]).astype(np.float32),
                    win[:, :-1, 6:7],
                ],
                axis=-1,
            ).astype(np.float32)
        return traj

    def _pad_dims(self, traj: dict) -> dict:
        def pad_last(x, dim):
            extra = dim - x.shape[-1]
            if extra <= 0:
                return x
            pad = [(0, 0)] * (x.ndim - 1) + [(0, extra)]
            return np.pad(x, pad)

        traj["actions"] = pad_last(traj["actions"], self.cfg.action_dim)
        traj["observation"]["state"] = pad_last(traj["observation"]["state"], self.cfg.state_dim)
        traj["raw_state"] = pad_last(traj["raw_state"], self.cfg.state_dim)
        return traj

    def _group_language_actions(self, traj: dict, traj_id: str) -> dict:
        """Variable-horizon per-timestep summed deltas
        (reference base_dataset.py:494-534)."""
        if "language_action" not in traj:
            return traj
        la = np.asarray(traj["language_action"], dtype=np.float64)
        t = la.shape[0]
        rng = traj_rng(self.cfg.seed, traj_id)
        horizon_steps = np.maximum(
            np.round(np.asarray(self.cfg.horizon_seconds) * self.cfg.control_frequency).astype(int),
            1,
        )
        chosen = horizon_steps[rng.integers(0, len(horizon_steps), size=t)]
        remaining = np.maximum(t - np.arange(t), 1)
        valid = np.minimum(chosen, remaining)
        windows = rotation.gather_with_padding(la, int(horizon_steps.max()))
        traj["language_actions"] = rotation.sum_actions(windows, valid).astype(np.float32)
        traj["time_horizon_seconds"] = (valid / self.cfg.control_frequency).astype(np.float32)
        return traj

    def _add_prediction_pairs(self, traj: dict, traj_id: str) -> dict:
        """Current/future frame pairs + their summed deltas
        (reference base_dataset.py:536-581)."""
        t = traj["actions"].shape[0]
        max_h = int(2.5 * self.cfg.control_frequency)
        max_h_cl = max(min(max_h, t - 1), 1)
        deltas = np.full(t, max_h_cl, dtype=np.int64)
        future = np.minimum(np.arange(t) + deltas, t - 1)
        for key in (self.cfg.primary_image_key, self.cfg.wrist_image_key):
            imgs = traj["observation"].get(key)
            if imgs is None:
                continue
            current = list(imgs)
            paired = [(current[i], current[int(future[i])]) for i in range(t)]
            traj["observation"][key] = paired
        if "language_action" in traj:
            la = np.asarray(traj["language_action"], dtype=np.float64)
            windows = rotation.gather_with_padding(la, max_h)
            traj["prediction_language_actions"] = rotation.sum_actions(
                windows, deltas
            ).astype(np.float32)
            traj["prediction_delta"] = deltas
        return traj

    # ------------------------------------------------------------------
    def _flatten(self, traj: dict, traj_id: str) -> Iterator[dict]:
        t = traj["actions"].shape[0]
        obs = traj["observation"]
        prompt_list = traj.get("language_instruction")
        keep_mask = traj.get("frame_keep_mask")
        for i in range(t):
            if keep_mask is not None and not keep_mask[i]:
                continue
            sample = {
                "observation": {"state": obs["state"][i]},
                "actions": traj["actions"][i],
                "raw_state": traj["raw_state"][i],
                "prompt": _pick(prompt_list, i, default=""),
                "dataset_name": self.dataset_name,
                "is_bimanual": self.is_bimanual,
                "is_navigation": self.is_navigation,
                "caption": "",
                "is_vqa_sample": False,
                "vqa_dataset_id": 0,
                "trajectory_id": traj_id,
            }
            if "language_actions" in traj:
                sample["language_actions"] = traj["language_actions"][i]
                sample["time_horizon_seconds"] = float(traj["time_horizon_seconds"][i])
            for key in (self.cfg.primary_image_key, self.cfg.wrist_image_key):
                if key in obs:
                    sample["observation"][key] = _pick(obs[key], i)
            if "prediction_language_actions" in traj:
                sample["prediction_language_actions"] = traj["prediction_language_actions"][i]
                sample["prediction_delta"] = int(traj["prediction_delta"][i])
            frame = self._finalize_frame(sample, traj_id, i)
            if frame is None:
                continue
            if self.frame_filter and not self.frame_filter(frame):
                continue
            if self.normalize_fn is not None:
                frame = self.normalize_fn(frame)
            yield frame

    def _finalize_frame(self, sample: dict, traj_id: str, frame_idx: int) -> dict | None:
        """Prediction conversion + image decode/resize/rotation
        (reference base_dataset.py:610-699, image_utils.py:163-375)."""
        cfg = self.cfg
        rng = traj_rng(cfg.seed + 1, f"{traj_id}_frame{frame_idx}")
        is_pred = False
        pred_use_primary = False
        if cfg.enable_prediction_training and "prediction_language_actions" in sample:
            is_pred = bool(rng.random() < cfg.pred_prob)
            primary_pair = sample["observation"].get(cfg.primary_image_key)
            wrist_pair = sample["observation"].get(cfg.wrist_image_key)
            has_wrist = wrist_pair is not None and _nonempty(wrist_pair[0] if isinstance(wrist_pair, tuple) else wrist_pair)
            pred_use_primary = (not has_wrist) or bool(rng.random() < cfg.primary_pred_prob)
            if isinstance(primary_pair, tuple):
                if is_pred:
                    src = primary_pair if pred_use_primary else wrist_pair
                    sample["observation"][cfg.primary_image_key] = src[0]
                    sample["observation"][cfg.wrist_image_key] = src[1]
                else:
                    sample["observation"][cfg.primary_image_key] = primary_pair[0]
                    if isinstance(wrist_pair, tuple):
                        sample["observation"][cfg.wrist_image_key] = wrist_pair[0]
            if is_pred:
                sample["language_actions"] = sample["prediction_language_actions"]
                sample["time_horizon_seconds"] = sample["prediction_delta"] / cfg.control_frequency
        sample.pop("prediction_language_actions", None)
        sample.pop("prediction_delta", None)
        sample["is_prediction_sample"] = is_pred
        sample["pred_use_primary"] = pred_use_primary
        sample.pop("trajectory_id")

        # Robot-frame grounding QA: when this frame has annotated objects,
        # convert it (with probability) into a bbox/direction QA sample
        # (reference vqa/bbox/ sampling; key format "{episode_key}--{frame}").
        if (
            self.grounding_table is not None
            and self._grounding_key is not None
            and not is_pred
        ):
            objects = self.grounding_table.get(f"{self._grounding_key}--{frame_idx}")
            if objects and rng.random() < self.grounding_prob:
                from lap_tpu_torch.data.grounding import make_grounding_qa

                qa = make_grounding_qa(
                    objects, rng, direction_prob=self.grounding_direction_prob
                )
                if qa is not None:
                    sample["prompt"], sample["caption"] = qa
                    sample["is_vqa_sample"] = True

        # Image decode is DEFERRED to the loader's thread pool (see
        # make_image_decoder): frames cross the shuffle buffer as encoded
        # bytes, ~30x smaller than decoded 224x224 uint8, so million-frame
        # buffers fit in host RAM. Only the rng-dependent rotation decision
        # is made here (it must be a pure function of the trajectory seed).
        # Reference rotation cases (image_utils.py:293-375): regular samples
        # rotate the wrist image; wrist-camera prediction pairs hold wrist
        # frames in BOTH slots and rotate both with ONE decision;
        # primary-camera prediction pairs rotate nothing.
        rot = bool(
            cfg.needs_wrist_rotation
            and not (cfg.not_rotate_wrist_prob > 0 and rng.random() < cfg.not_rotate_wrist_prob)
        )
        if not rot or (is_pred and pred_use_primary):
            rotate_keys: tuple = ()
        elif is_pred:
            rotate_keys = (cfg.primary_image_key, cfg.wrist_image_key)
        else:
            rotate_keys = (cfg.wrist_image_key,)
        sample["_rotate_keys"] = rotate_keys
        sample["has_wrist_image"] = _nonempty(sample["observation"].get(cfg.wrist_image_key))
        return sample


def _pick(seq, i, default=None):
    if seq is None:
        return default
    if isinstance(seq, (list, tuple)):
        return seq[i] if i < len(seq) else (seq[-1] if seq else default)
    arr = seq
    return arr[i] if i < len(arr) else default


def _nonempty(x) -> bool:
    if x is None:
        return False
    if isinstance(x, (bytes, str)):
        return len(x) > 0
    return True


def make_image_decoder(
    resize_resolution: tuple[int, int],
    *,
    primary_image_key: str = "base_0_rgb",
    wrist_image_key: str = "left_wrist_0_rgb",
):
    """Per-sample transform: decode + resize-with-pad + wrist rotation.

    Runs in the loader's thread pool (after the shuffle buffer), replacing
    the reference's in-graph tf.image decode (base_dataset.py:610-699).
    Pass-through for already-decoded arrays (fake/VQA datasets).
    """
    from lap_tpu_torch.utils.image import resize_with_pad_np

    def decode(sample: dict) -> dict:
        rotate_keys = tuple(sample.pop("_rotate_keys", ()))
        if sample.pop("_wrist_rotate", False):  # legacy flag (tests, ckpts)
            rotate_keys = rotate_keys or (wrist_image_key,)
        applied = False
        for key in (primary_image_key, wrist_image_key):
            raw = sample["observation"].get(key)
            if raw is None or not _nonempty(raw):
                # Drop empty entries (datasets without this camera) so the
                # model-side image handler substitutes zeros; a raw b""
                # would otherwise reach batch collation and break stacking.
                sample["observation"].pop(key, None)
                continue
            img = decode_image(raw)
            img = resize_with_pad_np(img, *resize_resolution)
            if key in rotate_keys:
                img = img[::-1, ::-1]  # 180-degree rotation
                applied = True
            sample["observation"][key] = np.ascontiguousarray(img)
        sample["rotation_applied"] = applied
        sample["has_wrist_image"] = _nonempty(sample["observation"].get(wrist_image_key))
        return sample

    return decode
