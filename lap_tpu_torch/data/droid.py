"""DROID-specific dataset machinery.

Capability parity with lihzha/lap ``datasets/robot/droid_dataset.py`` +
``droid_mixins.py``: the same on-disk metadata files the reference
consumes, the same lookup-key construction, and the same trajectory /
frame filters, re-done as plain-Python tables instead of TF
``StaticHashTable``s.

Metadata files (reference ``droid_mixins.py:91-183`` / ``specs.py:11-25``):
    episode_id_to_path.json          {episode_id: episode_path}  (inverted
                                     to path->id at load, mixins :102)
    droid_language_annotations.json  {episode_id: {"language_instruction1":
                                     str, ..2, ..3}} — used ONLY as the
                                     has-instruction trajectory filter
                                     (droid_dataset.py:221-229)
    keep_ranges_1_0_1.json           {f"{recording_folderpath}--{file_path}":
                                     [[start, end], ...]} — per-step keep
                                     filter, default DROP (mixins :113-143)

The metadata directory is resolved like the reference
(``droid_mixins.py:78-89``): ``rlds_data_dir`` with ``OXE`` replaced by
``metadata``; a ``{data_dir}/droid_metadata`` sibling is accepted as a
fallback for self-contained layouts. All files optional — an absent file
degrades to permissive behavior so fabricated test data flows through.

Copied from ``lap_tpu/data/droid.py``; its imports point at the port's
copies.
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path

import numpy as np

from lap_tpu_torch.data.episode_pipeline import traj_rng
from lap_tpu_torch.data.transforms_oxe import droid_dataset_transform

logger = logging.getLogger(__name__)

EXTERIOR_CAMERAS = ("exterior_image_1_left", "exterior_image_2_left")
INSTRUCTION_KEYS = (
    "language_instruction",
    "language_instruction_2",
    "language_instruction_3",
)


def extract_episode_path_from_file_path(file_path: str) -> str:
    """Strip everything up to ``r2d2-data/`` or ``r2d2-data-full/`` and trim
    the ``/trajectory...`` suffix (reference ``helpers.py:61-80``)."""
    rel = re.sub(r"^.*r2d2-data(?:-full)?/", "", file_path)
    return re.sub(r"/trajectory.*$", "", rel)


def _decode(value) -> str | None:
    if isinstance(value, (list, np.ndarray)):
        value = value[0] if len(value) else None
    if isinstance(value, bytes):
        value = value.decode()
    return None if value is None else str(value)


class DroidMetadata:
    def __init__(self, data_dir: str | Path):
        candidates = [
            Path(str(data_dir).replace("OXE", "metadata")),
            Path(data_dir) / "droid_metadata",
        ]
        base = next((c for c in candidates if c.is_dir() and c != Path(data_dir)), None)

        def load(name, default):
            if base is None:
                return default
            path = base / name
            if path.exists():
                return json.loads(path.read_text())
            return default

        # {episode_id: episode_path} inverted to path->id (mixins :100-109).
        episode_id_to_path = load("episode_id_to_path.json", None)
        self.has_id_map = episode_id_to_path is not None
        self.path_to_id = {v: k for k, v in (episode_id_to_path or {}).items()}

        # {episode_id: {"language_instruction1": ...}} -> non-empty lists.
        annotations = load("droid_language_annotations.json", None)
        self.annotations: dict[str, list[str]] | None = None
        if annotations is not None:
            self.annotations = {
                eid: [
                    s
                    for s in (
                        v.get("language_instruction1", ""),
                        v.get("language_instruction2", ""),
                        v.get("language_instruction3", ""),
                    )
                    if len(s) > 0
                ]
                for eid, v in annotations.items()
            }

        # {f"{recording_folderpath}--{file_path}": [[start, end], ...]}.
        self.keep_ranges: dict[str, list] | None = load("keep_ranges_1_0_1.json", None)
        self.enabled = base is not None

    def episode_id(self, episode: dict) -> str:
        """Extracted-episode-path lookup; '' when unknown (the reference's
        ``default_ep_value``, specs.py:25)."""
        meta = episode.get("episode_metadata", {})
        path = _decode(meta.get("file_path"))
        if path is None:
            return ""
        return self.path_to_id.get(extract_episode_path_from_file_path(path), "")

    def has_instruction(self, episode_id: str) -> bool:
        """The reference requires a non-empty serialized annotation tensor
        (>10 bytes — i.e. at least one non-empty instruction,
        droid_dataset.py:221-226). Permissive when no annotation file."""
        if self.annotations is None:
            return True
        if not self.has_id_map:
            # Annotations are keyed by episode id; without the id map every
            # lookup would miss and silently drop ALL trajectories. Degrade
            # to permissive (module contract: absent files are permissive).
            if not getattr(self, "_warned_no_id_map", False):
                self._warned_no_id_map = True
                logger.warning(
                    "droid_language_annotations.json is present but "
                    "episode_id_to_path.json is missing; the has-instruction "
                    "filter cannot be keyed and is DISABLED."
                )
            return True
        return bool(self.annotations.get(episode_id))

    def frame_keep_mask(self, episode: dict, traj_len: int) -> np.ndarray | None:
        """Per-step keep mask keyed ``{recording_folderpath}--{file_path}``
        (droid_dataset.py:132-141); absent episodes drop ALL frames (the
        table's default is False, mixins :136-139)."""
        if self.keep_ranges is None:
            return None
        meta = episode.get("episode_metadata", {})
        folder = _decode(meta.get("recording_folderpath"))
        path = _decode(meta.get("file_path"))
        keep = np.zeros(traj_len, bool)
        if folder is None or path is None:
            return keep
        for start, end in self.keep_ranges.get(f"{folder}--{path}", []):
            keep[int(start) : int(end)] = True
        return keep


def make_droid_standardize_fn(data_dir: str | Path, *, seed: int = 0, success_only: bool = True):
    """Wrap the base DROID transform with metadata-driven filtering/sampling."""
    metadata = DroidMetadata(data_dir)

    def standardize(episode: dict):
        traj = droid_dataset_transform(episode)
        if traj is None:
            return None
        meta = episode.get("episode_metadata", {})
        file_path = _decode(meta.get("file_path"))

        # Success filter: full-match ".*success.*" on the raw file path
        # (reference droid_dataset.py:216-218, 228).
        if success_only and file_path is not None and "success" not in file_path:
            return None

        ep_id = metadata.episode_id(episode)
        # Has-instruction filter via the annotation table (ref :221-229).
        if metadata.enabled and not metadata.has_instruction(ep_id):
            return None

        t = len(traj["action"])
        rng = traj_rng(seed, ep_id or (file_path or str(t)))

        # Random pick among the trajectory's OWN three instruction fields
        # (reference shuffles the three per-step tensors and takes one,
        # droid_dataset.py:113-120 — the annotation file is never a source).
        steps = episode.get("steps", episode)
        variants = []
        for key in INSTRUCTION_KEYS:
            vals = steps.get(key)
            if vals is None:
                continue
            variants.append([v.decode() if isinstance(v, bytes) else str(v) for v in vals])
        if variants:
            traj["language_instruction"] = list(variants[int(rng.integers(len(variants)))])

        # Random exterior camera of two (ref :122-130).
        obs = steps.get("observation", {})
        cams = [c for c in EXTERIOR_CAMERAS if c in obs]
        if len(cams) > 1:
            traj["observation"]["base_0_rgb"] = list(obs[cams[int(rng.integers(len(cams)))]])

        # Per-step keep ranges -> frame mask consumed by the pipeline.
        keep = metadata.frame_keep_mask(episode, t)
        if keep is not None:
            traj["frame_keep_mask"] = keep
        return traj

    return standardize


def droid_frame_filter(frame: dict) -> bool:
    """Drop frames outside the keep ranges (applied post-flatten)."""
    mask = frame.pop("frame_keep_mask", None)
    return bool(mask) if mask is not None else True
