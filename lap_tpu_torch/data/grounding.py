"""Robot-frame grounding QA: frame-objects tables from bbox annotations.

Capability parity with lihzha/lap ``datasets/vqa/bbox/table_builder.py`` and
``key_extractors.py``: JSONL annotation files (one episode per line, labels
per frame) become an in-memory lookup ``{episode_key--frame_idx: [objects]}``
used to attach grounding QA (loc-token or direction answers) to robot frames
during pipeline iteration. Pure Python/numpy — no tf.lookup tables; the dict
lives on the host and is shared by the loader threads.

Copied from ``lap_tpu/data/grounding.py``; its imports point at the port's
copies.
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path

import numpy as np

from lap_tpu_torch.data.bbox import bbox_to_loc_tokens

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Key extractors (reference key_extractors.py:10-76)
# ---------------------------------------------------------------------------


def droid_key_extractor(episode_data: dict) -> str | None:
    """DROID: relative episode path from episode_metadata.file_path."""
    file_path = episode_data.get("episode_metadata", {}).get("file_path", "")
    if isinstance(file_path, (list, tuple)):
        file_path = file_path[0] if file_path else ""
    if isinstance(file_path, bytes):
        file_path = file_path.decode("utf-8", "replace")
    if not file_path:
        return None
    rel = re.sub(r"^.*r2d2-data(?:-full)?/", "", str(file_path))
    episode_path = re.sub(r"/trajectory.*$", "", rel)
    return episode_path or None


def oxe_key_extractor(episode_data: dict) -> str | None:
    """OXE: episode_metadata.file_path verbatim (episode ids are not unique
    across combined datasets)."""
    file_path = episode_data.get("episode_metadata", {}).get("file_path")
    if isinstance(file_path, (list, tuple)):
        file_path = file_path[0] if file_path else None
    if isinstance(file_path, bytes):
        file_path = file_path.decode("utf-8", "replace")
    return str(file_path) if file_path else None


def bridge_key_extractor(episode_data: dict) -> str | None:
    """Bridge: "{file_path}::{episode_id}" (one file holds many episodes)."""
    meta = episode_data.get("episode_metadata", {})
    file_path = meta.get("file_path")
    episode_id = meta.get("episode_id")

    def scalar(v):
        if isinstance(v, (list, tuple)):
            v = v[0] if v else None
        if isinstance(v, bytes):
            v = v.decode("utf-8", "replace")
        if isinstance(v, np.ndarray):
            v = v.reshape(-1)[0] if v.size else None
        return v

    file_path, episode_id = scalar(file_path), scalar(episode_id)
    if file_path is not None and episode_id is not None:
        return f"{file_path}::{episode_id}"
    return None


KEY_EXTRACTORS = {
    "droid": droid_key_extractor,
    "bridge": bridge_key_extractor,
    "oxe": oxe_key_extractor,
}


def key_extractor_for(dataset_name: str):
    if "droid" in dataset_name:
        return droid_key_extractor
    if "bridge" in dataset_name:
        return bridge_key_extractor
    return oxe_key_extractor


# ---------------------------------------------------------------------------
# Direction semantics (reference direction.py:10-105)
# ---------------------------------------------------------------------------


def compute_direction_from_bbox(
    x_min: float, y_min: float, x_max: float, y_max: float,
    *, slope: float = 2.0, add_move_prefix: bool = False,
) -> str:
    """Direction of the bbox center relative to image center.

    Cone boundaries use slopes ``slope`` / ``1/slope``: steep centers map to
    forward/back, flat ones to left/right, the rest to compounds like
    "left and forward".
    """
    cx = (x_min + x_max) / 2.0
    cy = (y_min + y_max) / 2.0
    x_rel = cx - 0.5  # +x is right
    y_rel = 0.5 - cy  # +y is up / forward
    k, inv_k = slope, 1.0 / slope
    if y_rel > k * abs(x_rel):
        direction = "forward"
    elif y_rel < -k * abs(x_rel):
        direction = "back"
    elif x_rel > inv_k * abs(y_rel):
        direction = "right"
    elif x_rel < -inv_k * abs(y_rel):
        direction = "left"
    else:
        base = "left" if x_rel < 0 else "right"
        vert = "forward" if y_rel >= 0 else "back"
        direction = f"{base} and {vert}"
    return f"move {direction}" if add_move_prefix else direction


_DIR_FLIP = {"forward": "back", "back": "forward", "left": "right", "right": "left"}


def rotate_direction_180(direction: str) -> str:
    """Flip a direction phrase for a 180-degree rotated frame."""
    prefix = ""
    if direction.startswith("move "):
        prefix, direction = "move ", direction[len("move "):]
    parts = [_DIR_FLIP.get(p, p) for p in direction.split(" and ")]
    return prefix + " and ".join(parts)


# ---------------------------------------------------------------------------
# Letterbox transform (reference coord_utils.py:161-203, x/y order)
# ---------------------------------------------------------------------------


def transform_bbox_for_letterbox(
    x_min, y_min, x_max, y_max, orig_w, orig_h, target_w, target_h
):
    ratio = max(orig_w / target_w, orig_h / target_h)
    resized_w = int(orig_w / ratio)
    resized_h = int(orig_h / ratio)
    pad_w = (target_w - resized_w) / 2.0
    pad_h = (target_h - resized_h) / 2.0
    out = (
        x_min * (resized_w / target_w) + pad_w / target_w,
        y_min * (resized_h / target_h) + pad_h / target_h,
        x_max * (resized_w / target_w) + pad_w / target_w,
        y_max * (resized_h / target_h) + pad_h / target_h,
    )
    return tuple(max(0.0, min(1.0, v)) for v in out)


# ---------------------------------------------------------------------------
# Table builders (reference table_builder.py:22-606)
# ---------------------------------------------------------------------------


def build_frame_objects_table(
    bbox_annotations_dir: str | Path,
    key_extractor,
    *,
    dataset_name: str = "",
    orig_size: tuple[int, int] = (256, 256),
    target_size: tuple[int, int] = (224, 224),
    target_only: bool = False,
    direction_slope: float = 2.0,
) -> dict[str, list[dict]]:
    """``{episode_key--frame_idx: [{label, loc_tokens, direction}, ...]}``.

    JSONL layout per line: {"episode_metadata": {...}, "labels": [{"frame": i,
    "all_objects": [{"label", "bbox" [ymin,xmin,ymax,xmax in 0..1000],
    "is_target"}]}]}. Bboxes are letterbox-pretransformed so loc tokens match
    the resize-with-pad frames the model sees.
    """
    orig_w, orig_h = orig_size
    target_w, target_h = target_size
    table: dict[str, list[dict]] = {}
    counts = {"total": 0, "bad_bbox": 0, "no_label": 0, "non_target": 0}

    files = sorted(Path(bbox_annotations_dir).glob("*.jsonl"))
    for path in files:
        if "merged" in path.name:
            continue
        for line in path.read_text().splitlines():
            if not line.strip():
                continue
            try:
                episode_data = json.loads(line)
            except json.JSONDecodeError:
                continue
            episode_key = key_extractor(episode_data)
            if not episode_key:
                continue
            for entry in episode_data.get("labels", []):
                frame_idx = entry.get("frame")
                all_objects = entry.get("all_objects", [])
                if frame_idx is None or not all_objects:
                    continue
                objs = []
                for obj in all_objects:
                    counts["total"] += 1
                    label = obj.get("label", "")
                    bbox = obj.get("bbox", [])
                    if not label:
                        counts["no_label"] += 1
                        continue
                    if len(bbox) != 4:
                        counts["bad_bbox"] += 1
                        continue
                    if target_only and not obj.get("is_target", False):
                        counts["non_target"] += 1
                        continue
                    # Raw bbox is [y_min, x_min, y_max, x_max] in 0..1000.
                    y0, x0, y1, x1 = (max(0.0, min(1.0, float(v) / 1000.0)) for v in bbox)
                    x0, y0, x1, y1 = transform_bbox_for_letterbox(
                        x0, y0, x1, y1, orig_w, orig_h, target_w, target_h
                    )
                    objs.append(
                        {
                            "label": str(label),
                            "bbox": (x0, y0, x1, y1),
                            "loc_tokens": bbox_to_loc_tokens(y0, x0, y1, x1),
                            "direction": compute_direction_from_bbox(
                                x0, y0, x1, y1,
                                slope=direction_slope, add_move_prefix=True,
                            ),
                        }
                    )
                if objs:
                    table.setdefault(f"{episode_key}--{frame_idx}", []).extend(objs)
    logger.info(
        "frame-objects table%s: %d keys from %d files (%d bboxes, %d dropped)",
        f" for {dataset_name}" if dataset_name else "", len(table), len(files),
        counts["total"], counts["bad_bbox"] + counts["no_label"] + counts["non_target"],
    )
    return table


def build_annotated_keys_set(table: dict[str, list]) -> set[str]:
    """Episode keys that have at least one annotated frame."""
    return {k.rsplit("--", 1)[0] for k in table}


# ---------------------------------------------------------------------------
# QA formatting (reference prompts.py + sampling.py)
# ---------------------------------------------------------------------------

ROBOT_BBOX_PROMPTS_P1 = ("Pick up the ", "Grasp the ", "Move near to the ", "Navigate to the ")
ROBOT_BBOX_PROMPTS_P2 = (
    ", predict where it is in the image.",
    ", show where it is in the image.",
    ", locate it in the image.",
)
ROBOT_DIRECTION_PROMPTS = (
    "Which direction should the robot move its gripper to reach the {obj}?",
    "To approach the {obj}, which way should the end-effector move?",
    "What direction brings the gripper toward the {obj}?",
)


def make_grounding_qa(
    objects: list[dict],
    rng: np.random.Generator,
    *,
    max_objects: int = 2,
    direction_prob: float = 0.0,
    rotated_180: bool = False,
) -> tuple[str, str] | None:
    """(prompt, caption) for a robot frame's annotated objects.

    With probability ``direction_prob`` answers a single object's movement
    direction; otherwise answers loc tokens for up to ``max_objects`` objects
    ("<loc..> label ; <loc..> label").
    """
    if not objects:
        return None
    if direction_prob > 0 and rng.random() < direction_prob:
        obj = objects[int(rng.integers(len(objects)))]
        direction = obj["direction"]
        if rotated_180:
            direction = rotate_direction_180(direction)
        prompt = str(rng.choice(ROBOT_DIRECTION_PROMPTS)).format(obj=obj["label"])
        return prompt, direction
    picks = list(objects)
    if len(picks) > max_objects:
        idx = rng.choice(len(picks), size=max_objects, replace=False)
        picks = [picks[i] for i in idx]
    labels = list(dict.fromkeys(o["label"] for o in picks))
    p1 = str(rng.choice(ROBOT_BBOX_PROMPTS_P1))
    p2 = str(rng.choice(ROBOT_BBOX_PROMPTS_P2))
    prompt = p1 + ", ".join(labels) + p2
    if rotated_180:
        from lap_tpu_torch.data.bbox import rotate_bbox_loc_tokens_180

        caption = " ; ".join(
            f"{rotate_bbox_loc_tokens_180(o['loc_tokens'])} {o['label']}" for o in picks
        )
    else:
        caption = " ; ".join(f"{o['loc_tokens']} {o['label']}" for o in picks)
    return prompt, caption
