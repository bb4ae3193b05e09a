"""Bounding-box VQA utilities (numpy).

Capability parity with lihzha/lap ``datasets/vqa/bbox/``: PaLiGemma
``<locNNNN>`` token strings with letterbox (resize-with-pad) coordinate
transforms, 180-degree-rotation remapping, direction captions from bbox
geometry, and prompt/object sampling pools.

Copied from ``lap_tpu/data/bbox.py``; its imports point at the port's
copies.
"""

from __future__ import annotations

import re

import numpy as np

NUM_LOC_BINS = 1024


def bbox_to_loc_tokens(y_min: float, x_min: float, y_max: float, x_max: float,
                       num_bins: int = NUM_LOC_BINS) -> str:
    """Normalized [0,1] bbox -> "<locYMIN><locXMIN><locYMAX><locXMAX>"."""
    def idx(v):
        return int(np.clip(round(v * (num_bins - 1)), 0, num_bins - 1))

    return (
        f"<loc{idx(y_min):04d}><loc{idx(x_min):04d}>"
        f"<loc{idx(y_max):04d}><loc{idx(x_max):04d}>"
    )


_LOC_RE = re.compile(r"<loc(\d{4})>")


def loc_tokens_to_bbox(text: str, num_bins: int = NUM_LOC_BINS) -> np.ndarray | None:
    """Parse the first 4 loc tokens back to normalized [y0, x0, y1, x1]."""
    vals = [int(m) for m in _LOC_RE.findall(text)[:4]]
    if len(vals) < 4:
        return None
    return np.asarray(vals, dtype=np.float64) / (num_bins - 1)


def letterbox_bbox(bbox: np.ndarray, src_h: int, src_w: int, dst: int = 224) -> np.ndarray:
    """Map a normalized bbox through resize-with-pad to the padded frame.

    Integer-floored resized dims + float half-pads: exactly the reference's
    transform_bbox_for_letterbox (coord_utils.py:161-204)."""
    bbox = np.asarray(bbox, dtype=np.float64)  # [y0, x0, y1, x1] normalized
    ratio = max(src_h / dst, src_w / dst)
    rh, rw = int(src_h / ratio), int(src_w / ratio)
    y_off, x_off = (dst - rh) / 2.0, (dst - rw) / 2.0
    ys = (bbox[[0, 2]] * rh + y_off) / dst
    xs = (bbox[[1, 3]] * rw + x_off) / dst
    return np.array([ys[0], xs[0], ys[1], xs[1]])


def rotate_bbox_180(bbox: np.ndarray) -> np.ndarray:
    """Remap a normalized bbox for a 180-degree rotated image."""
    y0, x0, y1, x1 = np.asarray(bbox, dtype=np.float64)
    return np.array([1 - y1, 1 - x1, 1 - y0, 1 - x0])


def rotate_bbox_loc_tokens_180(text: str, num_bins: int = NUM_LOC_BINS) -> str:
    bbox = loc_tokens_to_bbox(text, num_bins)
    if bbox is None:
        return text
    return bbox_to_loc_tokens(*rotate_bbox_180(bbox), num_bins=num_bins)


def direction_caption(bbox: np.ndarray, *, rotated_180: bool = False) -> str:
    """Coarse location phrase from bbox center (reference direction.py)."""
    bbox = np.asarray(bbox, dtype=np.float64)
    if rotated_180:
        bbox = rotate_bbox_180(bbox)
    cy = (bbox[0] + bbox[2]) / 2
    cx = (bbox[1] + bbox[3]) / 2
    vert = "top" if cy < 1 / 3 else ("bottom" if cy > 2 / 3 else "middle")
    horiz = "left" if cx < 1 / 3 else ("right" if cx > 2 / 3 else "center")
    if vert == "middle" and horiz == "center":
        return "in the center"
    if vert == "middle":
        return f"on the {horiz}"
    if horiz == "center":
        return f"at the {vert}"
    return f"at the {vert} {horiz}"


BBOX_PROMPTS = [
    "Where is the {obj} in this image?",
    "Detect the {obj}.",
    "Locate the {obj} in the image.",
    "Find the bounding box of the {obj}.",
    "Point out the {obj}.",
]

DIRECTION_PROMPTS = [
    "Where in the frame is the {obj}?",
    "Which part of the image contains the {obj}?",
    "Describe the location of the {obj}.",
]


def sample_object(objects: list[dict], rng: np.random.Generator) -> dict | None:
    """Pick one annotated object, preferring larger boxes (reference
    sampling.py area weighting)."""
    if not objects:
        return None
    areas = np.array(
        [max((o["bbox"][2] - o["bbox"][0]) * (o["bbox"][3] - o["bbox"][1]), 1e-6) for o in objects]
    )
    probs = areas / areas.sum()
    return objects[int(rng.choice(len(objects), p=probs))]


def make_bbox_qa(
    objects: list[dict],
    rng: np.random.Generator,
    *,
    direction_prob: float = 0.0,
    rotated_180: bool = False,
) -> tuple[str, str] | None:
    """(prompt, answer) for one sampled object; answer is loc tokens or a
    direction phrase with probability ``direction_prob``."""
    obj = sample_object(objects, rng)
    if obj is None:
        return None
    name = obj.get("name", "object")
    bbox = np.asarray(obj["bbox"], dtype=np.float64)
    if rotated_180:
        bbox = rotate_bbox_180(bbox)
    if direction_prob > 0 and rng.random() < direction_prob:
        prompt = str(rng.choice(DIRECTION_PROMPTS)).format(obj=name)
        return prompt, direction_caption(bbox)
    prompt = str(rng.choice(BBOX_PROMPTS)).format(obj=name)
    return prompt, bbox_to_loc_tokens(*bbox)
