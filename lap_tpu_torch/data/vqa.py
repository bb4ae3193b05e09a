"""VQA datasets: frames with captions/QA mixed into robot training.

Capability parity with lihzha/lap ``datasets/vqa/``: COCO captions, VQAv2,
LVIS / PACO (bbox grounding), Pixmo captions & points — each emitting frames
shaped like robot samples (is_vqa_sample=True, vqa_dataset_id from the
registry, dummy state/actions) so they interleave with robot datasets in the
mixer and route through the VQA loss weighting.

Copied from ``lap_tpu/data/vqa.py``; its imports point at the port's
copies.
"""

from __future__ import annotations

import dataclasses
import logging
from collections.abc import Iterator

import numpy as np

from lap_tpu_torch.data import bbox as _bbox
from lap_tpu_torch.data.episode_pipeline import decode_image, in_val_split, stable_hash
from lap_tpu_torch.data.registry import VQA_DATASET_ID_MAP
from lap_tpu_torch.utils.image import resize_with_pad_np

logger = logging.getLogger(__name__)


def register_vqa_datasets():
    """Assign stable VQA dataset ids (reference registry auto-assignment)."""
    for name in (
        "coco_captions", "vqa", "lvis", "paco_lvis", "paco_ego4d",
        "pixmo_cap", "pixmo_point",
    ):
        if name not in VQA_DATASET_ID_MAP:
            vqa_id = len(VQA_DATASET_ID_MAP) + 1
            VQA_DATASET_ID_MAP[name] = vqa_id


register_vqa_datasets()


@dataclasses.dataclass
class VQAFrameDataset:
    """Iterable of VQA frames from a TFDS-layout dataset on disk.

    Subclass hooks extract (image_bytes, prompt, caption, objects) from one
    raw example; everything else (val split, resize, dummy robot fields) is
    shared.
    """

    data_dir: str
    name: str
    resize_resolution: tuple[int, int] = (224, 224)
    action_dim: int = 32
    action_horizon: int = 16
    seed: int = 0
    split: str = "train"
    val_fraction: float = 0.0
    direction_prob: float = 0.0
    repeat: bool = True

    def __post_init__(self):
        from lap_tpu_torch.data.rlds import RLDSReader

        self.reader = RLDSReader(self.data_dir, self.name)
        self.vqa_dataset_id = VQA_DATASET_ID_MAP.get(self.name, 0)

    # -- subclass hooks -----------------------------------------------------
    def extract(self, example: dict, rng: np.random.Generator) -> tuple | None:
        """(image, prompt, caption) or None to drop."""
        image = example.get("image")
        caption = _first_text(example.get("caption") or example.get("captions"))
        if image is None or not caption:
            return None
        return image, "Describe this image.", caption

    # -- iteration ----------------------------------------------------------
    def __iter__(self) -> Iterator[dict]:
        epoch = 0
        while True:
            for i, example in enumerate(self.reader.episodes(self.split)):
                traj_id = f"{self.name}_{i}"
                if self.val_fraction and in_val_split(traj_id, self.val_fraction) != (
                    self.split == "val"
                ):
                    continue
                rng = np.random.default_rng(stable_hash(traj_id) + self.seed)
                out = self.extract(example, rng)
                if out is None:
                    continue
                image, prompt, caption = out
                yield self._frame(image, prompt, caption)
            epoch += 1
            if not self.repeat:
                return

    def _frame(self, image, prompt: str, caption: str) -> dict:
        img = decode_image(image if not isinstance(image, list) else image[0])
        img = resize_with_pad_np(img, *self.resize_resolution)
        zero_state = np.zeros(self.action_dim, np.float32)
        return {
            "observation": {
                "base_0_rgb": np.ascontiguousarray(img),
                "left_wrist_0_rgb": np.zeros_like(img),
                "state": zero_state,
            },
            "raw_state": np.zeros(self.action_dim, np.float32),
            "actions": np.zeros((self.action_horizon, self.action_dim), np.float32),
            "prompt": prompt,
            "caption": caption,
            "dataset_name": self.name,
            "is_vqa_sample": True,
            "is_prediction_sample": False,
            "vqa_dataset_id": self.vqa_dataset_id,
            "is_bimanual": False,
            "is_navigation": False,
            "has_wrist_image": False,
            "rotation_applied": False,
        }


def _first_text(value) -> str:
    if value is None:
        return ""
    if isinstance(value, (list, tuple)):
        value = value[0] if value else ""
    if isinstance(value, bytes):
        return value.decode("utf-8", "replace")
    return str(value)


class CocoCaptionDataset(VQAFrameDataset):
    """COCO captions: random caption as the answer."""

    def extract(self, example, rng):
        image = example.get("image")
        caps = example.get("captions", {})
        texts = caps.get("text") if isinstance(caps, dict) else caps
        if image is None or not texts:
            return None
        caption = _first_text(texts if not isinstance(texts, list) else texts[int(rng.integers(len(texts)))])
        return image, "Describe this image.", caption


class VQAv2Dataset(VQAFrameDataset):
    """VQAv2: question -> most-common answer."""

    def extract(self, example, rng):
        image = example.get("image")
        question = _first_text(example.get("question"))
        answers = example.get("answers", {})
        answer = _first_text(answers.get("text") if isinstance(answers, dict) else answers)
        if image is None or not question or not answer:
            return None
        return image, question, answer


class BBoxVQADataset(VQAFrameDataset):
    """LVIS / PACO style grounding: object name -> <loc> tokens (or a
    direction phrase with probability direction_prob)."""

    def extract(self, example, rng):
        image = example.get("image")
        objects = self._objects(example)
        if image is None or not objects:
            return None
        qa = _bbox.make_bbox_qa(objects, rng, direction_prob=self.direction_prob)
        if qa is None:
            return None
        prompt, answer = qa
        return image, prompt, answer

    def _objects(self, example) -> list[dict]:
        objs = example.get("objects", {})
        if not isinstance(objs, dict):
            return []
        bboxes = np.asarray(objs.get("bbox", np.zeros((0, 4))), np.float64).reshape(-1, 4)
        names = objs.get("label", objs.get("name", []))
        out = []
        for i in range(len(bboxes)):
            name = _first_text(names[i] if i < len(names) else "object")
            out.append({"name": name, "bbox": bboxes[i]})
        return out


class PixmoCapDataset(VQAFrameDataset):
    """Pixmo dense captions."""


class PixmoPointDataset(VQAFrameDataset):
    """Pixmo pointing: object name -> center loc tokens."""

    def extract(self, example, rng):
        image = example.get("image")
        points = np.asarray(example.get("points", np.zeros((0, 2))), np.float64).reshape(-1, 2)
        label = _first_text(example.get("label"))
        if image is None or len(points) == 0 or not label:
            return None
        y, x = points[int(rng.integers(len(points)))]
        answer = _bbox.bbox_to_loc_tokens(y, x, y, x)
        return image, f"Point to the {label}.", answer


VQA_DATASET_CLASSES = {
    "coco_captions": CocoCaptionDataset,
    "vqa": VQAv2Dataset,
    "lvis": BBoxVQADataset,
    "paco_lvis": BBoxVQADataset,
    "paco_ego4d": BBoxVQADataset,
    "pixmo_cap": PixmoCapDataset,
    "pixmo_point": PixmoPointDataset,
}


def build_vqa_dataset(name: str, **kwargs) -> VQAFrameDataset:
    cls = VQA_DATASET_CLASSES.get(name, VQAFrameDataset)
    return cls(name=name, **kwargs)
