"""RLDS/TFDS on-disk reader, pure Python.

Reads TFDS-materialized RLDS datasets (directory with ``dataset_info.json``
+ ``features.json`` + TFRecord shards of flattened Example protos) and
reconstructs per-episode dicts of numpy arrays, replacing the reference's
``tfds.builder`` + ``dlimp.DLataset.from_rlds`` stack (mixins.py:195-235).

TFDS flattens nested features into '/'-joined keys; Sequence features store
all steps' values concatenated in one Example. Shapes/dtypes come from
``features.json``.

Copied from ``lap_tpu/data/rlds.py``; its imports point at the port's
copies.
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path

import numpy as np

from lap_tpu_torch.data import tfrecord

logger = logging.getLogger(__name__)


def _walk_features(node: dict, prefix: str = "") -> dict:
    """features.json -> {flat_key: (shape, dtype, kind)}."""
    out = {}
    content = node.get("content", node)
    ftype = node.get("pythonClassName", "")
    if "FeaturesDict" in ftype or "features" in content:
        feats = content.get("features", content)
        for name, sub in feats.items():
            key = f"{prefix}/{name}" if prefix else name
            out.update(_walk_features(sub, key))
        return out
    if "Sequence" in ftype:
        inner = content.get("feature", {})
        sub = _walk_features(inner, prefix)
        return {k: (shape, dtype, "sequence_" + kind) for k, (shape, dtype, kind) in sub.items()}
    if "Image" in ftype:
        shape = tuple(int(d or -1) for d in content.get("shape", {}).get("dimensions", []))
        return {prefix: (shape, "uint8", "image")}
    if "Tensor" in ftype or "Scalar" in ftype or "dtype" in content:
        dims = content.get("shape", {}).get("dimensions", [])
        shape = tuple(int(d or -1) for d in dims)
        dtype = content.get("dtype", "float32")
        return {prefix: (shape, dtype, "tensor")}
    if "Text" in ftype:
        return {prefix: ((), "object", "text")}
    # Unknown wrapper: descend if possible.
    if isinstance(content, dict) and "feature" in content:
        return _walk_features(content["feature"], prefix)
    return {prefix: ((), "float32", "tensor")}


_DTYPE_MAP = {
    "float32": np.float32, "float64": np.float64, "float16": np.float16,
    "int32": np.int64, "int64": np.int64, "uint8": np.uint8, "bool": np.bool_,
    "string": object, "object": object,
}


class RLDSReader:
    """Iterates episodes of one TFDS-materialized RLDS dataset."""

    def __init__(self, data_dir: str | Path, name: str, version: str | None = None):
        base = Path(data_dir) / name
        if version is None:
            versions = sorted(
                (d.name for d in base.iterdir() if re.fullmatch(r"[\d.]+", d.name)),
                key=lambda s: [int(x) for x in s.split(".")],
            )
            if not versions:
                raise FileNotFoundError(f"no dataset versions under {base}")
            version = versions[-1]
        self.path = base / version
        self.name = name
        features = json.loads((self.path / "features.json").read_text())
        self.spec = _walk_features(features)
        info = json.loads((self.path / "dataset_info.json").read_text())
        self.splits = {
            s["name"]: s for s in info.get("splits", [{"name": "train"}])
        }

    def shard_files(self, split: str = "train") -> list[Path]:
        files = sorted(self.path.glob(f"*-{split}.tfrecord-*"))
        if not files:
            files = sorted(self.path.glob(f"{split}.tfrecord*"))
        return files

    def num_episodes(self, split: str = "train") -> int | None:
        info = self.splits.get(split)
        if info and "shardLengths" in info:
            return sum(int(x) for x in info["shardLengths"])
        return None

    def _decode_episode(self, raw: bytes) -> dict:
        flat = tfrecord.parse_example(raw)
        episode: dict = {}
        # Determine the step count from any sequence tensor.
        steps_len = None
        for key, value in flat.items():
            shape, dtype, kind = self.spec.get(key, ((), "float32", "tensor"))
            if kind.startswith("sequence_") and kind != "sequence_image" and kind != "sequence_text":
                per_step = int(np.prod([d for d in shape if d > 0])) or 1
                if value is not None and len(value) and per_step:
                    steps_len = len(np.asarray(value).flatten()) // per_step
                    break
        for key, value in flat.items():
            shape, dtype, kind = self.spec.get(key, ((), "float32", "tensor"))
            if value is None:
                continue
            if kind in ("image", "sequence_image") or (
                isinstance(value, list) and value and isinstance(value[0], bytes) and kind.endswith("text") is False and dtype == "uint8"
            ):
                episode[key] = list(value)  # encoded image bytes per step
            elif kind.endswith("text") or dtype in ("string", "object"):
                episode[key] = [v.decode("utf-8", "replace") if isinstance(v, bytes) else v for v in (value if isinstance(value, list) else [value])]
            else:
                arr = np.asarray(value)
                np_dtype = _DTYPE_MAP.get(dtype, np.float32)
                arr = arr.astype(np_dtype)
                inner = tuple(d for d in shape if d > 0)
                if kind.startswith("sequence_"):
                    t = steps_len if steps_len else (len(arr.flatten()) // max(int(np.prod(inner)) if inner else 1, 1))
                    arr = arr.reshape(t, *inner) if inner else arr.reshape(t)
                elif inner:
                    arr = arr.reshape(inner)
                episode[key] = arr
        return unflatten_episode(episode)

    def episodes(self, split: str = "train", *, shard_index: int = 0, num_shards: int = 1):
        files = self.shard_files(split)
        if num_shards > len(files):
            # Fewer TFRecord shards than data-parallel processes: sharding at
            # the file level would leave some processes with ZERO episodes
            # (hanging their producer threads). Fall back to episode-level
            # round-robin so every process sees a disjoint, non-empty slice.
            ep_i = 0
            for path in files:
                for raw in tfrecord.read_tfrecords(path):
                    if ep_i % num_shards == shard_index:
                        yield self._decode_episode(raw)
                    ep_i += 1
            return
        for i, path in enumerate(files):
            if i % num_shards != shard_index:
                continue
            for raw in tfrecord.read_tfrecords(path):
                yield self._decode_episode(raw)


def unflatten_episode(flat: dict) -> dict:
    out: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


# ---------------------------------------------------------------------------
# Writer (tests + dataset fabrication)
# ---------------------------------------------------------------------------


def write_rlds_dataset(
    data_dir: str | Path,
    name: str,
    episodes: list[dict],
    *,
    version: str = "1.0.0",
    split: str = "train",
) -> Path:
    """Materialize episodes as a TFDS-layout RLDS dataset our reader loads.

    Episode format: nested dict; step-level arrays under ``steps/...`` with
    leading T dim; image fields as list-of-encoded-bytes; text as list[str].
    """
    path = Path(data_dir) / name / version
    path.mkdir(parents=True, exist_ok=True)

    def flatten(node, prefix=""):
        out = {}
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out.update(flatten(v, key))
            else:
                out[key] = v
        return out

    flat_eps = [flatten(ep) for ep in episodes]
    spec = {}
    for key, v in flat_eps[0].items():
        if isinstance(v, list) and v and isinstance(v[0], bytes):
            spec[key] = {"pythonClassName": "tensorflow_datasets.core.features.sequence_feature.Sequence",
                         "content": {"feature": {"pythonClassName": "tensorflow_datasets.core.features.image_feature.Image",
                                                 "content": {"shape": {"dimensions": []}}}}}
        elif isinstance(v, list) and v and isinstance(v[0], str):
            spec[key] = {"pythonClassName": "tensorflow_datasets.core.features.sequence_feature.Sequence",
                         "content": {"feature": {"pythonClassName": "tensorflow_datasets.core.features.text_feature.Text",
                                                 "content": {}}}}
        else:
            arr = np.asarray(v)
            spec[key] = {"pythonClassName": "tensorflow_datasets.core.features.sequence_feature.Sequence",
                         "content": {"feature": {"pythonClassName": "tensorflow_datasets.core.features.tensor_feature.Tensor",
                                                 "content": {"shape": {"dimensions": [str(d) for d in arr.shape[1:]]},
                                                             "dtype": str(arr.dtype)}}}}

    def nest_spec(flat_spec):
        root: dict = {"pythonClassName": "tensorflow_datasets.core.features.features_dict.FeaturesDict",
                      "content": {"features": {}}}
        for key, s in flat_spec.items():
            parts = key.split("/")
            node = root
            for p in parts[:-1]:
                feats = node["content"]["features"]
                if p not in feats:
                    feats[p] = {"pythonClassName": "tensorflow_datasets.core.features.features_dict.FeaturesDict",
                                "content": {"features": {}}}
                node = feats[p]
            node["content"]["features"][parts[-1]] = s
        return root

    (path / "features.json").write_text(json.dumps(nest_spec(spec)))

    records = []
    for ep in flat_eps:
        feats = {}
        for key, v in ep.items():
            if isinstance(v, list) and v and isinstance(v[0], bytes):
                feats[key] = v
            elif isinstance(v, list) and v and isinstance(v[0], str):
                feats[key] = [s.encode() for s in v]
            else:
                arr = np.asarray(v)
                feats[key] = arr.flatten() if arr.dtype.kind in "iub" else arr.astype(np.float32).flatten()
        records.append(tfrecord.build_example(feats))
    shard = path / f"{name}-{split}.tfrecord-00000-of-00001"
    tfrecord.write_tfrecords(shard, records)
    (path / "dataset_info.json").write_text(
        json.dumps({"splits": [{"name": split, "shardLengths": [str(len(records))]}]})
    )
    return path
