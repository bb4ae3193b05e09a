"""Multi-dataset weighted mixture (the OXEDatasets equivalent).

Parity with lihzha/lap ``datasets/dataset_mixer.py``: build every dataset in
a named mixture, compute (and cache) normalization statistics BEFORE
interleaving, normalize per dataset, then sample frames from the datasets
with the mixture weights (optionally balanced by dataset size).

Copied from ``lap_tpu/data/mixer.py``; its imports point at the port's
copies. ``jax.process_index()``/``process_count()`` become
``device.process_placement()`` (this rank's index and count over the data
ranks), and the stats pass's cross-host merge (``mixer.py:240-254``) pools
the data ranks' moments through ``array_utils.gather_host_json``.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

from lap_tpu_torch.data import norm_stats as _norm_stats
from lap_tpu_torch.data.episode_pipeline import EpisodePipeline, PipelineConfig
from lap_tpu_torch.data.mixtures import get_mixture
from lap_tpu_torch.data.registry import get_dataset_config
from lap_tpu_torch.data.rlds import RLDSReader
from lap_tpu_torch.device import process_placement

# Importing registers all standardization transforms.
from lap_tpu_torch.data import transforms_oxe  # noqa: F401

logger = logging.getLogger(__name__)


class RLDSFrameDataset:
    """Iterable of frames for one RLDS dataset: episodes (shuffled shards)
    -> pipeline -> shuffle buffer."""

    def __init__(
        self,
        reader: RLDSReader,
        pipeline: EpisodePipeline,
        *,
        split: str = "train",
        shuffle_buffer_size: int = 10_000,
        seed: int = 0,
        repeat: bool = True,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.reader = reader
        self.pipeline = pipeline
        self.split = split
        self.shuffle_buffer_size = shuffle_buffer_size
        self.seed = seed
        self.repeat = repeat
        self.process_index = process_index
        self.process_count = process_count

    def episodes(self):
        self._epoch = 0
        while True:
            n_yielded = 0
            for episode in self.reader.episodes(
                self.split,
                shard_index=self.process_index,
                num_shards=self.process_count,
            ):
                n_yielded += 1
                yield episode
            if n_yielded == 0:
                # A silent empty pass + repeat=True would busy-loop forever,
                # hanging the producer thread (and a multi-host run) with no
                # error. Surface the misconfiguration instead.
                raise RuntimeError(
                    f"RLDS dataset {self.reader.name!r} yielded 0 episodes for "
                    f"split={self.split!r} shard {self.process_index}/"
                    f"{self.process_count}; check rlds_data_dir / shard files"
                )
            self._epoch += 1
            if not self.repeat:
                return

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        buffer: list = []
        target = self.shuffle_buffer_size
        for episode in self.episodes():
            if getattr(self, "_epoch", 0) >= 1 and 0 < len(buffer) < target:
                # The whole (sharded) dataset fits in the buffer: one full
                # epoch is already resident, so waiting for more fill would
                # only append repeats. Cap the target and start yielding.
                target = len(buffer)
            for frame in self.pipeline.process_episode(episode):
                if target <= 1:
                    yield frame
                    continue
                buffer.append(frame)
                if len(buffer) >= target:
                    idx = rng.integers(0, len(buffer))
                    buffer[idx], buffer[-1] = buffer[-1], buffer[idx]
                    yield buffer.pop()
        while buffer:
            idx = rng.integers(0, len(buffer))
            buffer[idx], buffer[-1] = buffer[-1], buffer[idx]
            yield buffer.pop()


class WeightedMixture:
    """Sample frames from member datasets proportionally to weights."""

    def __init__(self, datasets: list, weights: list[float], seed: int = 0):
        self.datasets = datasets
        w = np.asarray(weights, dtype=np.float64)
        self.probs = w / w.sum()
        self.seed = seed

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        iters = [iter(d) for d in self.datasets]
        alive = list(range(len(iters)))
        while alive:
            probs = self.probs[alive] / self.probs[alive].sum()
            pick = int(rng.choice(alive, p=probs))
            try:
                yield next(iters[pick])
            except StopIteration:
                alive.remove(pick)


def _pipeline_for(train_config, ds_cfg, *, split: str) -> EpisodePipeline:
    data_cfg = train_config.data
    model_cfg = train_config.model
    pc = PipelineConfig(
        action_horizon=model_cfg.action_horizon,
        action_dim=model_cfg.action_dim,
        state_dim=model_cfg.action_dim,
        action_encoding=data_cfg.action_encoding,
        state_encoding=data_cfg.state_encoding,
        horizon_seconds=tuple(data_cfg.horizon_seconds),
        control_frequency=ds_cfg.control_frequency,
        seed=train_config.seed,
        val_fraction=data_cfg.val_fraction or 0.0,
        split=split,
        enable_prediction_training=model_cfg.enable_prediction_training,
        pred_prob=data_cfg.pred_prob,
        primary_pred_prob=data_cfg.primary_pred_prob,
        resize_resolution=data_cfg.resize_resolution,
        needs_wrist_rotation=ds_cfg.needs_wrist_rotation,
        not_rotate_wrist_prob=data_cfg.not_rotate_wrist_prob,
    )
    standardize_fn = ds_cfg.standardize_fn
    frame_filter = None
    if "droid" in ds_cfg.name:
        from lap_tpu_torch.data.droid import droid_frame_filter, make_droid_standardize_fn

        standardize_fn = make_droid_standardize_fn(
            data_cfg.rlds_data_dir, seed=train_config.seed
        )
        frame_filter = droid_frame_filter
    grounding_table = grounding_key_fn = None
    if getattr(data_cfg, "bbox_annotations_dir", None):
        from lap_tpu_torch.data import grounding

        ann_dir = Path(data_cfg.bbox_annotations_dir) / ds_cfg.name
        if ann_dir.is_dir():
            grounding_key_fn = grounding.key_extractor_for(ds_cfg.name)
            grounding_table = grounding.build_frame_objects_table(
                ann_dir,
                grounding_key_fn,
                dataset_name=ds_cfg.name,
                target_size=tuple(data_cfg.resize_resolution),
            )
    return EpisodePipeline(
        pc,
        standardize_fn=standardize_fn,
        frame_filter=frame_filter,
        dataset_name=ds_cfg.name,
        is_bimanual=ds_cfg.is_bimanual,
        is_navigation=ds_cfg.is_navigation,
        grounding_table=grounding_table,
        grounding_key_fn=grounding_key_fn,
        grounding_prob=getattr(data_cfg, "grounding_prob", 0.3),
        grounding_direction_prob=data_cfg.direction_prob,
    )


def _stats_cache_path(train_config, mixture_name: str) -> Path:
    return Path(train_config.data.rlds_data_dir) / "norm_stats_cache" / f"{mixture_name}.json"


def compute_mixture_norm_stats(train_config, members, *, max_episodes_per_dataset=None):
    """Global stats over all ROBOT datasets in the mix, matching the
    reference's grouping semantics (statistics.py:17-228):

    - one FULL pass per dataset (``max_episodes_per_dataset`` optionally
      caps it, reference default is uncapped), episodes sharded across
      processes with a cross-host merge (normalize_adapter.py:139-150);
    - per-dataset stats merged transition-weighted into global 'actions';
    - 'state' grouped by the dataset's state type (eef vs joint), with the
      eef group doubling as the model-facing 'state' entry.

    Returns ``(global_stats, per_dataset_transitions)`` — the latter feeds
    frame-count balance weights (reference dataset_mixer.py:149-155).
    """
    from lap_tpu_torch.data.vqa import VQA_DATASET_CLASSES

    process_index, process_count = process_placement()

    max_eps = (
        max_episodes_per_dataset
        if max_episodes_per_dataset is not None
        else getattr(train_config.data, "norm_stats_max_episodes", None)
    )
    per_dataset: dict[str, dict] = {}
    for name, _weight in members:
        if name in VQA_DATASET_CLASSES:
            continue
        ds_cfg = get_dataset_config(name)
        reader = RLDSReader(train_config.data.rlds_data_dir, name, ds_cfg.tfds_version)
        pipe = _pipeline_for(train_config, ds_cfg, split="train")
        trackers: dict[str, _norm_stats.RunningStats] = {}
        count = 0
        for episode in reader.episodes(
            "train", shard_index=process_index, num_shards=process_count
        ):
            traj = ds_cfg.standardize_fn(episode) if ds_cfg.standardize_fn else episode
            if traj is None:
                continue
            traj = pipe._state_to_rot6d(traj)
            traj = pipe._chunk_actions(traj)
            traj = pipe._pad_dims(traj)
            for key, arr in (
                ("state", traj["observation"]["state"]),
                ("actions", traj["actions"].reshape(-1, traj["actions"].shape[-1])),
            ):
                arr = np.asarray(arr, dtype=np.float64)
                if key not in trackers:
                    trackers[key] = _norm_stats.RunningStats(arr.shape[-1])
                trackers[key].update(arr)
            count += 1
            if max_eps is not None and count >= max_eps:
                break
        local = {k: t.finalize() for k, t in trackers.items()}
        # Cross-rank merge: every data rank read a disjoint episode shard;
        # pool the moments exactly, envelope the quantiles.
        if process_count > 1:
            from lap_tpu_torch.policies.model_transforms import NormStats
            from lap_tpu_torch.training.array_utils import gather_host_json

            gathered = gather_host_json({k: v.to_dict() for k, v in local.items()})
            local = {
                k: _norm_stats.merge_norm_stats(
                    [NormStats.from_dict(g[k]) for g in gathered if k in g],
                    dim=len(local[k].mean) if k in local else train_config.model.action_dim,
                )
                for k in {key for g in gathered for key in g}
            }
        per_dataset[name] = {
            "stats": local,
            "state_type": "joint_pos" if ds_cfg.state_encoding == "joint" else (
                "none" if ds_cfg.state_encoding == "none" else "eef_pose"
            ),
        }
        logger.info(
            "norm stats: %s processed %d episodes (%d transitions)",
            name, count, local.get("actions", None).num_transitions if local.get("actions") else 0,
        )

    action_dim = train_config.model.action_dim
    stats: dict = {
        "actions": _norm_stats.merge_norm_stats(
            [d["stats"].get("actions") for d in per_dataset.values()], dim=action_dim
        )
    }
    for state_type in ("eef_pose", "joint_pos"):
        group = [
            d["stats"].get("state")
            for d in per_dataset.values()
            if d["state_type"] == state_type and d["stats"].get("state") is not None
        ]
        if group:
            # States keep their native (rot6d-expanded) dimensionality.
            state_dim = max(len(s.mean) for s in group)
            stats[f"state_{state_type}"] = _norm_stats.merge_norm_stats(group, dim=state_dim)
    # Model-facing 'state' = the eef group (falls back to joint-only mixes).
    stats["state"] = stats.get("state_eef_pose", stats.get("state_joint_pos", stats["actions"]))
    # Frame counts for balance weights: state rows = one per frame (the
    # actions tracker counts T*horizon rows).
    transitions = {
        name: int(d["stats"]["state"].num_transitions)
        for name, d in per_dataset.items()
        if d["stats"].get("state") is not None
    }
    return stats, transitions


def build_rlds_dataset(train_config, *, split: str = "train"):
    """(iterable frame dataset, norm_stats) for the configured mixture."""
    process_index, process_count = process_placement()

    data_cfg = train_config.data
    mixture_name = data_cfg.data_mix or data_cfg.repo_id
    members = get_mixture(mixture_name)

    cache = _stats_cache_path(train_config, mixture_name)
    stats, transitions = None, {}
    if cache.exists() and not data_cfg.force_recompute_stats:
        stats = _norm_stats.load_norm_stats(cache)
        import json as _json

        transitions = _json.loads(cache.read_text()).get("per_dataset_transitions", {})
    if stats is None:
        logger.info("computing norm stats for mixture %s", mixture_name)
        stats, transitions = compute_mixture_norm_stats(train_config, members)
        if process_index == 0:
            _norm_stats.save_norm_stats(cache, stats, extra={"per_dataset_transitions": transitions})

    from lap_tpu_torch.data.vqa import VQA_DATASET_CLASSES, build_vqa_dataset

    datasets, weights = [], []
    per_ds_buffer = max(data_cfg.shuffle_buffer_size // max(len(members), 1), 1)
    for i, (name, weight) in enumerate(members):
        if name in VQA_DATASET_CLASSES:
            datasets.append(
                build_vqa_dataset(
                    name,
                    data_dir=data_cfg.rlds_data_dir,
                    resize_resolution=data_cfg.resize_resolution,
                    action_dim=train_config.model.action_dim,
                    action_horizon=train_config.model.action_horizon,
                    seed=train_config.seed + i,
                    split=split,
                    val_fraction=data_cfg.val_fraction or 0.0,
                    direction_prob=data_cfg.direction_prob,
                    repeat=split == "train",
                )
            )
            weights.append(weight)
            continue
        ds_cfg = get_dataset_config(name)
        reader = RLDSReader(data_cfg.rlds_data_dir, name, ds_cfg.tfds_version)
        pipe = _pipeline_for(train_config, ds_cfg, split=split)
        datasets.append(
            RLDSFrameDataset(
                reader,
                pipe,
                split="train",  # RLDS splits are train-only; val comes from the hash split
                shuffle_buffer_size=per_ds_buffer if split == "train" else 1,
                seed=train_config.seed + i,
                repeat=split == "train",
                process_index=process_index,
                process_count=process_count,
            )
        )
        if data_cfg.balance_weights:
            # Weight by dataset FRAME counts (reference dataset_mixer.py:149-155),
            # taken from the stats pass; fall back to episode counts when a
            # cached stats file predates transition tracking.
            n = transitions.get(name) or reader.num_episodes("train")
            if n:
                weight = weight * n
        weights.append(weight)

    if len(datasets) == 1:
        mixture = datasets[0]
    else:
        mixture = WeightedMixture(datasets, weights, seed=train_config.seed)
    return mixture, stats
