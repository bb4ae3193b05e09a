"""Data loader: the per-sample transform chain, batching and the copy to the
card (port of ``lap_tpu/data/loader.py``).

- ``FakeRawDataset`` (``loader.py:31``): synthetic robot samples.
- ``TransformedDataLoader`` (``:71``): the thread pool with prefetch,
  ``_sample_indices`` with its per-epoch shuffle, ``state_dict`` /
  ``load_state_dict`` (batches seen: exact resume by fast-forward), and
  producer errors that reach the consumer.
- ``_keep_batch_fields`` (``:287``) and ``create_data_loader`` (``:312``):
  the ``fake`` repo, or the RLDS mixture of ``data.mixer.build_rlds_dataset``
  (``libero``, ``oxe`` and VQA members) with the frame decoder first and
  ``Normalize`` on the pipeline's norm stats between the data and the model
  transforms; ``set_norm_stats`` hands those to the checkpoint's assets.

Placement: each data rank (``device.process_placement()``: its index over
the mesh's dp x fsdp ranks) loads its share of the global batch. An indexable
dataset gives rank ``r`` of ``n`` the strided slice ``r::n`` of each epoch's
permutation, truncated first to a multiple of ``n`` (``:121-130``); the RLDS
readers shard their episodes instead. A sample's transform is seeded from its
position in the global stream (``n * p + r`` for the ``p``-th sample of rank
``r``), so the data ranks' batches of a step are together the batch one
process would take, sample for sample. A batch becomes tensors in pinned host memory (when the
loader's device is a card) copied with ``non_blocking=True``; images stay
uint8 across the copy, as in JAX (``:244-246``), and the model converts them.

The transforms draw wrist dropout, the image-mask fallback and the random
base frame from numpy's and Python's global RNGs, as the reference's do (the
transforms are copied unchanged). The reference leaves those globals
unseeded, so two of its runs with one seed get different batches and a
resumed run cannot repeat an uninterrupted one. Here each sample's transform
runs under one process-wide lock with both globals seeded from (loader seed,
the sample's position in the stream): a batch is a function of the seed and
its index, whatever the number of threads, so resume is exact. The parity
tests run the JAX loader with one thread and the same seeding around each
sample, and get these batches bit for bit. The frame decoder draws no
randomness and runs before the lock (``unseeded_transforms``), so the
threads decode frames in parallel; the bits are the same.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import random
import threading
from collections.abc import Iterator

import numpy as np
import torch

from lap_tpu_torch.device import process_placement
from lap_tpu_torch.models.types import CoTObservation

logger = logging.getLogger(__name__)

# The global RNGs are the process's: every loader's transforms share them.
_GLOBAL_RNG_LOCK = threading.Lock()


def sample_seed(seed: int, position: int) -> int:
    """The seed of the global RNGs for the sample at ``position`` of a stream
    seeded ``seed`` (32 bits, as ``np.random.seed`` takes)."""
    return int(np.random.SeedSequence([seed, position]).generate_state(1)[0])


def seed_global_rngs(seed: int) -> None:
    np.random.seed(seed)
    random.seed(seed)


class FakeRawDataset:
    """Synthetic robot samples shaped like the RLDS pipeline output."""

    def __init__(self, *, resolution=(224, 224), action_dim=7, action_horizon=4, seed=0, num_samples=256):
        self._res = resolution
        self._action_dim = action_dim
        self._horizon = action_horizon
        self._num = num_samples
        self._seed = seed

    def __len__(self):
        return self._num

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self._seed * 100_003 + idx)
        h, w = self._res
        img = rng.integers(0, 255, (h, w, 3), np.uint8)
        wrist = rng.integers(0, 255, (h, w, 3), np.uint8)
        la = np.zeros(7, np.float32)
        la[:3] = rng.uniform(-0.05, 0.05, 3)
        la[3:6] = rng.uniform(-0.3, 0.3, 3)
        la[6] = float(rng.random() > 0.5)
        return {
            "observation": {
                "base_0_rgb": img,
                "left_wrist_0_rgb": wrist,
                "state": rng.uniform(-1, 1, self._action_dim).astype(np.float32),
            },
            "prompt": "pick up the object",
            "dataset_name": "fake",
            "actions": rng.uniform(-1, 1, (self._horizon, self._action_dim)).astype(np.float32),
            "raw_state": np.concatenate([rng.uniform(-0.5, 0.5, 3), [1, 0, 0, 0, 1, 0], [0.5]]).astype(np.float32),
            "language_actions": la,
            "has_wrist_image": True,
        }


def _stack(samples: list):
    """Stack a list of sample trees leaf by leaf (``jax.tree.map(np.stack)``)."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: _stack([s[k] for s in samples]) for k in first}
    return np.stack(samples)


@dataclasses.dataclass
class TransformedDataLoader:
    """Applies the per-sample transform chain in a thread pool, stacks, and
    copies each batch to ``device`` (the CPU when None)."""

    dataset: object  # indexable (``__getitem__``) or iterable raw dataset
    transforms: list  # per-sample callables, run under the RNG lock
    batch_size: int
    device: torch.device | str | None = None
    seed: int = 0
    shuffle: bool = True
    drop_remainder: bool = True
    prefetch: int = 2
    num_threads: int = 8
    max_samples: int | None = None
    # Per-sample callables that draw no randomness (the frame decoder): run
    # first, outside the RNG lock.
    unseeded_transforms: tuple = ()

    def __post_init__(self):
        self._norm_stats = None
        self._batches_seen = 0

    # -- norm stats hand-off (for checkpoint assets) -------------------------
    @property
    def norm_stats(self):
        return self._norm_stats

    def set_norm_stats(self, stats):
        self._norm_stats = stats

    # -- dataloader state checkpointing --------------------------------------
    def state_dict(self) -> dict:
        return {"batches_seen": self._batches_seen, "seed": self.seed}

    def load_state_dict(self, state: dict):
        self._batches_seen = int(state.get("batches_seen", 0))

    def _transform(self, sample: dict) -> dict:
        for t in self.transforms:
            sample = t(sample)
        return sample

    def _transform_at(self, position: int, sample: dict) -> dict:
        for t in self.unseeded_transforms:
            sample = t(sample)
        index, count = process_placement()
        with _GLOBAL_RNG_LOCK:
            seed_global_rngs(sample_seed(self.seed, position * count + index))
            return self._transform(sample)

    def _sample_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.max_samples is not None:
            n = min(n, self.max_samples)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 7919 + epoch)
            rng.shuffle(idx)
        # The permutation is seed-identical on every data rank; truncate to a
        # multiple of the rank count first, so every rank agrees on the epoch
        # length (and on batches_per_epoch at a resume).
        index, count = process_placement()
        if count > 1:
            idx = idx[: (len(idx) // count) * count]
            idx = idx[index::count]
        return idx

    def __iter__(self) -> Iterator:
        """Infinite iterator over batches on the loader's device (an iterable
        dataset may end it). Producer errors are raised in the consumer."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        indexable = hasattr(self.dataset, "__getitem__")
        depth = max(self.num_threads * 4, self.batch_size)
        start_position = self._batches_seen * self.batch_size

        def raw_indexable():
            # Exact resume: fast-forward to the epoch and the batch within it
            # that batches_seen implies; _sample_indices is a pure function of
            # (seed, epoch).
            batches_per_epoch = max(len(self._sample_indices(0)) // self.batch_size, 1)
            epoch, offset_batches = divmod(self._batches_seen, batches_per_epoch)
            while True:
                indices = self._sample_indices(epoch)
                start0 = offset_batches * self.batch_size
                offset_batches = 0
                for start in range(start0, len(indices) - self.batch_size + 1, self.batch_size):
                    for i in indices[start : start + self.batch_size]:
                        yield self.dataset[int(i)]
                epoch += 1

        def raw_iterable():
            it = iter(self.dataset)
            # Exact resume: the stream is a pure function of its seeds, so
            # dropping the raw samples of the batches seen (without their
            # transforms) reproduces the position.
            if start_position:
                logger.info("dataloader resume: skipping %d raw samples", start_position)
                for _ in range(start_position):
                    try:
                        next(it)
                    except StopIteration:
                        return
            yield from it

        def put(item) -> bool:
            """Queue put that gives up once the consumer is gone."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                raw_iter = raw_indexable() if indexable else raw_iterable()
                position = start_position
                with ThreadPoolExecutor(self.num_threads) as pool:
                    futures: deque = deque()
                    exhausted = False
                    samples = []
                    while True:
                        while not exhausted and len(futures) < depth:
                            try:
                                futures.append(pool.submit(self._transform_at, position, next(raw_iter)))
                                position += 1
                            except StopIteration:
                                exhausted = True
                        if not futures:
                            break
                        if stop.is_set():
                            return
                        samples.append(futures.popleft().result())
                        if len(samples) == self.batch_size:
                            if not put(_stack(samples)):
                                return
                            samples = []
                if samples and not self.drop_remainder:
                    if not put(_stack(samples)):
                        return
                put(None)  # exhausted (an iterable dataset's end)
            except BaseException as e:  # noqa: BLE001 - raised again in the consumer
                put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                self._batches_seen += 1
                yield self._to_device(batch)
        finally:
            stop.set()
            while not out_q.empty():  # unblock a producer parked on a full queue
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break

    def _to_device(self, batch: dict):
        """(observation, actions): host arrays -> pinned tensors -> the
        device, uint8 images included."""
        device = torch.device(self.device or "cpu")
        pin = device.type == "cuda"

        def put(x):
            if isinstance(x, dict):
                return {k: put(v) for k, v in x.items()}
            t = torch.from_numpy(np.ascontiguousarray(x))
            if pin:
                t = t.pin_memory()
            return t.to(device, non_blocking=True)

        tensors = put(batch)
        actions = tensors.pop("actions", None)
        return CoTObservation.from_dict(tensors, convert_images=False), actions


_BATCH_KEYS = (
    "state",
    "actions",
    "tokenized_prompt",
    "tokenized_prompt_mask",
    "tokenized_langact_mask",
    "token_loss_mask",
    "tokenized_dataset_name",
    "critical_token_mask",
    "number_token_mask",
    "direction_token_mask",
    "sample_mask",
    "is_vqa_sample",
    "is_prediction_sample",
    "vqa_dataset_id",
)


def _keep_batch_fields(sample: dict) -> dict:
    """Final per-sample projection to model fields (drops host-only keys);
    optional token masks default to all-False so that batches collate."""
    out = {"image": sample["image"], "image_mask": sample["image_mask"]}
    for k in _BATCH_KEYS:
        if k in sample and sample[k] is not None:
            out[k] = np.asarray(sample[k])
    if "tokenized_prompt" in out:
        token_shape = np.shape(out["tokenized_prompt"])
        for k in ("tokenized_langact_mask", "critical_token_mask", "number_token_mask", "direction_token_mask"):
            if k not in out:
                out[k] = np.zeros(token_shape, dtype=bool)
    return out


def create_data_loader(train_config, *, device=None, split: str = "train") -> TransformedDataLoader:
    """The loader of a TrainConfig (``loader.py:312``)."""
    data_cfg = train_config.data
    model_cfg = train_config.model
    transforms = list(data_cfg.data_transforms(model_cfg).inputs)
    unseeded = ()

    # Normalization between data and model transforms (reference ordering).
    norm_stats = None
    if data_cfg.repo_id == "fake":
        dataset = FakeRawDataset(
            resolution=model_cfg.image_resolution,
            action_dim=model_cfg.action_dim,
            action_horizon=model_cfg.action_horizon,
            seed=train_config.seed,
        )
    else:
        from lap_tpu_torch.data.episode_pipeline import make_image_decoder
        from lap_tpu_torch.data.mixer import build_rlds_dataset

        dataset, norm_stats = build_rlds_dataset(train_config, split=split)
        # Frames cross the shuffle buffer as encoded bytes; decode (+resize,
        # wrist rotation) in the loader's threads, ahead of the seeded chain.
        unseeded = (make_image_decoder(data_cfg.resize_resolution),)

    if norm_stats is not None:
        from lap_tpu_torch.policies.model_transforms import Normalize

        transforms.append(Normalize(norm_stats, normalization_type=data_cfg.action_proprio_normalization_type))
    transforms.extend(data_cfg.model_transforms(model_cfg, include_outputs=False).inputs)
    transforms.append(_keep_batch_fields)

    # Each data rank loads its share of the global batch.
    _, n_proc = process_placement()
    if train_config.batch_size % n_proc != 0:
        raise ValueError(f"batch_size {train_config.batch_size} not divisible by process_count {n_proc}")
    loader = TransformedDataLoader(
        dataset=dataset,
        transforms=transforms,
        batch_size=train_config.batch_size // n_proc,
        device=device,
        seed=train_config.seed,
        shuffle=split == "train",
        max_samples=data_cfg.max_samples,
        unseeded_transforms=unseeded,
    )
    loader.set_norm_stats(norm_stats)
    return loader
