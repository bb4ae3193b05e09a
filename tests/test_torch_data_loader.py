"""The port's RLDS loader (``lap_tpu_torch/data/loader.py``
``create_data_loader`` over ``data/mixer.py``) against the JAX package's on
the CPU, on mixtures written to disk with the packages' own writers.

Exact, no tolerance: batches equal the JAX loader's bit for bit, images,
tokens, masks, normalized states and actions included, on

- the ``libero_finetune`` mixture (four LIBERO datasets, 48x48 JPEG frames,
  4 episodes of 12 steps), each package running its own norm-stats pass;
- the 16-member ``oxe_magic_soup`` plus a COCO-captions VQA member (the
  mixture of ``tests/test_magic_soup_e2e.py``): heterogeneous cameras,
  state dims and supervision in one batch;
- LIBERO episodes with bbox annotations (grounding QA samples);
- the hash validation split (``val_fraction``, unshuffled).

The JAX loader runs on one thread with the global RNGs seeded around each
sample as the port seeds them (``test_torch_loader._seeded_jax_loader``);
the port runs its eight threads, with the frame decoder outside its RNG
lock. A port loader resumed from ``state_dict`` continues an uninterrupted
RLDS stream, and the JAX loader's, bit for bit.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_transforms_oxe as tto  # noqa: E402
from lap_tpu.data import mixtures as jax_mixtures  # noqa: E402
from lap_tpu.data import rlds as jax_rlds  # noqa: E402
from lap_tpu.training import config as jax_config  # noqa: E402
from lap_tpu_torch.data import loader as port_loader  # noqa: E402
from lap_tpu_torch.data import mixtures as port_mixtures  # noqa: E402
from lap_tpu_torch.data import rlds as port_rlds  # noqa: E402
from lap_tpu_torch.data.episode_pipeline import encode_jpeg  # noqa: E402
from lap_tpu_torch.training import config as port_config  # noqa: E402
from test_torch_loader import _assert_batches_equal, _seeded_jax_loader  # noqa: E402
from torch_port_helpers import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

LIBERO = ("libero_10_no_noops", "libero_goal_no_noops", "libero_object_no_noops", "libero_spatial_no_noops")
SOUP = [name for name, _ in jax_mixtures.OXE_NAMED_MIXTURES["oxe_magic_soup"]]
FAB_ALIAS = {"bridge_v2_oxe": "bridge_dataset"}


def _libero_episode(rng, index, t=12):
    frames = [encode_jpeg(rng.integers(0, 255, (48, 48, 3), np.uint8)) for _ in range(2 * t)]
    state = np.concatenate([rng.uniform(-0.3, 0.3, (t, 3)), rng.uniform(-0.5, 0.5, (t, 3)),
                            rng.uniform(0, 0.04, (t, 2))], -1).astype(np.float32)
    action = np.concatenate([rng.uniform(-0.02, 0.02, (t, 6)), rng.choice([-1.0, 1.0], (t, 1))], -1)
    return {
        "steps": {
            "observation": {"image": frames[:t], "wrist_image": frames[t:], "state": state},
            "action": action.astype(np.float32),
            "language_instruction": [f"put the bowl on plate {index}"] * t,
        },
        "episode_metadata": {"file_path": [f"/libero/episode_{index}.hdf5"]},
    }


@pytest.fixture(scope="module")
def libero_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("libero")
    rng = np.random.default_rng(0)
    for i, name in enumerate(LIBERO):
        writer = (jax_rlds, port_rlds)[i % 2]  # both packages' writers
        writer.write_rlds_dataset(root, name, [_libero_episode(rng, 4 * i + k) for k in range(4)])
    return root


def _libero_config(module, root, **data):
    c = module.get_config("debug")
    fields = dict(repo_id="libero", data_mix="libero_finetune", rlds_data_dir=str(root), shuffle_buffer_size=32,
                  val_fraction=0.0, resize_resolution=(56, 56), force_recompute_stats=True)
    fields.update(data)
    return dataclasses.replace(c, batch_size=4, data=dataclasses.replace(c.data, **fields),
                               model=dataclasses.replace(c.model, image_resolution=(56, 56)))


def _compare(jax_cfg, port_cfg, n, *, split="train", batches_seen=0):
    jl = _seeded_jax_loader(jax_cfg, split=split, batches_seen=batches_seen)
    pl = port_loader.create_data_loader(port_cfg, split=split)
    pl.load_state_dict({"batches_seen": batches_seen})
    assert pl.num_threads == 8 and jl.num_threads == 1
    jit, pit = iter(jl), iter(pl)
    batches = []
    try:
        for _ in range(n):
            jb, pb = next(jit), next(pit)
            _assert_batches_equal(jb, pb)
            batches.append(pb)
    finally:
        jit.close()
        pit.close()
    return jl, pl, batches


def test_libero_batches_equal_jax(libero_dir):
    jl, pl, batches = _compare(_libero_config(jax_config, libero_dir), _libero_config(port_config, libero_dir), 10)
    assert {k: v.to_dict() for k, v in pl.norm_stats.items()} == {k: v.to_dict() for k, v in jl.norm_stats.items()}
    assert any(type(t).__name__ == "Normalize" for t in pl.transforms)
    assert [getattr(t, "__name__", "") for t in pl.unseeded_transforms] == ["decode"]
    obs, actions = batches[0]
    assert obs.images["base_0_rgb"].shape == (4, 56, 56, 3) and obs.images["base_0_rgb"].dtype == torch.uint8
    assert actions.shape == (4, 4, 7) and torch.isfinite(actions).all()
    # The stream mixes the four datasets and reaches past the first episodes.
    prompts = {tuple(o.tokenized_prompt[i].tolist()) for o, _ in batches for i in range(4)}
    assert len(prompts) > 4


def test_resumed_rlds_loader_continues_the_stream(libero_dir):
    """Resume at batch 6 of 9: the port's batches 6-8 equal the uninterrupted
    port stream's and the resumed JAX loader's."""
    port_cfg = _libero_config(port_config, libero_dir)
    uninterrupted = port_loader.create_data_loader(port_cfg)
    it = iter(uninterrupted)
    reference = [next(it) for _ in range(9)]
    it.close()
    _, resumed, batches = _compare(_libero_config(jax_config, libero_dir), port_cfg, 3, batches_seen=6)
    for want, got in zip(reference[6:], batches, strict=True):
        _assert_batches_equal(want, got)
    assert resumed.state_dict()["batches_seen"] == 9


def test_the_decoder_runs_outside_the_rng_lock(libero_dir, monkeypatch):
    """No thread holds the RNG lock while it decodes a frame; the seeded
    transforms run under it."""
    import threading

    from lap_tpu_torch.data import episode_pipeline

    class OwnedLock:
        def __init__(self):
            self.lock, self.owner, self.entries = threading.Lock(), None, 0

        def __enter__(self):
            self.lock.acquire()
            self.owner, self.entries = threading.get_ident(), self.entries + 1

        def __exit__(self, *exc):
            self.owner = None
            self.lock.release()

    lock = OwnedLock()
    monkeypatch.setattr(port_loader, "_GLOBAL_RNG_LOCK", lock)
    held = []
    real = episode_pipeline.decode_image

    def spy(data):
        held.append(lock.owner == threading.get_ident())
        return real(data)

    monkeypatch.setattr(episode_pipeline, "decode_image", spy)
    it = iter(port_loader.create_data_loader(_libero_config(port_config, libero_dir)))
    next(it)
    it.close()
    assert held and not any(held) and lock.entries >= 4


def test_validation_split_equals_jax(libero_dir):
    kw = dict(val_fraction=0.5)
    _, pl, batches = _compare(_libero_config(jax_config, libero_dir, **kw), _libero_config(port_config, libero_dir, **kw),
                              4, split="val")
    assert not pl.shuffle


def _annotations(root, name, episodes):
    ann = root / "bbox" / name
    ann.mkdir(parents=True)
    lines = []
    for index in episodes:
        labels = [{"frame": f, "all_objects": [
            {"label": "red bowl", "bbox": [40 + 7 * f, 60, 300, 410], "is_target": True},
            {"label": "plate", "bbox": [500, 520, 700, 800], "is_target": False}]} for f in range(0, 12, 2)]
        lines.append(json.dumps({"episode_metadata": {"file_path": f"/libero/episode_{index}.hdf5"}, "labels": labels}))
    (ann / "labels.jsonl").write_text("\n".join(lines) + "\n")
    return root / "bbox"


def test_grounding_samples_equal_jax(libero_dir, tmp_path):
    bbox = None
    for i, name in enumerate(LIBERO):
        bbox = _annotations(tmp_path, name, range(4 * i, 4 * i + 4))
    kw = dict(bbox_annotations_dir=str(bbox), grounding_prob=0.5, direction_prob=0.3)
    jl, pl, batches = _compare(_libero_config(jax_config, libero_dir, **kw), _libero_config(port_config, libero_dir, **kw), 8)
    assert sum(int(o.is_vqa_sample.sum()) for o, _ in batches) > 0  # grounding QA samples are in the stream


@pytest.fixture(scope="module")
def soup_dir(tmp_path_factory):
    """The magic soup of ``tests/test_magic_soup_e2e.py``, JPEG frames from the port's encoder."""
    root = tmp_path_factory.mktemp("soup")
    rng = np.random.default_rng(0)
    images = tto.IMGS
    tto.IMGS = [encode_jpeg(rng.integers(0, 255, (48, 48, 3), np.uint8)) for _ in range(tto.T)]
    try:
        for name in SOUP:
            fab = tto.FABRICATORS[FAB_ALIAS.get(name, name)]
            jax_rlds.write_rlds_dataset(root, name, [fab() for _ in range(3)])
    finally:
        tto.IMGS = images
    coco = [{"image": [encode_jpeg(rng.integers(0, 255, (48, 48, 3), np.uint8))],
             "captions": {"text": ["a cat on a mat", "a mat"]}} for _ in range(3)]
    jax_rlds.write_rlds_dataset(root, "coco_captions", coco)
    return root


@pytest.fixture
def soup_mixture(monkeypatch):
    # Robot members weigh weight x frames (balance_weights); 30 makes the VQA member ~10% of draws.
    mix = jax_mixtures.OXE_NAMED_MIXTURES["oxe_magic_soup"] + [("coco_captions", 30.0)]
    monkeypatch.setitem(jax_mixtures.OXE_NAMED_MIXTURES, "magic_soup_test", mix)
    monkeypatch.setitem(port_mixtures.OXE_NAMED_MIXTURES, "magic_soup_test", list(mix))


def _soup_config(module, root):
    c = module.get_config("debug")
    return dataclasses.replace(
        c, batch_size=8, model=dataclasses.replace(c.model, action_dim=20),
        data=dataclasses.replace(c.data, repo_id="soup", data_mix="magic_soup_test", rlds_data_dir=str(root),
                                 val_fraction=0.0, shuffle_buffer_size=64, force_recompute_stats=True))


def test_magic_soup_with_vqa_batches_equal_jax(soup_dir, soup_mixture):
    jl, pl, batches = _compare(_soup_config(jax_config, soup_dir), _soup_config(port_config, soup_dir), 6)
    assert len(pl.dataset.datasets) == len(SOUP) + 1
    np.testing.assert_array_equal(pl.dataset.probs, jl.dataset.probs)
    names = np.concatenate([o.tokenized_dataset_name.numpy() for o, _ in batches])
    assert len(np.unique(names, axis=0)) >= 3
    assert any(bool(o.is_vqa_sample.any()) for o, _ in batches)  # the VQA member is drawn


def test_lap_config_loader_builds_on_a_written_mixture(soup_dir):
    """The ``lap`` recipe (``oxe_magic_soup`` at action dim 7, its 2.5%
    validation split) builds its RLDS loader with JAX's norm stats and
    balance weights; with the split off, its first batch is JAX's. (The
    fabricated episodes of a dataset are identical, so one hash puts all of
    molmoact's in the validation split: that member then gives no training
    frame.)"""
    configs = [dataclasses.replace(m.get_config("lap"), batch_size=4) for m in (jax_config, port_config)]
    configs = [dataclasses.replace(c, data=dataclasses.replace(c.data, rlds_data_dir=str(soup_dir),
                                                              shuffle_buffer_size=64, force_recompute_stats=True))
               for c in configs]
    from lap_tpu.data import loader as jax_loader

    jl, pl = jax_loader.create_data_loader(configs[0]), port_loader.create_data_loader(configs[1])
    assert len(pl.dataset.datasets) == len(SOUP)
    np.testing.assert_array_equal(pl.dataset.probs, jl.dataset.probs)
    assert {k: v.to_dict() for k, v in pl.norm_stats.items()} == {k: v.to_dict() for k, v in jl.norm_stats.items()}
    configs = [dataclasses.replace(c, data=dataclasses.replace(c.data, val_fraction=0.0)) for c in configs]
    _, _, (batch,) = _compare(*configs, 1)
    obs, actions = batch
    assert actions.shape == (4, 16, 7) and obs.tokenized_prompt.shape == (4, 180)


def test_a_member_without_training_frames_never_ends_in_either_package(soup_dir):
    """A quirk of the reference the copy keeps: a member whose episodes give
    no frame (all in the validation split here) re-reads its episodes
    forever instead of raising; only a member with no episode raises."""
    from lap_tpu.data import mixer as jax_mixer
    from lap_tpu_torch.data import mixer as port_mixer

    for module, mixer in ((jax_config, jax_mixer), (port_config, port_mixer)):
        c = module.get_config("lap")
        c = dataclasses.replace(c, data=dataclasses.replace(c.data, rlds_data_dir=str(soup_dir), data_mix="molmoact_dataset"))
        dataset, _ = mixer.build_rlds_dataset(c)
        reads = []
        episodes = dataset.reader.episodes

        def counted(*a, _episodes=episodes, **kw):
            if len(reads) >= 5:
                raise TimeoutError("still no frame after five passes")
            reads.append(1)
            return _episodes(*a, **kw)

        dataset.reader.episodes = counted
        with pytest.raises(TimeoutError):
            next(iter(dataset))


def test_vqa_members_decode_in_the_raw_stream_in_both_packages(soup_dir):
    """A quirk of the reference the copy keeps: a VQA member yields decoded,
    resized frames (robot frames stay JPEG bytes until the loader's
    threads), so a resumed run decodes the VQA frames it skips."""
    from lap_tpu.data import vqa as jax_vqa
    from lap_tpu_torch.data import vqa as port_vqa
    from torch_port_helpers import assert_same_tree

    kw = dict(data_dir=str(soup_dir), resize_resolution=(56, 56), action_dim=7, action_horizon=4, seed=1)
    frames = [next(iter(module.build_vqa_dataset("coco_captions", **kw))) for module in (jax_vqa, port_vqa)]
    assert_same_tree(frames[1], frames[0])
    image = frames[1]["observation"]["base_0_rgb"]
    assert isinstance(image, np.ndarray) and image.shape == (56, 56, 3) and frames[1]["is_vqa_sample"]
