"""Files the port's data pipeline shares with the JAX package, on the CPU:
TFRecords, ``tf.train.Example`` records, TFDS-layout RLDS directories and
the norm-stats cache (``lap_tpu_torch/data/{tfrecord,rlds,norm_stats,
mixer}.py``).

Exact, no tolerance: each package's writer gives the same bytes; each
reads the other's files to the same records, episodes and statistics; a
norm-stats cache written by one is read by the other to equal stats, its
``per_dataset_transitions`` included, and the two packages' stats passes
over one mixture give the same cache.
"""

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from lap_tpu.data import mixer as jax_mixer  # noqa: E402
from lap_tpu.data import norm_stats as jax_ns  # noqa: E402
from lap_tpu.data import rlds as jax_rlds  # noqa: E402
from lap_tpu.data import tfrecord as jax_tfr  # noqa: E402
from lap_tpu.training import config as jax_config  # noqa: E402
from lap_tpu_torch.data import mixer as port_mixer  # noqa: E402
from lap_tpu_torch.data import norm_stats as port_ns  # noqa: E402
from lap_tpu_torch.data import rlds as port_rlds  # noqa: E402
from lap_tpu_torch.data import tfrecord as port_tfr  # noqa: E402
from lap_tpu_torch.training import config as port_config  # noqa: E402
from torch_port_helpers import assert_same_tree  # noqa: E402

PACKAGES = {"jax": (jax_tfr, jax_rlds, jax_ns), "port": (port_tfr, port_rlds, port_ns)}
DIRECTIONS = [("jax", "port"), ("port", "jax")]
LIBERO = ("libero_10_no_noops", "libero_goal_no_noops", "libero_object_no_noops", "libero_spatial_no_noops")


def _records(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(n)) for n in rng.integers(0, 3000, 12)] + [b""]


def _example_features(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "steps/observation/image": [rng.bytes(50), rng.bytes(0), rng.bytes(7)],
        "steps/language_instruction": ["pick up the bowl", "", "ünïcode"],
        "steps/action": rng.normal(size=21).astype(np.float32),
        "steps/is_first": np.array([1, 0, 0], np.int64),
        "steps/reward": np.array([-3, 0, 1 << 40], np.int64),
        "episode_metadata/file_path": "a/b/c.h5",
    }


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_tfrecords_read_across_packages(tmp_path, writer, reader):
    records = _records()
    path = tmp_path / "x.tfrecord"
    PACKAGES[writer][0].write_tfrecords(path, records)
    assert list(PACKAGES[reader][0].read_tfrecords(path, verify_crc=True)) == records
    other = tmp_path / "y.tfrecord"
    PACKAGES[reader][0].write_tfrecords(other, records)
    assert other.read_bytes() == path.read_bytes()


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_examples_parse_across_packages(writer, reader):
    features = _example_features()
    raw = PACKAGES[writer][0].build_example(features)
    assert raw == PACKAGES[reader][0].build_example(features)
    assert_same_tree(PACKAGES[reader][0].parse_example(raw), jax_tfr.parse_example(raw))
    parsed = PACKAGES[reader][0].parse_example(raw)
    assert parsed["steps/language_instruction"][2] == "ünïcode".encode()
    np.testing.assert_array_equal(parsed["steps/reward"], features["steps/reward"])


def _libero_episode(rng, t=12, frame=(24, 32)):
    from lap_tpu_torch.data.episode_pipeline import encode_jpeg

    state = np.concatenate([rng.uniform(-0.3, 0.3, (t, 3)), rng.uniform(-0.5, 0.5, (t, 3)),
                            rng.uniform(0, 0.04, (t, 2))], -1).astype(np.float32)
    action = np.concatenate([rng.uniform(-0.02, 0.02, (t, 6)), rng.choice([-1.0, 1.0], (t, 1))], -1)
    return {"steps": {
        "observation": {"image": [encode_jpeg(rng.integers(0, 255, (*frame, 3), np.uint8)) for _ in range(t)],
                        "wrist_image": [encode_jpeg(rng.integers(0, 255, (*frame, 3), np.uint8)) for _ in range(t)],
                        "state": state},
        "action": action.astype(np.float32),
        "language_instruction": [f"put the bowl on plate {int(rng.integers(9))}"] * t,
    }}


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_rlds_directories_read_across_packages(tmp_path, writer, reader):
    rng = np.random.default_rng(1)
    episodes = [_libero_episode(rng, t=int(rng.integers(3, 9))) for _ in range(5)]
    root = tmp_path / writer
    PACKAGES[writer][1].write_rlds_dataset(root, "libero_10_no_noops", episodes)
    again = tmp_path / "again"
    PACKAGES[reader][1].write_rlds_dataset(again, "libero_10_no_noops", episodes)
    for name in ("features.json", "dataset_info.json", "libero_10_no_noops-train.tfrecord-00000-of-00001"):
        assert (again / "libero_10_no_noops/1.0.0" / name).read_bytes() == \
            (root / "libero_10_no_noops/1.0.0" / name).read_bytes(), name
    want_reader = jax_rlds.RLDSReader(root, "libero_10_no_noops")
    got_reader = PACKAGES[reader][1].RLDSReader(root, "libero_10_no_noops")
    assert got_reader.spec == want_reader.spec and got_reader.num_episodes() == 5
    for shard in ((0, 1), (0, 2), (1, 2)):
        want = list(want_reader.episodes("train", shard_index=shard[0], num_shards=shard[1]))
        got = list(got_reader.episodes("train", shard_index=shard[0], num_shards=shard[1]))
        assert_same_tree(got, want)
    assert got[0]["steps"]["action"].shape[1] == 7  # TFDS slash keys come back nested


def test_running_stats_and_quantiles_equal_jax():
    rng = np.random.default_rng(2)
    trackers = {k: mod.RunningStats(5) for k, mod in (("jax", jax_ns), ("port", port_ns))}
    for i in range(6):
        batch = rng.standard_t(3, size=(int(rng.integers(1, 400)), 5)) * (i + 1)
        for t in trackers.values():
            t.update(batch)
    assert_same_tree(trackers["port"].finalize().to_dict(), trackers["jax"].finalize().to_dict())
    parts = [jax_ns.RunningStats(5) for _ in range(3)]
    for p in parts:
        p.update(rng.normal(size=(50, 5)))
    stats = [p.finalize() for p in parts]
    assert_same_tree(port_ns.merge_norm_stats(stats, dim=7).to_dict(), jax_ns.merge_norm_stats(stats, dim=7).to_dict())


@pytest.fixture(scope="module")
def libero_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("libero_files")
    rng = np.random.default_rng(3)
    episodes = [_libero_episode(rng) for _ in range(3)]
    for name in LIBERO:
        jax_rlds.write_rlds_dataset(root, name, episodes)
    return root


def _configs(root):
    out = []
    for mod in (jax_config, port_config):
        c = mod.get_config("debug")
        out.append(dataclasses.replace(c, data=dataclasses.replace(
            c.data, repo_id="libero", data_mix="libero_finetune", rlds_data_dir=str(root), val_fraction=0.0,
            shuffle_buffer_size=16, resize_resolution=(56, 56)), model=dataclasses.replace(c.model, image_resolution=(56, 56))))
    return out


def test_stats_passes_equal_jax(libero_dir):
    jc, pc = _configs(libero_dir)
    members = jax_mixer.get_mixture("libero_finetune")
    want_stats, want_transitions = jax_mixer.compute_mixture_norm_stats(jc, members)
    got_stats, got_transitions = port_mixer.compute_mixture_norm_stats(pc, members)
    assert got_transitions == want_transitions == {name: 36 for name in LIBERO}
    assert_same_tree({k: v.to_dict() for k, v in got_stats.items()}, {k: v.to_dict() for k, v in want_stats.items()})


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_norm_stats_cache_is_shared(libero_dir, tmp_path, writer, reader):
    """``build_rlds_dataset`` writes ``norm_stats_cache/<mixture>.json`` in
    one package; the other reads it (no second pass) to the same stats."""
    import shutil

    root = tmp_path / "data"
    shutil.copytree(libero_dir, root)
    configs = dict(zip(("jax", "port"), _configs(root)))
    mixers = {"jax": jax_mixer, "port": port_mixer}
    _, written = mixers[writer].build_rlds_dataset(configs[writer])
    cache = root / "norm_stats_cache" / "libero_finetune.json"
    payload = json.loads(cache.read_text())
    assert payload["per_dataset_transitions"] == {name: 36 for name in LIBERO}
    # The reader must take the cache, not recompute: poison the data.
    for name in LIBERO:
        shutil.rmtree(root / name / "1.0.0")
        (root / name / "1.0.0").mkdir()
        jax_rlds.write_rlds_dataset(root, name, [_libero_episode(np.random.default_rng(99))])
    dataset, read = mixers[reader].build_rlds_dataset(configs[reader])
    assert_same_tree({k: v.to_dict() for k, v in read.items()}, {k: v.to_dict() for k, v in written.items()})
    assert json.loads(cache.read_text()) == payload
    # Balance weights come from the cached transition counts.
    assert np.allclose(dataset.probs, 0.25)
    saved = tmp_path / "saved.json"
    PACKAGES[reader][2].save_norm_stats(saved, read, extra={"per_dataset_transitions": payload["per_dataset_transitions"]})
    assert_same_tree({k: v.to_dict() for k, v in PACKAGES[writer][2].load_norm_stats(saved).items()},
                     {k: v.to_dict() for k, v in written.items()})
