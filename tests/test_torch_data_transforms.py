"""The port's dataset standardizations, registry, mixtures and episode
pipeline (``lap_tpu_torch/data/{transforms_oxe,registry,mixtures,
transform_helpers,episode_pipeline}.py``) against the JAX package's on the
CPU.

Exact, no tolerance: every fabricated raw episode of
``tests/test_transforms_oxe.py`` (``FABRICATORS``, two seeds) standardizes to
the same trees in both packages, and the episode pipeline turns it into the
same frames (state in rot6d, action chunks, language actions, prediction
pairs, the rotation decision); the registry's configs and VQA ids, the named
mixtures and the instruction fills agree.
"""

import copy

import numpy as np
import pytest

pytest.importorskip("torch")

import test_transforms_oxe as tto  # noqa: E402
from lap_tpu.data import episode_pipeline as jax_ep  # noqa: E402
from lap_tpu.data import mixtures as jax_mixtures  # noqa: E402
from lap_tpu.data import registry as jax_registry  # noqa: E402
from lap_tpu.data import transform_helpers as jax_th  # noqa: E402
from lap_tpu.data import transforms_oxe as _jax_transforms  # noqa: E402,F401 - registers
from lap_tpu.data import vqa as _jax_vqa  # noqa: E402,F401 - registers the VQA datasets and their ids
from lap_tpu_torch.data import episode_pipeline as port_ep  # noqa: E402
from lap_tpu_torch.data import mixtures as port_mixtures  # noqa: E402
from lap_tpu_torch.data import registry as port_registry  # noqa: E402
from lap_tpu_torch.data import transform_helpers as port_th  # noqa: E402
from lap_tpu_torch.data import transforms_oxe as _port_transforms  # noqa: E402,F401 - registers
from lap_tpu_torch.data import vqa as _port_vqa  # noqa: E402,F401 - registers the VQA datasets and their ids
from torch_port_helpers import assert_same_tree  # noqa: E402

NAMES = sorted(tto.FABRICATORS)


def _episode(name, seed_offset, monkeypatch):
    monkeypatch.setattr(tto, "SEED_OFFSET", seed_offset)
    return tto.FABRICATORS[name]()


@pytest.mark.parametrize("seed_offset", [0, 1000])
@pytest.mark.parametrize("name", NAMES)
def test_standardization_equals_jax(name, seed_offset, monkeypatch):
    episode = _episode(name, seed_offset, monkeypatch)
    want = jax_registry.get_dataset_config(name).standardize_fn(copy.deepcopy(episode))
    got = port_registry.get_dataset_config(name).standardize_fn(copy.deepcopy(episode))
    assert_same_tree(got, want)


def _pipeline(ep_module, registry, name, **kw):
    ds = registry.get_dataset_config(name)
    cfg = ep_module.PipelineConfig(
        action_horizon=4, action_dim=20, state_dim=20, horizon_seconds=(0.4, 1.0, 2.0),
        control_frequency=ds.control_frequency, enable_prediction_training=True, pred_prob=0.5,
        needs_wrist_rotation=ds.needs_wrist_rotation, not_rotate_wrist_prob=0.3, seed=3,
    )
    return ep_module.EpisodePipeline(cfg, standardize_fn=ds.standardize_fn, dataset_name=name,
                                     is_bimanual=ds.is_bimanual, is_navigation=ds.is_navigation, **kw)


@pytest.mark.parametrize("name", NAMES)
def test_episode_pipeline_frames_equal_jax(name, monkeypatch):
    episode = _episode(name, 0, monkeypatch)
    want = list(_pipeline(jax_ep, jax_registry, name).process_episode(copy.deepcopy(episode)))
    got = list(_pipeline(port_ep, port_registry, name).process_episode(copy.deepcopy(episode)))
    assert_same_tree(got, want)


def test_registry_equals_jax():
    names = jax_registry.registered_names()
    assert port_registry.registered_names() == names
    for name in names + list(tto.REFERENCE_REGISTRY_KEYS):
        assert_same_tree(vars(port_registry.get_dataset_config(name)), vars(jax_registry.get_dataset_config(name)),
                         name)
    # Filled in import order (both packages' vqa modules are imported above):
    # the same ids as JAX.
    assert len(jax_registry.VQA_DATASET_ID_MAP) == 7
    assert port_registry.VQA_DATASET_ID_MAP == jax_registry.VQA_DATASET_ID_MAP
    assert port_registry.VQA_DATASET_ID_TO_NAME == jax_registry.VQA_DATASET_ID_TO_NAME
    assert port_registry._NEXT_VQA_ID == jax_registry._NEXT_VQA_ID


def test_named_mixtures_equal_jax():
    assert port_mixtures.OXE_NAMED_MIXTURES == jax_mixtures.OXE_NAMED_MIXTURES
    for name in jax_mixtures.OXE_NAMED_MIXTURES:
        assert port_mixtures.get_mixture(name) == jax_mixtures.get_mixture(name)


def test_instruction_fill_and_fingerprint_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        state = rng.normal(size=rng.integers(1, 9)).astype(np.float32)
        text = rng.bytes(int(rng.integers(0, 65)))  # the fingerprint takes up to 64 bytes
        assert port_th.farmhash_fingerprint64(text) == jax_th.farmhash_fingerprint64(text)
        instrs = ["", "  "][: int(rng.integers(1, 3))]
        for deterministic in (True, False):
            assert port_th.fill_empty_instructions(instrs, state, deterministic=deterministic) == \
                jax_th.fill_empty_instructions(instrs, state, deterministic=deterministic)


def test_val_split_and_trajectory_rng_equal_jax():
    for i in range(500):
        traj_id = f"traj_{i}_{i * 7919 % 1013}"
        assert port_ep.stable_hash(traj_id) == jax_ep.stable_hash(traj_id)
        for fraction in (0.0, 0.025, 0.3):
            assert port_ep.in_val_split(traj_id, fraction) == jax_ep.in_val_split(traj_id, fraction)
        assert port_ep.traj_rng(5, traj_id).integers(1 << 30) == jax_ep.traj_rng(5, traj_id).integers(1 << 30)
