"""The port's data loader (``lap_tpu_torch/data/loader.py``) against
``lap_tpu/data/loader.py`` on the CPU.

Exact on both counts, no tolerance: the ``fake`` loader's batches on the
``debug`` config, several of them across an epoch boundary, equal the JAX
loader's bit for bit, and a loader resumed from ``state_dict`` continues
the stream of an uninterrupted one (the cases of ``tests/test_resume.py``).
The transforms draw wrist dropout and the mask fallback from numpy's and
Python's global RNGs: the port's loader seeds both before each sample from
(seed, position in the stream) under one lock, and the JAX loader is run
with one thread and the same seeding around each sample.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.data import loader as jax_loader  # noqa: E402
from lap_tpu.training import config as jax_config  # noqa: E402
from lap_tpu_torch.data import loader as port_loader  # noqa: E402
from lap_tpu_torch.training import config as port_config  # noqa: E402
from torch_port_helpers import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

OBS_FIELDS = ("state", "tokenized_prompt", "tokenized_prompt_mask", "tokenized_langact_mask", "token_loss_mask",
              "critical_token_mask", "number_token_mask", "direction_token_mask", "sample_mask", "is_vqa_sample",
              "is_prediction_sample", "vqa_dataset_id")


def _seeded_jax_loader(config, split="train", batches_seen=0):
    """The JAX loader with one thread, resumed at ``batches_seen``, the
    global RNGs seeded around each sample as the port's loader seeds them."""
    loader = jax_loader.create_data_loader(config, None, split=split)
    loader.num_threads = 1
    loader.load_state_dict({"batches_seen": batches_seen})
    position = [batches_seen * loader.batch_size]
    transform = loader._transform

    def seeded(sample):
        with port_loader._GLOBAL_RNG_LOCK:
            port_loader.seed_global_rngs(port_loader.sample_seed(loader.seed, position[0]))
            position[0] += 1
            return transform(sample)

    loader._transform = seeded
    return loader


def _assert_batches_equal(jax_batch, port_batch):
    jobs, jactions = jax_batch
    pobs, pactions = port_batch
    np.testing.assert_array_equal(np.asarray(jactions), pactions.numpy())
    for field in OBS_FIELDS:
        ref, got = getattr(jobs, field), getattr(pobs, field)
        assert (ref is None) == (got is None), field
        if ref is not None:
            np.testing.assert_array_equal(np.asarray(ref), got.numpy(), err_msg=field)
    assert set(jobs.images) == set(pobs.images)
    for key in jobs.images:
        assert pobs.images[key].dtype == torch.uint8  # uint8 across the copy
        np.testing.assert_array_equal(np.asarray(jobs.images[key]), pobs.images[key].numpy(), err_msg=key)
        np.testing.assert_array_equal(np.asarray(jobs.image_masks[key]), pobs.image_masks[key].numpy(), err_msg=key)


@pytest.mark.parametrize("split", ["train", "val"])
def test_fake_loader_batches_equal_jax_across_an_epoch(split):
    """256 samples a epoch at batch 8: batches 30-33 cross into epoch 2
    (train shuffles per epoch; val does not)."""
    jcfg, pcfg = jax_config.get_config("debug"), port_config.get_config("debug")
    jit, pit = iter(_seeded_jax_loader(jcfg, split)), iter(port_loader.create_data_loader(pcfg, split=split))
    dropped = 0
    try:
        for index in range(34):
            jb, pb = next(jit), next(pit)
            if index >= 28 or index < 2:
                _assert_batches_equal(jb, pb)
            dropped += int((~pb[0].image_masks["left_wrist_0_rgb"]).sum())
    finally:
        jit.close()
        pit.close()
    assert dropped > 0  # the wrist dropout drew from the seeded globals


def test_resumed_fake_loader_continues_the_jax_stream():
    """A port loader resumed at batch 30 gives the JAX loader's batches 30-32."""
    jcfg, pcfg = jax_config.get_config("debug"), port_config.get_config("debug")
    jl = _seeded_jax_loader(jcfg, batches_seen=30)
    pl = port_loader.create_data_loader(pcfg)
    pl.load_state_dict({"batches_seen": 30, "seed": 0})
    jit, pit = iter(jl), iter(pl)
    try:
        for _ in range(3):
            _assert_batches_equal(next(jit), next(pit))
    finally:
        jit.close()
        pit.close()
    assert pl.state_dict() == {"batches_seen": 33, "seed": 0}


# ---------------------------------------------------------------------------
# The cases of tests/test_resume.py:55-100
# ---------------------------------------------------------------------------


def _sample(i: int) -> dict:
    rng = np.random.default_rng(i)
    return {
        "image": {"cam": rng.integers(0, 255, (8, 8, 3), np.uint8)},
        "image_mask": {"cam": np.True_},
        "state": np.full(4, float(i), np.float32),
        "actions": rng.uniform(-1, 1, (2, 4)).astype(np.float32),
    }


class _Indexable:
    def __len__(self):
        return 64

    def __getitem__(self, i):
        return _sample(i)


class _Iterable:
    """A deterministic infinite stream (stand-in for the RLDS mixture)."""

    def __iter__(self):
        i = 0
        while True:
            yield _sample(i)
            i += 1


def _states(loader, n):
    it = iter(loader)
    out = [next(it)[0].state.numpy() for _ in range(n)]
    it.close()
    return out


@pytest.mark.parametrize("dataset", [_Indexable(), _Iterable()], ids=["indexable", "iterable"])
def test_exact_resume(dataset):
    kw = dict(dataset=dataset, transforms=[], batch_size=4, seed=3)
    reference = _states(port_loader.TransformedDataLoader(**kw), 12)
    jax_reference = [np.asarray(o.state) for o, _ in _jax_batches(jax_loader.TransformedDataLoader(**kw), 12)]
    for a, b in zip(reference, jax_reference, strict=True):
        np.testing.assert_array_equal(a, b)

    first = port_loader.TransformedDataLoader(**kw)
    _states(first, 5)
    saved = first.state_dict()
    assert saved["batches_seen"] == 5
    resumed = port_loader.TransformedDataLoader(**kw)
    resumed.load_state_dict(saved)
    for a, b in zip(reference[5:], _states(resumed, 7), strict=True):
        np.testing.assert_array_equal(a, b)


def _jax_batches(loader, n):
    it = iter(loader)
    out = [next(it) for _ in range(n)]
    it.close()
    return out


def test_exact_resume_across_epochs():
    # 64 samples / batch 4 = 16 batches an epoch; resume mid-second-epoch.
    kw = dict(dataset=_Indexable(), transforms=[], batch_size=4, seed=7)
    reference = _states(port_loader.TransformedDataLoader(**kw), 24)
    resumed = port_loader.TransformedDataLoader(**kw)
    resumed.load_state_dict({"batches_seen": 20})
    for a, b in zip(reference[20:], _states(resumed, 4), strict=True):
        np.testing.assert_array_equal(a, b)
    jax_resumed = jax_loader.TransformedDataLoader(**kw)
    jax_resumed.load_state_dict({"batches_seen": 20})
    for a, (obs, _) in zip(reference[20:], _jax_batches(jax_resumed, 4), strict=True):
        np.testing.assert_array_equal(a, np.asarray(obs.state))


def test_a_producer_error_reaches_the_consumer():
    """The producer reads 32 samples ahead (8 threads x 4): sample 40 is read
    once batches 0 and 1 are queued, and its error follows them."""

    class Broken(_Indexable):
        def __getitem__(self, i):
            if i == 40:
                raise KeyError("sample 40 is broken")
            return _sample(i)

    loader = port_loader.TransformedDataLoader(dataset=Broken(), transforms=[], batch_size=4, shuffle=False)
    it = iter(loader)
    next(it), next(it)
    with pytest.raises(KeyError, match="sample 40 is broken"):
        next(it)
    assert loader.state_dict()["batches_seen"] == 2


def test_a_transform_error_reaches_the_consumer():
    def fail(sample):
        raise ValueError("bad transform")

    it = iter(port_loader.TransformedDataLoader(dataset=_Indexable(), transforms=[fail], batch_size=4))
    with pytest.raises(ValueError, match="bad transform"):
        next(it)


def test_a_finite_iterable_ends_the_iterator():
    class Finite:
        def __iter__(self):
            return (_sample(i) for i in range(10))

    loader = port_loader.TransformedDataLoader(dataset=Finite(), transforms=[], batch_size=4, drop_remainder=False)
    assert [len(o.state) for o, _ in loader] == [4, 4, 2]


@pytest.fixture(scope="module")
def written_mixtures(tmp_path_factory):
    """The 16 members of ``oxe_magic_soup`` and the four of
    ``libero_finetune``, three fabricated episodes each
    (``tests/test_transforms_oxe.py``), written as RLDS directories."""
    import test_transforms_oxe as tto
    from lap_tpu.data import mixtures, rlds

    root = tmp_path_factory.mktemp("mixtures")
    alias = {"bridge_v2_oxe": "bridge_dataset", "libero_goal_no_noops": "libero_spatial_no_noops",
             "libero_object_no_noops": "libero_spatial_no_noops", "libero_10_no_noops": "libero_spatial_no_noops"}
    for mix in ("oxe_magic_soup", "libero_finetune"):
        for name, _ in mixtures.OXE_NAMED_MIXTURES[mix]:
            rlds.write_rlds_dataset(root, name, [tto.FABRICATORS[alias.get(name, name)]() for _ in range(3)])
    return root


@pytest.mark.parametrize("name", [c.name for c in port_config._CONFIGS])
def test_named_config_loader_builds_on_a_written_mixture(name, written_mixtures):
    """Every named config's data settings build a loader (``fake``, or the
    RLDS mixture with its norm stats and the frame decoder); none raises."""
    cfg = port_config.get_config(name)
    cfg = dataclasses.replace(cfg, batch_size=2, data=dataclasses.replace(
        cfg.data, rlds_data_dir=str(written_mixtures), shuffle_buffer_size=16))
    loader = port_loader.create_data_loader(cfg)
    if cfg.data.repo_id == "fake":
        assert loader.norm_stats is None and not loader.unseeded_transforms
        return
    assert {"actions", "state"} <= set(loader.norm_stats)
    assert loader.norm_stats["actions"].mean.shape == (cfg.model.action_dim,)
    assert len(loader.unseeded_transforms) == 1 and loader.batch_size == 2


def test_loader_copies_uint8_batches_to_the_device():
    cfg = dataclasses.replace(port_config.get_config("debug"), batch_size=2)
    it = iter(port_loader.create_data_loader(cfg, device="cpu"))
    obs, actions = next(it)
    it.close()
    assert obs.images["base_0_rgb"].dtype == torch.uint8 and obs.images["base_0_rgb"].shape == (2, 56, 56, 3)
    assert actions.shape == (2, 4, 7) and actions.dtype == torch.float32
    assert obs.tokenized_prompt.shape == (2, 160)
