"""One data stream per data rank, against lap_tpu's multi-process data path.

- The loader's per-rank split (``lap_tpu/data/loader.py:121-130``): the
  ``fake`` loader of the ``debug`` config at a global batch of 8 over 2 data
  ranks, each rank's batches against JAX's ``create_data_loader`` with
  ``jax.process_index``/``process_count`` patched to that rank (one thread,
  the global RNGs seeded around each sample from its position in the global
  stream, as the port seeds them), bit for bit; and the two ranks' batches
  of a step together are one process's batch of 8, rows ``r::2`` each.
- The stats pass's cross-host merge (``lap_tpu/data/mixer.py:240-254``): two
  LIBERO members (four fabricated episodes each, perturbed per episode)
  written as RLDS directories; the port's stats pass in a gloo world of 2
  CPU processes (``run_world``, 180 s join timeout), each rank reading its
  episode shard, against JAX's pass run once per shard with the process
  index and count patched and ``gather_host_json`` handing it both shards'
  stats, then ``merge_norm_stats``. Within 1e-12 (f64 moments, merged in the
  same order).
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.data import loader as jax_loader  # noqa: E402
from lap_tpu.data import mixer as jax_mixer  # noqa: E402
from lap_tpu.data import rlds as jax_rlds  # noqa: E402
from lap_tpu.training import array_utils as jax_array_utils  # noqa: E402
from lap_tpu.training import config as jax_config  # noqa: E402
from lap_tpu_torch.data import loader as port_loader  # noqa: E402
from lap_tpu_torch.training import config as port_config  # noqa: E402
from test_torch_loader import _assert_batches_equal  # noqa: E402
from torch_dist_helpers import run_world  # noqa: E402
from torch_port_helpers import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

GLOBAL_BATCH, RANKS, STEPS = 8, 2, 3
MEMBERS = [("libero_spatial_no_noops", 1.0), ("libero_goal_no_noops", 1.0)]


def _seeded_jax_loader(config, rank: int, count: int):
    """The JAX loader of data rank ``rank`` of ``count``, one thread, the
    global RNGs seeded around each sample from its global position."""
    loader = jax_loader.create_data_loader(config, None, split="train")
    loader.num_threads = 1
    position = [0]
    transform = loader._transform

    def seeded(sample):
        with port_loader._GLOBAL_RNG_LOCK:
            port_loader.seed_global_rngs(port_loader.sample_seed(loader.seed, position[0] * count + rank))
            position[0] += 1
            return transform(sample)

    loader._transform = seeded
    return loader


def _batches(loader, n):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


@pytest.mark.parametrize("rank", range(RANKS))
def test_each_rank_loads_jaxs_per_process_slice(rank, monkeypatch):
    jcfg = dataclasses.replace(jax_config.get_config("debug"), batch_size=GLOBAL_BATCH)
    pcfg = dataclasses.replace(port_config.get_config("debug"), batch_size=GLOBAL_BATCH)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: RANKS)
    monkeypatch.setattr(port_loader, "process_placement", lambda: (rank, RANKS))
    jl = _seeded_jax_loader(jcfg, rank, RANKS)
    pl = port_loader.create_data_loader(pcfg)
    assert pl.batch_size == jl.batch_size == GLOBAL_BATCH // RANKS
    assert np.array_equal(pl._sample_indices(1), jl._sample_indices(1))
    for jb, pb in zip(_batches(jl, STEPS), _batches(pl, STEPS), strict=True):
        _assert_batches_equal(jb, pb)


def test_the_ranks_batches_of_a_step_are_one_processs_batch(monkeypatch):
    pcfg = dataclasses.replace(port_config.get_config("debug"), batch_size=GLOBAL_BATCH)
    whole = _batches(port_loader.create_data_loader(pcfg), STEPS)
    for rank in range(RANKS):
        monkeypatch.setattr(port_loader, "process_placement", lambda r=rank: (r, RANKS))
        for (obs, actions), (wobs, wactions) in zip(_batches(port_loader.create_data_loader(pcfg), STEPS), whole,
                                                      strict=True):
            rows = slice(rank, None, RANKS)
            assert torch.equal(actions, wactions[rows])
            assert torch.equal(obs.tokenized_prompt, wobs.tokenized_prompt[rows])
            for key in obs.images:
                assert torch.equal(obs.images[key], wobs.images[key][rows])
                assert torch.equal(obs.image_masks[key], wobs.image_masks[key][rows])


@pytest.fixture(scope="module")
def rlds_dir(tmp_path_factory):
    import test_transforms_oxe as tto

    root = tmp_path_factory.mktemp("rlds")
    for k, (name, _) in enumerate(MEMBERS):
        episodes = []
        for i in range(4):
            ep = tto.FABRICATORS["libero_spatial_no_noops"]()
            rng = np.random.default_rng(10 * k + i)
            steps = ep["steps"]
            steps["action"] = (steps["action"] + rng.normal(0, 0.3, steps["action"].shape)).astype(np.float32)
            obs = steps["observation"]
            obs["state"] = (obs["state"] + rng.normal(0, 0.3, obs["state"].shape)).astype(np.float32)
            episodes.append(ep)
        jax_rlds.write_rlds_dataset(root, name, episodes)
    return root


def _configs(root):
    kw = dict(rlds_data_dir=str(root), shuffle_buffer_size=16)
    jcfg = jax_config.get_config("lap_libero")
    pcfg = port_config.get_config("lap_libero")
    return (dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, **kw)),
            dataclasses.replace(pcfg, data=dataclasses.replace(pcfg.data, **kw)))


def test_merged_stats_of_the_data_ranks_match_jax(rlds_dir, monkeypatch):
    jcfg, pcfg = _configs(rlds_dir)
    ranks = run_world(RANKS, "torch_dist_workers:mixture_stats", pcfg, MEMBERS)
    # JAX, one shard at a time: capture each shard's own stats...
    shards = []

    def capture(obj):
        shards.append(obj)
        return [obj]

    monkeypatch.setattr(jax, "process_count", lambda: RANKS)
    monkeypatch.setattr(jax_array_utils, "gather_host_json", capture)
    for rank in range(RANKS):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        jax_mixer.compute_mixture_norm_stats(jcfg, MEMBERS)
    # ...then the pass of shard 0 with both shards' stats gathered, per member.
    per_member = {k: [shards[k], shards[len(MEMBERS) + k]] for k in range(len(MEMBERS))}
    calls = iter(range(len(MEMBERS)))
    monkeypatch.setattr(jax_array_utils, "gather_host_json", lambda obj: per_member[next(calls)])
    monkeypatch.setattr(jax, "process_index", lambda: 0)
    ref_stats, ref_transitions = jax_mixer.compute_mixture_norm_stats(jcfg, MEMBERS)
    assert all(len(s["actions"]["mean"]) for s in shards)  # every shard read episodes
    for stats, transitions in ranks:
        assert transitions == ref_transitions
        assert set(stats) == set(ref_stats)
        for key, ref in ref_stats.items():
            for field, value in ref.to_dict().items():
                np.testing.assert_allclose(np.asarray(stats[key][field]), np.asarray(value), rtol=1e-12, atol=0,
                                           err_msg=f"{key}.{field}")
    assert ranks[0][0] == ranks[1][0]
