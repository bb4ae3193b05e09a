"""Tensor-parallel serving (``create_trained_policy(..., tp=2)``) on a gloo
world of 2 CPU processes, against the same checkpoint served by one process
(the cases of ``tests/test_sharded_serving.py``).

The ``debug`` config (dummy widths, 8 query heads on 1 KV head, f32) is
saved with numpy-seeded parameters (the embedding table at 10x spread, so
greedy AR tokens have no near-ties) and norm stats; the requests are the
raw robot observations of ``test_torch_transforms.py``, with numpy's and
Python's global RNGs seeded alike before each call on both sides. One world
(``run_world``, 180 s join timeout) serves, on rank 0 with rank 1
following: flow requests, a batched call of two prepared requests and two
concurrent requests behind ``BatchingPolicy``, the same requests through the
token bucket, greedy AR; then LAPGemma3's flow sampling (gemma3_dummy, 4
query heads on 2 KV heads: tp splits the KV heads) from its whole weights.

Tolerances: actions within 2e-5 (atol and rtol: the tp partial sums add in
another order; f32), AR tokens and the detokenized outputs exactly. ``tp > 1`` with ``quantize`` raises
before any process group is needed, as in JAX.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.models.lap_model import LAPConfig as JaxLAPConfig  # noqa: E402
from lap_tpu_torch.models import convert  # noqa: E402
from lap_tpu_torch.models.lap_model import LAP, LAPConfig  # noqa: E402
from lap_tpu_torch.policies import model_transforms as mt  # noqa: E402
from lap_tpu_torch.policies import policy_config  # noqa: E402
from lap_tpu_torch.training import checkpoints, config  # noqa: E402
from test_torch_transforms import assert_tree_equal, norm_stats, raw_observation  # noqa: E402
from torch_dist_helpers import run_world  # noqa: E402
from torch_dist_workers import _ar_outputs, _seeded  # noqa: E402
from torch_port_helpers import TORCH_THREADS, randomize_params, train_obs_arrays  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

TOL = dict(atol=2e-5, rtol=2e-5)
N_REQUESTS, AR_STEPS, BUCKET = 4, 6, 32
G3_KW = dict(dtype="float32", paligemma_variant="gemma3_dummy", action_expert_variant="gemma3_dummy",
             siglip_variant="dummy", action_dim=7, action_horizon=4, max_token_len=48, image_resolution=(56, 56),
             enable_action_training=True)
TRAINING_KEYS = ("actions", "language_actions", "raw_state", "dataset_name", "has_wrist_image", "is_prediction_sample")


def robot_request(i: int) -> dict:
    obs = raw_observation(i)
    for key in TRAINING_KEYS:
        obs.pop(key, None)
    return obs


def _random_port_params(kw, seed, scale_embedding=1.0):
    model = JaxLAPConfig(**kw).create_module()
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=model.init_params_fn))
    params = randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), seed)
    params["llm"]["embedder"]["input_embedding"] *= scale_embedding
    return params


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("tp_ckpt")
    cfg = config.get_config("debug")
    params = _random_port_params(dict(jax_config_kwargs()), 81, scale_embedding=10.0)
    model = convert.load_jax_params(LAP(cfg.model, device="cpu", init_seed=None), params)
    checkpoints.save_params(model, ckpt / "params")
    checkpoints.save_norm_stats(ckpt / "assets" / "fake" / "norm_stats.json", norm_stats(mt))
    requests = [robot_request(i) for i in range(N_REQUESTS)]
    g3_model = convert.load_jax_params(LAPConfig(**G3_KW).create_module(device="cpu", init_seed=None),
                                       _random_port_params(G3_KW, 95))
    g3_weights = {n: p.detach().numpy().copy() for n, p in g3_model.named_parameters()}
    g3_arrays = train_obs_arrays(96, batch=2, valid=[40, 31], cfg_kw=G3_KW)
    g3_noise = np.random.default_rng(97).standard_normal((2, 4, 7)).astype(np.float32)
    jobs = [("serving_cases", (ckpt, requests, BUCKET, AR_STEPS)),
            ("gemma3_flow", (G3_KW, g3_weights, g3_arrays, g3_noise, 3))]
    ranks = run_world(2, "torch_dist_workers:run_jobs", jobs)
    return dict(ckpt=ckpt, requests=requests, tp=ranks[0][0], followed=ranks[1][0], g3_tp=ranks[0][1],
                g3_model=g3_model, g3_arrays=g3_arrays, g3_noise=g3_noise)


def jax_config_kwargs():
    """The JAX model config of ``debug``, as keyword arguments."""
    import dataclasses

    from lap_tpu.training import config as jax_config

    jcfg = jax_config.get_config("debug").model
    return {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}


def _policy(setup, **kw):
    return policy_config.create_trained_policy(config.get_config("debug"), setup["ckpt"], default_prompt="do something",
                                               device="cpu", allow_test_vocab=True, **kw)


def test_flow_requests_match_one_process(setup):
    single = _policy(setup)
    for i, request in enumerate(setup["requests"]):
        ref = _seeded(lambda r=request: single.infer(r)["actions"], i)
        np.testing.assert_allclose(setup["tp"]["flow"][i], ref, **TOL, err_msg=str(i))


def test_batched_calls_match_one_process(setup):
    """The batched call of two prepared requests, and two concurrent
    requests behind ``BatchingPolicy`` (one model call of two rows)."""
    single = _policy(setup)
    prepared = [_seeded(lambda r=r: single._prepare(r), i) for i, r in enumerate(setup["requests"][:2])]
    # The tp policy's batched call was its 5th model call (after 4 requests).
    single._step = N_REQUESTS
    for got, ref in zip(setup["tp"]["batched"], single._infer_prepared(prepared), strict=True):
        np.testing.assert_allclose(got, ref["actions"], **TOL)
    batcher = setup["tp"]["batcher"]
    assert batcher["stats"] == {"requests": 2, "batches": 1, "largest_batch": 2}
    assert all(np.isfinite(r).all() and r.shape == (4, 7) for r in batcher["results"])
    # The follower ran every model call of the flow policy: 4 requests, the
    # batched call and the batcher's one.
    assert setup["followed"][0] == N_REQUESTS + 2


def test_token_bucket_matches_one_process(setup):
    single = _policy(setup, token_bucket=BUCKET)
    for i, request in enumerate(setup["requests"]):
        ref = _seeded(lambda r=request: single.infer(r)["actions"], i)
        np.testing.assert_allclose(setup["tp"]["bucket"][i], ref, **TOL, err_msg=str(i))
    assert setup["followed"][1] == N_REQUESTS


def test_greedy_ar_tokens_equal_one_process(setup):
    single = policy_config.create_trained_policy_ar(
        config.get_config("debug"), setup["ckpt"], default_prompt="do something", device="cpu",
        allow_test_vocab=True, max_decoding_steps=AR_STEPS)
    outs, tokens = _ar_outputs(single, setup["requests"])
    for i in range(N_REQUESTS):
        np.testing.assert_array_equal(setup["tp"]["ar_tokens"][i], tokens[i], err_msg=str(i))
        assert_tree_equal(setup["tp"]["ar"][i], outs[i])
    assert isinstance(outs[0]["reasoning"], str)
    assert setup["followed"][2] == N_REQUESTS


def test_gemma3_flow_with_kv_heads_split_matches_one_process(setup):
    from torch_port_helpers import port_observation

    ref = setup["g3_model"].sample_actions(port_observation(setup["g3_arrays"]), num_steps=3,
                                           noise=torch.from_numpy(setup["g3_noise"]))
    np.testing.assert_allclose(setup["g3_tp"], ref.numpy(), **TOL)


def test_tp_with_quantize_raises_as_in_jax(setup):
    with pytest.raises(ValueError, match="single-card"):
        _policy(setup, tp=2, quantize="int8")
