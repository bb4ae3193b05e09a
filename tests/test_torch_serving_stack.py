"""The port's serving stack against lap_tpu on the CPU: a checkpoint
directory, ``create_trained_policy``/``create_trained_policy_ar``, raw
robot requests through the transforms, the model and the output stack, the
recorder and the batcher.

The JAX debug-config model (dummy widths, f32) gets randomised parameters
(embedding table at 10x spread, so greedy AR tokens have no near-ties); the
port's checkpoint is written from them through the weight bridge and
``save_params``, with norm stats in ``assets/fake/norm_stats.json``. The
JAX policy is built from its own ``_build_transform_stacks`` and the same
parameters in memory. Flow noise cannot match (``fold_in`` against a
``torch.Generator``), so flow parity goes in three steps: ``_prepare``
exactly; the model on the stacked batch with explicit noise, within 2e-5
(atol and rtol, f32 sums in another order); ``_output`` exactly on the same
raw model output. AR: greedy tokens and the parsed language actions exactly,
end to end through ``infer``. Both global RNGs are seeded identically before
each side's call (the ``lap``-style data config drops the wrist camera with
probability 0.1). The batcher's rows against one request at a time, at
explicit noise: 2e-5 (atol and rtol, the batch-2 products sum in another
order).
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.models import lora as jax_lora  # noqa: E402
from lap_tpu.models.types import CoTObservation as JaxObservation  # noqa: E402
from lap_tpu.policies import model_transforms as jax_mt  # noqa: E402
from lap_tpu.policies import policy as jax_policy  # noqa: E402
from lap_tpu.policies import policy_config as jax_policy_config  # noqa: E402
from lap_tpu.training import config as jax_config  # noqa: E402
from lap_tpu_torch.models import convert, lora  # noqa: E402
from lap_tpu_torch.models.lap_model import LAP  # noqa: E402
from lap_tpu_torch.models.types import CoTObservation  # noqa: E402
from lap_tpu_torch.policies import model_transforms as mt  # noqa: E402
from lap_tpu_torch.policies import policy as port_policy  # noqa: E402
from lap_tpu_torch.policies import policy_config  # noqa: E402
from lap_tpu_torch.policies.batching import BatchingPolicy  # noqa: E402
from lap_tpu_torch.training import checkpoints, config  # noqa: E402
from test_torch_transforms import assert_tree_equal, norm_stats, raw_observation, seeded  # noqa: E402
from torch_port_helpers import TORCH_THREADS, private_jax_native, randomize_params  # noqa: E402

torch.set_num_threads(TORCH_THREADS)
CONFIG = "debug"
TOL = 2e-5
AR_STEPS = 8
N_REQUESTS = 8


TRAINING_KEYS = ("actions", "language_actions", "raw_state", "dataset_name", "has_wrist_image", "is_prediction_sample")


def robot_request(i: int) -> dict:
    """What a robot sends: the cameras, the state and (but for request 1) a
    prompt; request 2 has no wrist camera, request 3 an all-zero base image."""
    obs = raw_observation(i)
    for key in TRAINING_KEYS:
        obs.pop(key, None)
    return obs


@pytest.fixture(scope="module", autouse=True)
def jax_native_in_a_private_dir(tmp_path_factory):
    restore = private_jax_native(tmp_path_factory.mktemp("jax_native"))
    yield
    restore()


def write_checkpoint(path, params, *, asset_id="fake"):
    """A port checkpoint directory from a JAX params tree."""
    model = LAP(config.get_config(CONFIG).model, device="cpu", init_seed=None)
    convert.load_jax_params(model, params)
    checkpoints.save_params(model, path / "params")
    checkpoints.save_norm_stats(path / "assets" / asset_id / "norm_stats.json", norm_stats(mt))
    return model


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = jax_config.get_config(CONFIG)
    module = jcfg.model.create_module()
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=module.init_params_fn))
    params = randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 81)
    params["llm"]["embedder"]["input_embedding"] *= 10.0
    ckpt = tmp_path_factory.mktemp("ckpt")
    in_memory = write_checkpoint(ckpt, params)
    return dict(module=module, params=params, ckpt=ckpt, in_memory=in_memory)


def jax_policy_for(setup, *, ar: bool):
    inputs, outputs = jax_policy_config._build_transform_stacks(
        jax_config.get_config(CONFIG), norm_stats(jax_mt), default_prompt="do something", ar=ar)
    cls = jax_policy.ARPolicy if ar else jax_policy.Policy
    kw = dict(max_decoding_steps=AR_STEPS) if ar else dict(num_steps=10)
    return cls(setup["module"], {"params": setup["params"]}, input_transforms=inputs, output_transforms=outputs, **kw)


@pytest.fixture(scope="module")
def flow(setup):
    port = policy_config.create_trained_policy(
        config.get_config(CONFIG), setup["ckpt"], default_prompt="do something", device="cpu",
        allow_test_vocab=True)
    return port, jax_policy_for(setup, ar=False)


def test_restored_parameters_equal_the_saved_ones(setup, flow):
    port, _ = flow
    restored = dict(port._model.named_parameters())
    saved = dict(setup["in_memory"].named_parameters())
    assert set(restored) == set(saved)
    for name, p in saved.items():
        assert torch.equal(restored[name], p), name
    assert port._model.config.stop_action_to_vlm_grad is False
    assert port.metadata == {"config": CONFIG, "mode": "flow"}


def test_flow_policy_matches_jax_in_three_steps(setup, flow):
    port, ref = flow
    prepared, ref_prepared = [], []
    for i in range(N_REQUESTS):
        got, want = seeded(i, port._prepare, robot_request(i)), seeded(i, ref._prepare, robot_request(i))
        assert_tree_equal(got, want, f"request {i}")
        prepared.append(got)
        ref_prepared.append(want)
    assert any(not p["image"]["left_wrist_0_rgb"].any() for p in prepared)

    batch = port_policy._stack_batch(prepared)
    assert_tree_equal(batch, jax_policy._stack_batch(ref_prepared))
    noise = np.random.default_rng(82).standard_normal((N_REQUESTS, 4, 7)).astype(np.float32)
    got = port._model.sample_actions(CoTObservation.from_dict(batch, device="cpu"), noise=torch.from_numpy(noise))
    module = setup["module"]
    want = jax.jit(lambda p, o, n: module.apply(p, jax.random.PRNGKey(0), o, noise=n, method=module.sample_actions))(
        {"params": setup["params"]}, JaxObservation.from_dict(batch), jnp.asarray(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)

    actions = got.numpy()
    for i in range(N_REQUESTS):
        row = {"state": batch["state"][i], "actions": actions[i]}
        out = port._output(dict(row))
        assert_tree_equal(out, ref._output(dict(row)))
        assert not np.allclose(out["actions"], actions[i])  # Unnormalize moved them into physical units


def test_flow_infer_returns_a_chunk_in_physical_units(flow):
    port, _ = flow
    out = port.infer(robot_request(2))
    assert out["actions"].shape == (4, 7) and np.isfinite(out["actions"]).all()
    assert out["policy_timing"]["infer_ms"] > 0


@pytest.fixture(scope="module")
def ar(setup):
    port = policy_config.create_trained_policy_ar(
        config.get_config(CONFIG), setup["ckpt"], default_prompt="do something", device="cpu",
        allow_test_vocab=True, max_decoding_steps=AR_STEPS)
    return port, jax_policy_for(setup, ar=True)


@pytest.mark.parametrize("i", [0, 2, 3])
def test_ar_policy_matches_jax_end_to_end(ar, i):
    """Greedy tokens, then the detokenized reasoning and its parsed actions."""
    port, ref = ar
    prepared = seeded(i, port._prepare, robot_request(i))
    batch = port_policy._stack_batch([prepared])
    tokens = port._model.sample_tokens(CoTObservation.from_dict(batch, device="cpu"), max_decoding_steps=AR_STEPS)
    module = ref._model
    want_tokens = jax.jit(lambda p, o: module.apply(p, jax.random.PRNGKey(0), o, max_decoding_steps=AR_STEPS,
                                                    method=module.sample_tokens))(
        ref._params, JaxObservation.from_dict(batch))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    got, want = seeded(i, port.infer, robot_request(i)), seeded(i, ref.infer, robot_request(i))
    del got["policy_timing"], want["policy_timing"]
    assert_tree_equal(got, want)
    assert isinstance(got["reasoning"], str) and np.isfinite(got["actions"]).all()


def test_int8_restore_equals_quantize_on_the_in_memory_model(setup, monkeypatch):
    monkeypatch.setattr(lora, "QUANT_MIN_WEIGHT_ELEMS", 4096)
    monkeypatch.setattr(jax_lora, "QUANT_MIN_WEIGHT_ELEMS", 4096)
    port = policy_config.create_trained_policy(
        config.get_config(CONFIG), setup["ckpt"], device="cpu", allow_test_vocab=True, quantize="int8")
    reference = write_checkpoint(setup["ckpt"].parent / "int8_reference", setup["params"])
    reference.quantize_("int8")
    got, want = port._model.state_dict(), reference.state_dict()
    assert set(got) == set(want) and any(k.endswith("w_i8") for k in got)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_tokenizer_guard_refuses_before_any_restore(tmp_path):
    """No params file here: the guard must raise before the restore would."""
    checkpoints.save_norm_stats(tmp_path / "assets" / "fake" / "norm_stats.json", norm_stats(mt))
    for create in (policy_config.create_trained_policy, policy_config.create_trained_policy_ar):
        with pytest.raises(RuntimeError, match="TEST tokenizer"):
            create(config.get_config(CONFIG), tmp_path, device="cpu")
    with pytest.raises(FileNotFoundError, match="export_jax_params"):
        policy_config.create_trained_policy(config.get_config(CONFIG), tmp_path, device="cpu", allow_test_vocab=True)


def test_refusals_of_what_is_not_ported(setup):
    cfg = config.get_config(CONFIG)
    # Tensor-parallel serving runs inside a process group of tp ranks; outside one it refuses.
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        policy_config.create_trained_policy(cfg, setup["ckpt"], device="cpu", allow_test_vocab=True, tp=2)
    with pytest.raises(ValueError, match="single-card"):
        policy_config.create_trained_policy_ar(cfg, setup["ckpt"], device="cpu", allow_test_vocab=True, tp=2,
                                               quantize="int8")
    with pytest.raises(NotImplementedError, match="item 21"):
        policy_config.create_trained_policy(cfg, "gs://bucket/ckpt", device="cpu", allow_test_vocab=True)
    # The FAST action tokens are ported: the same checkpoint serves through the FAST transforms.
    fast = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_fast=True))
    served = policy_config.create_trained_policy(fast, setup["ckpt"], device="cpu", allow_test_vocab=True)
    assert np.isfinite(served.infer(robot_request(0))["actions"]).all()
    # What stays refused: a VLM-only model (no action expert) behind the flow Policy.
    vlm_only = dataclasses.replace(cfg.model, enable_action_training=False)
    with pytest.raises(ValueError, match="VLM-only"):
        port_policy.Policy(vlm_only.create_module(device="cpu", init_seed=0))


def test_norm_stats_files_are_shared_with_the_jax_package(tmp_path):
    from lap_tpu.training import checkpoints as jax_checkpoints

    checkpoints.save_norm_stats(tmp_path / "oxe" / "norm_stats.json", norm_stats(mt), extra={"note": 1})
    got, want = checkpoints.load_norm_stats(tmp_path, "oxe"), jax_checkpoints.load_norm_stats(tmp_path, "oxe")
    assert_tree_equal({k: v.to_dict() for k, v in got.items()}, {k: v.to_dict() for k, v in want.items()})
    assert checkpoints.load_norm_stats(tmp_path, "missing") is None


def test_policy_recorder_round_trip(flow, tmp_path):
    port, _ = flow
    recorder = port_policy.PolicyRecorder(port, str(tmp_path))
    request = robot_request(0)
    request["observation/flat_key"] = np.arange(3)  # a '/' inside a key survives
    result = recorder.infer(request)
    flat = dict(np.load(tmp_path / "step_000000.npz"))
    obs = port_policy.unflatten_record(flat, "obs")
    for key in ("obs", "out"):
        assert_tree_equal(port_policy.unflatten_record(flat, key), jax_policy.unflatten_record(flat, key))
    np.testing.assert_array_equal(obs["observation"]["base_0_rgb"], request["observation"]["base_0_rgb"])
    np.testing.assert_array_equal(obs["observation/flat_key"], np.arange(3))
    assert str(obs["prompt"]) == request["prompt"]
    np.testing.assert_array_equal(obs["observation"]["state"], request["observation"]["state"])
    assert set(obs) == set(request) and set(obs["observation"]) == set(request["observation"])
    np.testing.assert_array_equal(port_policy.unflatten_record(flat, "out")["actions"], result["actions"])
    recorder.infer(robot_request(1))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000000.npz", "step_000001.npz"]


def test_batching_policy_rows_match_one_request_at_a_time(flow, monkeypatch):
    """Two threads at once make one batch-2 model call; each row equals its
    request run alone, at the same explicit noise per row."""
    port, _ = flow
    noise = torch.from_numpy(np.random.default_rng(83).standard_normal((1, 4, 7)).astype(np.float32))
    calls = []

    def sample(observation, generator):
        b = observation.state.shape[0]
        calls.append(b)
        return port._model.sample_actions(observation, noise=noise.expand(b, -1, -1))

    monkeypatch.setattr(port, "_sample", sample)
    # The clients' transforms run on their own threads: no wrist dropout, so
    # the global RNG's order of draws does not matter.
    monkeypatch.setattr(np.random, "rand", lambda *a: 0.5)
    requests = [robot_request(7), robot_request(9)]
    alone = [seeded(0, port.infer, r)["actions"] for r in requests]
    assert calls == [1, 1]
    batcher = BatchingPolicy(port, max_batch=2, window_ms=2000.0)
    results = [None, None]
    barrier = threading.Barrier(2)

    def client(i):
        barrier.wait()
        results[i] = batcher.infer(requests[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    batcher.close()
    assert calls == [1, 1, 2]
    assert batcher.stats == {"requests": 2, "batches": 1, "largest_batch": 2}
    for got, want in zip(results, alone, strict=True):
        assert got["policy_timing"]["batch_size"] == 2
        np.testing.assert_allclose(got["actions"], want, atol=TOL, rtol=TOL)


def test_batching_policy_runs_as_many_rows_as_requests():
    """Three robots at once behind ``max_batch=8``: one model call of three
    rows (no padding up to a bucket), each result its own row's."""

    class Rows:
        metadata = {}

        def __init__(self):
            self.calls = []

        def _prepare(self, obs):
            return {"x": np.asarray(obs["x"], np.float32)}

        def _infer_prepared(self, inputs_list):
            self.calls.append(len(inputs_list))
            return [{"y": inputs["x"] * 2} for inputs in inputs_list]

    inner = Rows()
    batcher = BatchingPolicy(inner, max_batch=8, window_ms=2000.0)
    results = [None] * 3
    barrier = threading.Barrier(3)

    def client(i):
        barrier.wait()
        results[i] = batcher.infer({"x": [i]})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    batcher.close()
    assert inner.calls == [3]
    assert batcher.stats == {"requests": 3, "batches": 1, "largest_batch": 3}
    for i, result in enumerate(results):
        np.testing.assert_array_equal(result["y"], [2.0 * i])
        assert result["policy_timing"]["batch_size"] == 3


def test_batching_signature_groups_like_shaped_requests():
    from lap_tpu.policies import batching as jax_batching
    from lap_tpu_torch.policies import batching

    a = {"image": {"x": np.zeros((2, 2))}, "prompt": np.asarray("abc"), "none": None, "n": 3}
    b = {"image": {"x": np.ones((2, 2))}, "prompt": np.asarray("a longer prompt"), "none": None, "n": 4}
    c = {"image": {"x": np.ones((3, 2))}, "prompt": np.asarray("abc"), "none": None, "n": 3}
    sig = batching._signature
    assert sig(a) == sig(b) != sig(c)
    assert (jax_batching._signature(a) == jax_batching._signature(b)) and (
        jax_batching._signature(a) != jax_batching._signature(c))
    assert sig(a)[1] == jax_batching._signature(a)[1]
