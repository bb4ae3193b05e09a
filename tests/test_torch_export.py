"""A JAX checkpoint served by the port: ``lap_tpu``'s ``CheckpointManager``
saves a dummy ``TrainState``, ``scripts/export_jax_params.py`` writes its
``params/`` to ``params.npz``, and the port's ``create_trained_policy`` /
``create_trained_policy_ar`` restore that step directory beside the JAX
policies restored from the same checkpoint.

Tolerances: the restored parameters equal the saved ones exactly (f32, and a
bf16 checkpoint through the 2-byte void encoding); the input stacks give the
same batch exactly (both global RNGs seeded alike); the flow model on it at
the same noise within 2e-5 (atol and rtol, f32 sums in another order); greedy
AR tokens exactly.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.models.types import CoTObservation as JaxObservation  # noqa: E402
from lap_tpu.policies import model_transforms as jax_mt  # noqa: E402
from lap_tpu.policies import policy_config as jax_policy_config  # noqa: E402
from lap_tpu.training import config as jax_config  # noqa: E402
from lap_tpu.training.checkpoints import CheckpointManager as JaxCheckpointManager  # noqa: E402
from lap_tpu.training.state import TrainState as JaxTrainState  # noqa: E402
from lap_tpu_torch.models import convert  # noqa: E402
from lap_tpu_torch.models.types import CoTObservation  # noqa: E402
from lap_tpu_torch.policies import policy as port_policy  # noqa: E402
from lap_tpu_torch.policies import policy_config  # noqa: E402
from lap_tpu_torch.training import checkpoints, config  # noqa: E402
from test_torch_serving_stack import robot_request  # noqa: E402
from test_torch_transforms import assert_tree_equal, norm_stats, seeded  # noqa: E402
from torch_port_helpers import TORCH_THREADS, private_jax_native, randomize_params  # noqa: E402

torch.set_num_threads(TORCH_THREADS)
export_jax_params = importlib.import_module("scripts.export_jax_params")
CONFIG = "debug"
TOL = 2e-5
AR_STEPS = 6


@pytest.fixture(scope="module", autouse=True)
def jax_native_in_a_private_dir(tmp_path_factory):
    restore = private_jax_native(tmp_path_factory.mktemp("jax_native"))
    yield
    restore()


def _jax_checkpoint(root, params):
    """A JAX CheckpointManager save of a TrainState at step 3, with norm
    stats beside the assets item (where both packages' policies read them)."""
    mgr = JaxCheckpointManager(root, async_save=False)
    state = JaxTrainState(step=jnp.asarray(3), params=jax.tree.map(jnp.asarray, params),
                          opt_state={"count": jnp.zeros((), jnp.int32)}, ema_params=None)
    mgr.save(3, state, assets={"dataloader_process_0/dataloader_state.json": {"batches_seen": 3, "seed": 0}})
    mgr.wait_until_finished()
    step_dir = root / "3"
    checkpoints.save_norm_stats(step_dir / "assets" / "fake" / "norm_stats.json", norm_stats(jax_mt))
    return step_dir


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    jcfg = jax_config.get_config(CONFIG)
    module = jcfg.model.create_module()
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=module.init_params_fn))
    params = randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 71)
    params["llm"]["embedder"]["input_embedding"] *= 10.0  # no near-ties among greedy AR tokens
    step_dir = _jax_checkpoint(tmp_path_factory.mktemp("jax_ckpt"), params)
    out = export_jax_params.export(step_dir / "params")
    assert out == step_dir / "params" / "params.npz"
    return dict(module=module, params=params, step_dir=step_dir)


def test_export_writes_every_leaf_under_its_jax_path(exported):
    flat = convert.read_params_npz(exported["step_dir"] / "params" / "params.npz")
    want = convert.flatten(exported["params"])
    assert set(flat) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(flat[key], value, err_msg=key)


def test_exported_checkpoint_serves_the_jax_flow_actions(exported):
    port = policy_config.create_trained_policy(config.get_config(CONFIG), exported["step_dir"], device="cpu",
                                               allow_test_vocab=True, default_prompt="do something")
    ref = jax_policy_config.create_trained_policy(jax_config.get_config(CONFIG), exported["step_dir"],
                                                  allow_test_vocab=True, default_prompt="do something")
    restored = dict(port._model.named_parameters())
    for name, value in convert.from_jax_params(exported["params"]).items():
        assert torch.equal(restored[name].detach(), value), name

    prepared = [seeded(i, port._prepare, robot_request(i)) for i in range(4)]
    for i, got in enumerate(prepared):
        assert_tree_equal(got, seeded(i, ref._prepare, robot_request(i)), f"request {i}")
    batch = port_policy._stack_batch(prepared)
    noise = np.random.default_rng(72).standard_normal((4, 4, 7)).astype(np.float32)
    got = port._model.sample_actions(CoTObservation.from_dict(batch, device="cpu"), noise=torch.from_numpy(noise))
    module = ref._model
    want = jax.jit(lambda p, o, n: module.apply(p, jax.random.PRNGKey(0), o, noise=n, method=module.sample_actions))(
        ref._params, JaxObservation.from_dict(batch), jnp.asarray(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    row = {"state": batch["state"][0], "actions": got.numpy()[0]}
    assert_tree_equal(port._output(dict(row)), ref._output(dict(row)))


def test_exported_checkpoint_serves_the_jax_ar_tokens(exported):
    port = policy_config.create_trained_policy_ar(config.get_config(CONFIG), exported["step_dir"], device="cpu",
                                                  allow_test_vocab=True, max_decoding_steps=AR_STEPS)
    ref = jax_policy_config.create_trained_policy_ar(jax_config.get_config(CONFIG), exported["step_dir"],
                                                     allow_test_vocab=True, max_decoding_steps=AR_STEPS)
    batch = port_policy._stack_batch([seeded(0, port._prepare, robot_request(0))])
    tokens = port._model.sample_tokens(CoTObservation.from_dict(batch, device="cpu"), max_decoding_steps=AR_STEPS)
    module = ref._model
    want = jax.jit(lambda p, o: module.apply(p, jax.random.PRNGKey(0), o, max_decoding_steps=AR_STEPS,
                                             method=module.sample_tokens))(ref._params, JaxObservation.from_dict(batch))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want))


def test_bf16_export_round_trips_through_the_void_encoding(exported, tmp_path):
    bf16 = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), exported["params"])
    step_dir = _jax_checkpoint(tmp_path / "ck", bf16)
    export_jax_params.export(step_dir / "params")
    flat = convert.read_params_npz(step_dir / "params" / "params.npz")
    assert all(v.dtype == np.dtype("V2") for v in flat.values())
    model = policy_config._restore(config.get_config(CONFIG), step_dir, device="cpu")
    restored = dict(model.named_parameters())
    for name, value in convert.from_jax_params(bf16).items():
        assert value.dtype == torch.bfloat16
        assert torch.equal(restored[name].detach(), value.to(restored[name].dtype)), name


def test_a_params_dir_without_either_file_names_the_tool(tmp_path):
    (tmp_path / "params").mkdir()
    with pytest.raises(FileNotFoundError, match="export_jax_params"):
        policy_config.create_trained_policy(config.get_config(CONFIG), tmp_path, device="cpu", allow_test_vocab=True)
