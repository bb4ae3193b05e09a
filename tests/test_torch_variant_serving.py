"""The serving stacks of the new configs, from a checkpoint directory, against
lap_tpu's policies on the CPU: ``vla0_replicated`` (the VLM-only model,
restored into an AR policy; the vla0 output stack parses the detokenized
reasoning) and ``pi05_replicated`` (FAST: ``TokenizeFASTInputs`` in,
``ExtractFASTActions`` out, which JAX does not unnormalize either), each
with its dummy-size model (f32, the dummy Gemma and SigLIP at 56x56).

Exact: every request's outputs (tokens decoded greedily, actions, the
reasoning text) equal JAX's ``ARPolicy`` on the same parameters, raw request
and host RNG seeds (``tests/test_torch_transforms.py``'s ``seeded``); the
model's parity itself is held in ``tests/test_torch_lap_variants.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.policies import model_transforms as jax_mt  # noqa: E402
from lap_tpu.policies import policy as jax_policy  # noqa: E402
from lap_tpu.policies import policy_config as jax_policy_config  # noqa: E402
from lap_tpu.training import config as jax_config  # noqa: E402
from lap_tpu_torch.models import convert  # noqa: E402
from lap_tpu_torch.policies import model_transforms as mt  # noqa: E402
from lap_tpu_torch.policies import policy_config  # noqa: E402
from lap_tpu_torch.training import checkpoints, config  # noqa: E402
from test_torch_serving_stack import robot_request  # noqa: E402
from test_torch_transforms import assert_tree_equal, norm_stats, seeded  # noqa: E402
from torch_port_helpers import TORCH_THREADS, private_jax_native, randomize_params  # noqa: E402

torch.set_num_threads(TORCH_THREADS)
AR_STEPS = 6
SMALL = dict(paligemma_variant="dummy", action_expert_variant="dummy", siglip_variant="dummy", dtype="float32",
             image_resolution=(56, 56))


@pytest.fixture(scope="module", autouse=True)
def jax_native_in_a_private_dir(tmp_path_factory):
    restore = private_jax_native(tmp_path_factory.mktemp("jax_native"))
    yield
    restore()


def _small(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **SMALL))


@pytest.fixture(scope="module", params=["vla0_replicated", "pi05_replicated"])
def served(request, tmp_path_factory):
    name = request.param
    jcfg, pcfg = _small(jax_config.get_config(name)), _small(config.get_config(name))
    module = jcfg.model.create_module()
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=module.init_params_fn))
    params = randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 97)
    params["llm"]["embedder"]["input_embedding"] *= 10.0
    ckpt = tmp_path_factory.mktemp(name)
    model = convert.load_jax_params(pcfg.model.create_module(device="cpu", init_seed=None), params)
    checkpoints.save_params(model, ckpt / "params")
    checkpoints.save_norm_stats(ckpt / "assets" / pcfg.data.asset_id / "norm_stats.json", norm_stats(mt))
    port = policy_config.create_trained_policy_ar(pcfg, ckpt, device="cpu", allow_test_vocab=True,
                                                  max_decoding_steps=AR_STEPS)
    inputs, outputs = jax_policy_config._build_transform_stacks(jcfg, norm_stats(jax_mt), ar=True)
    ref = jax_policy.ARPolicy(module, {"params": params}, input_transforms=inputs, output_transforms=outputs,
                              max_decoding_steps=AR_STEPS)
    return dict(name=name, port=port, ref=ref, pcfg=pcfg, ckpt=ckpt)


def test_ar_serving_of_the_new_configs_matches_jax(served):
    port, ref = served["port"], served["ref"]
    assert port._model.num_experts == (1 if served["name"] == "vla0_replicated" else 2)
    for i in (0, 2, 4):
        got, want = seeded(i, port.infer, robot_request(i)), seeded(i, ref.infer, robot_request(i))
        del got["policy_timing"], want["policy_timing"]
        assert_tree_equal(got, want, f"{served['name']} request {i}")
        horizon = 10 if served["name"] == "vla0_replicated" else 16
        assert np.asarray(got["actions"]).shape == (horizon, 7)
        if served["name"] == "pi05_replicated":
            assert got["reasoning"] is None  # ExtractFASTActions: no reasoning text, no unnormalize


def test_the_flow_policy_takes_the_fast_model_and_refuses_the_vla0_model(served):
    if served["name"] == "vla0_replicated":
        with pytest.raises(ValueError, match="VLM-only"):
            policy_config.create_trained_policy(served["pcfg"], served["ckpt"], device="cpu", allow_test_vocab=True)
        return
    flow = policy_config.create_trained_policy(served["pcfg"], served["ckpt"], device="cpu", allow_test_vocab=True)
    out = seeded(0, flow.infer, robot_request(0))
    assert out["actions"].shape == (16, 7) and np.isfinite(out["actions"]).all()
