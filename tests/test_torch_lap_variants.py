"""The LAP variants of the port against lap_tpu's on the CPU: the VLM-only
(vla0) model, the pi0 branch and the bimanual cameras, each for ``LAP``
(dummy Gemma, 28x28 frames) and ``LAPGemma3`` (gemma3_dummy, 56x56 frames,
prompts laid out as Gemma3Tokenizer lays them out).

Parameters are built by JAX's init (shapes only), randomised with numpy
(the embedding table at 10x spread, for well-separated greedy tokens) and
carried across by the weight bridge, so the one-expert tree (no ``_1``
leaf, no action projection) and the pi0 leaves (``state_proj``,
``action_time_mlp_in/out``, plain ``scale`` norms on expert 1) cross it in
both directions. Each whole-model check runs under a forced attention
implementation, the port's against JAX's: ``xla`` against ``xla``, and the
port's ``flash`` (the kernels' plain versions on CPU tensors) against JAX's
flash path (the Pallas kernels in interpret mode).

Tolerances: actions and losses atol/rtol 2e-5 (f32); greedy tokens exactly;
gradient leaves ``1e-4 * max|leaf| + 2e-6`` (``tests/test_torch_loss.py``:
the sine-cosine time embedding limits them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.models.lap_model import LAPConfig as JaxLAPConfig  # noqa: E402
from lap_tpu.models.tokenizer import GEMMA3_END_IMAGE_TOKEN, GEMMA3_IMAGE_TOKEN  # noqa: E402
from lap_tpu_torch.models import convert  # noqa: E402
from lap_tpu_torch.models.lap_model import LAPConfig  # noqa: E402
from test_torch_lap_gemma3 import _SelectLabels  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    TORCH_THREADS,
    flatten,
    jax_loss_randomness,
    jax_observation,
    port_observation,
    randomize_params,
)

torch.set_num_threads(TORCH_THREADS)
B, STEPS = 2, 5
TOL = dict(atol=2e-5, rtol=2e-5)
FAMILIES = {
    "lap": dict(paligemma_variant="dummy", action_expert_variant="dummy", image_resolution=(28, 28),
                max_token_len=20),
    "gemma3": dict(paligemma_variant="gemma3_dummy", action_expert_variant="gemma3_dummy",
                   image_resolution=(56, 56), max_token_len=64),
}
VARIANTS = {
    "vla0": dict(enable_action_training=False, prompt_format="vla0_chunked"),
    "pi0": dict(enable_action_training=True, pi05=False),
    "bimanual": dict(enable_action_training=True, use_bimanual=True),
}
VALID = {"lap": (17, 12), "gemma3": (60, 52)}


def config_kw(family: str, variant: str) -> dict:
    kw = dict(dtype="float32", siglip_variant="dummy", action_dim=7, action_horizon=4,
              enable_langact_training=True, **FAMILIES[family], **VARIANTS[variant])
    if variant == "bimanual" and family == "gemma3":
        kw["max_token_len"] = 80
    return kw


def prompt(rng, family: str, valid: int, n_cams: int, t: int) -> np.ndarray:
    if family == "lap":
        seq = list(rng.integers(0, 257_152, valid))
    else:
        seq = [2, 106, 1645, 108, *rng.integers(300, 2000, 3), 108, 108]
        for _ in range(n_cams):
            seq += [255999] + [GEMMA3_IMAGE_TOKEN] * 16 + [GEMMA3_END_IMAGE_TOKEN, 108]
        seq += list(rng.integers(300, 2000, valid - len(seq)))
    return np.asarray(seq + [0] * (t - valid), np.int32)


def obs_arrays(seed: int, kw: dict, family: str) -> dict:
    rng = np.random.default_rng(seed)
    keys = JaxLAPConfig(**kw).image_keys
    h, w = kw["image_resolution"]
    t = kw["max_token_len"]
    valid = VALID[family] if t != 80 else (76, 70)
    iota = np.arange(t)[None]
    v = np.asarray(valid)[:, None]
    return dict(
        images={k: rng.uniform(-1, 1, (B, h, w, 3)).astype(np.float32) for k in keys},
        image_masks={k: np.ones((B,), bool) for k in keys},
        state=rng.standard_normal((B, 7)).astype(np.float32),
        tokenized_prompt=np.stack([prompt(rng, family, n, len(keys), t) for n in valid]),
        tokenized_prompt_mask=iota < v,
        tokenized_langact_mask=(iota >= min(valid) - 4) & (iota < v),
        token_loss_mask=rng.random((B, t)) < 0.9,
    )


_PARAMS = {}


def jax_params(kw: dict) -> dict:
    key = tuple(sorted(kw.items()))
    if key not in _PARAMS:
        jmodel = JaxLAPConfig(**kw).create_module()
        shapes = jax.eval_shape(
            lambda: jmodel.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=jmodel.init_params_fn))
        p = randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 71)
        p["llm"]["embedder"]["input_embedding"] *= 10.0
        _PARAMS[key] = p
    return _PARAMS[key]


def port_model(kw: dict, impl: str):
    model = LAPConfig(**kw, attn_impl=impl).create_module(device="cpu", init_seed=None)
    return convert.load_jax_params(model, jax_params(kw))


def jax_module(kw: dict, impl: str, family: str, *, loss: bool = False):
    cfg = JaxLAPConfig(**kw, attn_impl=impl)
    return _SelectLabels(config=cfg) if loss and family == "gemma3" else cfg.create_module()


def assert_grads_match(named_grads: dict, jax_grads):
    ref = convert.from_jax_params(jax.tree.map(np.asarray, jax_grads))
    assert set(ref) == set(named_grads)
    for name, grad in named_grads.items():
        got = np.zeros(ref[name].shape, np.float32) if grad is None else grad.numpy()
        want = ref[name].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 2e-6, err_msg=name)


CASES = [(f, i) for f in FAMILIES for i in ("xla", "flash")]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_the_trees_of_the_variants_cross_the_bridge_both_ways(family):
    """Every variant's JAX tree equals the port's ``jax_params_template`` (paths
    and shapes), and the bridge's inverse gives the tree back."""
    for variant in VARIANTS:
        kw = config_kw(family, variant)
        params = flatten(jax_params(kw))
        model = port_model(kw, "xla")
        template = convert.jax_params_template(model)
        assert {k: tuple(v.shape) for k, v in template.items()} == {k: v.shape for k, v in params.items()}
        back = convert.to_jax_params(dict(model.named_parameters()), siglip_heads=model.img.config.num_heads)
        for k, v in back.items():
            np.testing.assert_array_equal(v.detach().numpy(), params[k], err_msg=k)
        names = list(params)
        if variant == "vla0":
            assert model.num_experts == 1
            assert not any(part.endswith("_1") for n in names if n.startswith("llm/") for part in n.split("/"))
            assert not hasattr(model, "action_in_proj")
        if variant == "pi0":
            assert {"state_proj/kernel", "action_time_mlp_in/kernel", "action_time_mlp_out/kernel"} <= set(names)
            assert params["action_time_mlp_in/kernel"].shape[0] == 2 * model._action_width
            assert not any("time_mlp_in" == n.split("/")[0] for n in names)
            assert not any("Dense_0" in n for n in names if "_1/" in n)  # no adaRMS on expert 1


@pytest.mark.parametrize("family,impl", CASES)
def test_vla0_sample_tokens_match_jax_exactly(family, impl):
    kw = config_kw(family, "vla0")
    arrays = obs_arrays(72, kw, family)
    jmodel = jax_module(kw, impl, family)
    ref = np.asarray(jax.jit(lambda p, o: jmodel.apply(
        {"params": p}, jax.random.PRNGKey(0), o, max_decoding_steps=STEPS, stop_on_eos=False,
        method=jmodel.sample_tokens))(jax_params(kw), jax_observation(arrays)))
    port = port_model(kw, impl)
    got = port.sample_tokens(port_observation(arrays), max_decoding_steps=STEPS, stop_on_eos=False)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(set(ref.flatten().tolist())) > 1
    with pytest.raises(ValueError, match="VLM-only"):
        port.sample_actions(port_observation(arrays), num_steps=1)


def _loss_check(family, impl, variant, seed):
    kw = config_kw(family, variant)
    arrays = obs_arrays(seed, kw, family)
    actions = np.random.default_rng(seed + 1).standard_normal((B, 4, 7)).astype(np.float32)
    rng = jax.random.PRNGKey(seed + 2)
    jmodel = jax_module(kw, impl, family, loss=True)

    def jax_loss(p):
        return jmodel.apply({"params": p}, rng, jax_observation(arrays), jnp.asarray(actions), train=False,
                            method=jmodel.compute_loss)

    (ref_loss, ref_metrics), ref_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jax_params(kw))
    draws = jax_loss_randomness(rng, image_keys=JaxLAPConfig(**kw).image_keys, batch=B,
                                resolution=kw["image_resolution"], action_shape=actions.shape)
    port = port_model(kw, impl)
    loss, metrics = port.compute_loss(port_observation(arrays), torch.from_numpy(actions),
                                      noise=torch.from_numpy(draws["noise"].copy()),
                                      time=torch.from_numpy(draws["time"].copy()))
    loss.backward()
    assert np.isfinite(float(ref_loss))
    np.testing.assert_allclose(loss.item(), float(ref_loss), **TOL)
    assert set(metrics) == set(ref_metrics)
    for name, ref in ref_metrics.items():
        np.testing.assert_allclose(metrics[name].detach().numpy(), np.asarray(ref), **TOL, err_msg=name)
    assert_grads_match({n: p.grad for n, p in port.named_parameters()}, ref_grads)
    return metrics


@pytest.mark.parametrize("family,impl", [("lap", "flash"), ("gemma3", "xla")])
def test_vla0_compute_loss_is_the_language_loss_and_matches_jax(family, impl):
    metrics = _loss_check(family, impl, "vla0", 73)
    assert "lang_loss" in metrics and "action_loss" not in metrics


@pytest.mark.parametrize("family,impl", CASES)
def test_pi0_sample_actions_match_jax(family, impl):
    kw = config_kw(family, "pi0")
    arrays = obs_arrays(74, kw, family)
    noise = np.random.default_rng(75).standard_normal((B, 4, 7)).astype(np.float32)
    jmodel = jax_module(kw, impl, family)
    ref = jax.jit(lambda p, o, n: jmodel.apply({"params": p}, jax.random.PRNGKey(0), o, noise=n, num_steps=3,
                                               method=jmodel.sample_actions))(
        jax_params(kw), jax_observation(arrays), jnp.asarray(noise))
    port = port_model(kw, impl)
    got = port.sample_actions(port_observation(arrays), noise=torch.from_numpy(noise), num_steps=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # The suffix: a state token with its own AR segment, then the actions.
    obs = port_observation(arrays)
    tokens, mask, ar, cond = port.embed_suffix(obs, torch.from_numpy(noise), torch.full((B,), 0.5))
    assert tokens.shape[1] == 5 and cond is None and ar.tolist() == [True, True, False, False, False]


@pytest.mark.parametrize("family,impl", [("lap", "xla"), ("gemma3", "flash")])
def test_pi0_compute_loss_and_gradients_match_jax(family, impl):
    metrics = _loss_check(family, impl, "pi0", 76)
    assert {"lang_loss", "action_loss"} <= set(metrics)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_bimanual_reads_three_cameras_like_jax(family):
    kw = config_kw(family, "bimanual")
    assert LAPConfig(**kw).image_keys == JaxLAPConfig(**kw).image_keys
    assert len(LAPConfig(**kw).image_keys) == 3
    arrays = obs_arrays(77, kw, family)
    noise = np.random.default_rng(78).standard_normal((B, 4, 7)).astype(np.float32)
    jmodel = jax_module(kw, "xla", family)
    ref = jax.jit(lambda p, o, n: jmodel.apply({"params": p}, jax.random.PRNGKey(0), o, noise=n, num_steps=2,
                                               method=jmodel.sample_actions))(
        jax_params(kw), jax_observation(arrays), jnp.asarray(noise))
    port = port_model(kw, "xla")
    got = port.sample_actions(port_observation(arrays), noise=torch.from_numpy(noise), num_steps=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    fake = LAPConfig(**kw).fake_obs(1, device="cpu")
    assert set(fake.images) == set(JaxLAPConfig(**kw).image_keys)


def test_the_scan_knobs_parse_and_change_nothing():
    kw = config_kw("lap", "pi0")
    arrays = obs_arrays(79, kw, "lap")
    noise = torch.from_numpy(np.random.default_rng(80).standard_normal((B, 4, 7)).astype(np.float32))
    base = port_model(kw, "xla").sample_actions(port_observation(arrays), noise=noise, num_steps=2)
    knobs = LAPConfig(**kw, scan_layers=False, scan_unroll=4).create_module(device="cpu", init_seed=None)
    convert.load_jax_params(knobs, jax_params(kw))
    assert torch.equal(knobs.sample_actions(port_observation(arrays), noise=noise, num_steps=2), base)
