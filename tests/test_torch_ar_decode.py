"""AR language-action decode and quantized flow chunks of the port against
lap_tpu on the CPU.

The dummy flagship-architecture LAP in JAX's quantized serving layout
(``scan_layers=False``), batch 2 with unequal prompt padding, f32,
randomised parameters carried across by the weight bridge (the "quant"
collection too). ``QUANT_MIN_WEIGHT_ELEMS`` (4096) and ``QUANT_MAX_ROWS``
(32) are patched on both sides, so the dummy widths quantize and the
48-row prefill keeps the exact product while decode steps (2 rows) and flow
suffixes (8 rows) take the dequant matmuls.

Tolerances: ``left_to_right_align``, ``put_along_last_axis``,
``update_cache`` and the tokens exactly; the logits of every step to 2e-5 of
their largest entry (f32 sums in another order through 4 layers, measured
4e-7). Random models have near-tied logits and argmax tie-breaking is
shape-dependent, so the embedding table is drawn at 10x the usual spread and
the top-2 gap of every step is asserted to exceed 10x that tolerance.
Quantized ``sample_actions`` to 2e-5 (atol and rtol) as the bf16 slice. The
AR prefill's left-padded query rows are fully masked: JAX's einsum gives them
the mean of V, the flash path zeros; no valid row reads them, so the flash
prefill is compared on the valid cache slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.models import gemma as jax_gemma  # noqa: E402
from lap_tpu.models import lap_model as jax_lap  # noqa: E402
from lap_tpu.models import lora as jax_lora  # noqa: E402
from lap_tpu.models.preprocessing import preprocess_observation as jax_preprocess  # noqa: E402
from lap_tpu.ops.masks import make_attn_mask as jax_make_attn_mask  # noqa: E402
from lap_tpu_torch.models import convert  # noqa: E402
from lap_tpu_torch.models import gemma  # noqa: E402
from lap_tpu_torch.models import lap_model  # noqa: E402
from lap_tpu_torch.models import lora  # noqa: E402
from lap_tpu_torch.ops.masks import make_attn_mask  # noqa: E402
from lap_tpu_torch.policies.policy import ARPolicy  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    TORCH_THREADS,
    jax_observation,
    port_observation,
    random_obs_arrays,
    randomize_params,
    tiny_lap_config_kwargs,
)

torch.set_num_threads(TORCH_THREADS)
STEPS = 8
LOGIT_TOL = 2e-5  # of the largest logit
MODES = [None, "int8", "int4"]


@pytest.fixture(scope="module", autouse=True)
def small_thresholds():
    saved = [(m, name, getattr(m, name)) for m in (jax_lora, lora)
             for name in ("QUANT_MIN_WEIGHT_ELEMS", "QUANT_MAX_ROWS")]
    for m in (jax_lora, lora):
        m.QUANT_MIN_WEIGHT_ELEMS, m.QUANT_MAX_ROWS = 4096, 32
    yield
    for m, name, value in saved:
        setattr(m, name, value)


def test_left_to_right_align_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 3)).astype(np.float32)
    mask = np.arange(6)[None, :] < np.array([[4], [6]])
    ar = np.zeros((2, 6), bool)
    ar[0, 2] = True
    ref = jax_lap.left_to_right_align(jnp.asarray(x), jnp.asarray(mask),
                                      jax_make_attn_mask(jnp.asarray(mask), jnp.asarray(ar)))
    got = lap_model.left_to_right_align(torch.from_numpy(x), torch.from_numpy(mask),
                                        make_attn_mask(torch.from_numpy(mask), torch.from_numpy(ar)))
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(got[1][0].numpy(), [False, False, True, True, True, True])


def test_put_along_last_axis_and_update_cache_match_jax():
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 9, (2, 5)).astype(np.int32)
    vals = np.array([[7], [8]], np.int32)
    ref = jax_lap.put_along_last_axis(jnp.asarray(arr), jnp.broadcast_to(3, (2, 1)), jnp.asarray(vals))
    got = lap_model.put_along_last_axis(torch.from_numpy(arr), 3, torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    k, v = (rng.standard_normal((2, 1, 1, 4)).astype(np.float32) for _ in range(2))
    kc, vc = (rng.standard_normal((2, 8, 1, 4)).astype(np.float32) for _ in range(2))
    idx = np.array([3, 5], np.int32)  # a row index of its own per batch row
    ref = jax_gemma.update_cache(*(jnp.asarray(a) for a in (k, v, idx, kc, vc)))
    got = gemma.update_cache(*(torch.from_numpy(a.copy()) for a in (k, v, idx, kc, vc)))
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _jax_greedy(module, obs, steps):
    """``LAP.sample_tokens`` at temperature 0 without the EOS stop, unrolled
    so that every step's logits and the prefill's cache come out."""
    cfg = module.config
    obs = jax_preprocess(None, obs, train=False, image_keys=list(obs.images.keys()),
                         image_resolution=cfg.image_resolution, aug_wrist_image=cfg.aug_wrist_image)
    tokens, mask, ar = module.embed_prefix(obs)
    tokens, mask, attn = jax_lap.left_to_right_align(tokens, mask, jax_make_attn_mask(mask, ar))
    size, plen = tokens.shape[1], jnp.sum(mask, axis=-1)
    attn = jnp.pad(attn, ((0, 0), (0, 0), (0, steps)))
    pre, cache = module.llm([tokens, None], jnp.cumsum(mask, axis=-1) - 1, attn, [None, None])
    prefill_cache = cache
    logit = module.llm.decode_logits(pre[0][:, -1:])
    logits, picked = [logit], []
    col = jnp.arange(size + steps)[None, None, :]
    for i in range(steps):
        token = jnp.argmax(logit, axis=-1).astype(jnp.int32)
        picked.append(token)
        step_mask = (col >= (size - plen)[:, None, None]) & (col < size + i + 1)
        pre, cache = module.llm([module.llm.embed(token), None], plen[:, None] + i, step_mask,
                                [None, None], kv_cache=cache)
        logit = module.llm.decode_logits(pre[0])
        logits.append(logit)
    return jnp.concatenate(picked, axis=1), jnp.concatenate(logits, axis=1), prefill_cache, mask


def _jax_config(mode, **kw):
    return jax_lap.LAPConfig(**tiny_lap_config_kwargs(enable_langact_training=True, scan_layers=False,
                                                      quant=mode, **kw))


@pytest.fixture(scope="module")
def models():
    """Per mode: (JAX module, JAX variables, port model) on shared random parameters."""
    cfg = _jax_config(None)
    module = cfg.create_module()
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=module.init_params_fn)
    )
    params = randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 51)
    params["llm"]["embedder"]["input_embedding"] *= 10.0  # well-separated argmax
    out = {}
    for mode in MODES:
        jmodule = _jax_config(mode).create_module()
        variables = {"params": params}
        port = convert.load_jax_params(
            lap_model.LAP(lap_model.LAPConfig(**tiny_lap_config_kwargs()), device="cpu", init_seed=None), params)
        if mode is not None:
            _, qvars = jax.jit(lambda v, m=jmodule: m.apply(v, jax.random.PRNGKey(0), method=m.init_params_fn,
                                                           mutable=["quant"]))(variables)
            variables = {"params": params, "quant": qvars["quant"]}
            convert.load_jax_quant(port, jax.tree.map(np.asarray, qvars["quant"]))
        out[mode] = (jmodule, variables, port)
    return out


def _arrays(seed=52, batch=2):
    return random_obs_arrays(seed, batch=batch, valid=[11, 5][:batch], cfg_kw=tiny_lap_config_kwargs())


def _jax_sample_tokens(jmodule, variables, arrays, **kw):
    fn = jax.jit(lambda v, o: jmodule.apply(v, jax.random.PRNGKey(0), o, method=jmodule.sample_tokens, **kw))
    return np.asarray(fn(variables, jax_observation(arrays)))


def _port_greedy(port, obs, steps):
    state = port.ar_prefill(obs, steps)
    logits, tokens = [state.logits], []
    for _ in range(steps):
        tokens.append(state.logits.argmax(dim=-1).to(torch.int32))
        logits.append(port.ar_step(state, tokens[-1]))
    return torch.cat(tokens, 1).numpy(), torch.cat(logits, 1).numpy(), state


@pytest.mark.parametrize("mode", MODES)
def test_sample_tokens_and_every_step_logits_match_jax(models, mode):
    jmodule, variables, port = models[mode]
    arrays = _arrays()
    ref_tokens = _jax_sample_tokens(jmodule, variables, arrays, max_decoding_steps=STEPS, stop_on_eos=False)
    got_tokens = port.sample_tokens(port_observation(arrays), max_decoding_steps=STEPS, stop_on_eos=False)
    assert got_tokens.dtype == torch.int32 and tuple(got_tokens.shape) == (2, STEPS)
    np.testing.assert_array_equal(got_tokens.numpy(), ref_tokens)

    helper_tokens, ref_logits, _, _ = jmodule.apply(variables, jax_observation(arrays), STEPS, method=_jax_greedy)
    np.testing.assert_array_equal(np.asarray(helper_tokens), ref_tokens)
    tokens, logits, _ = _port_greedy(port, port_observation(arrays), STEPS)
    np.testing.assert_array_equal(tokens, ref_tokens)
    tol = LOGIT_TOL * np.abs(logits).max()
    np.testing.assert_allclose(logits, np.asarray(ref_logits), rtol=0, atol=tol)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 10 * tol
    assert (tokens[0] != tokens[1]).any()  # the padding changes the answer


def test_quantization_moves_the_logits(models):
    """The quantized decode path is live: int8 and int4 logits differ from
    bf16-exact ones by their weight rounding, int4 more."""
    arrays = _arrays()
    step0 = {m: models[m][2].ar_prefill(port_observation(arrays), 1).logits for m in MODES}
    err = {m: ((step0[m] - step0[None]).norm() / step0[None].norm()).item() for m in ("int8", "int4")}
    assert 1e-4 < err["int8"] < err["int4"] < 0.2, err


def test_staggered_eos_matches_jax(models):
    jmodule, variables, port = models[None]
    arrays = _arrays(seed=53)
    greedy = port.sample_tokens(port_observation(arrays), max_decoding_steps=STEPS).numpy()
    eos = int(greedy[0, 0])
    jmodule_eos = jax_lap.LAP(config=jmodule.config, EOS_TOKEN=eos)
    ref = _jax_sample_tokens(jmodule_eos, variables, arrays, max_decoding_steps=STEPS)
    got = port.sample_tokens(port_observation(arrays), max_decoding_steps=STEPS, eos_token=eos).numpy()
    np.testing.assert_array_equal(got, ref)
    # Row 0 finishes at step 0 and writes 0 after; row 1 decodes past it.
    assert got.shape == (2, STEPS) and got[0, 0] == eos and (got[0, 1:] == 0).all()
    assert (got[1, 1:] != 0).any()
    for row in got:
        hits = np.nonzero(row == eos)[0]
        assert not hits.size or (row[hits[0] + 1 :] == 0).all()


def test_flash_prefill_matches_jax_on_valid_slots(models):
    jmodule, variables, port = models[None]
    arrays = _arrays()
    _, ref_logits, ref_cache, valid = jmodule.apply(variables, jax_observation(arrays), 2, method=_jax_greedy)
    port.set_attn_impl("flash")  # the plain flash version on CPU tensors
    try:
        _, logits, state = _port_greedy(port, port_observation(arrays), 2)
        prefill = port.ar_prefill(port_observation(arrays), 2)
    finally:
        port.set_attn_impl("auto")
    valid = np.asarray(valid)
    for got, ref in zip(prefill.kv_cache[1:], ref_cache[1:], strict=True):
        got, ref = got.numpy()[:, :, : valid.shape[1]], np.asarray(ref)[:, :, : valid.shape[1]]
        np.testing.assert_allclose(got[:, valid], ref[:, valid], rtol=0, atol=2e-5 * np.abs(ref).max())
        assert np.abs(got[:, ~valid] - ref[:, ~valid]).max() > 1e-3  # the padded rows do differ
    np.testing.assert_allclose(logits, np.asarray(ref_logits), rtol=0, atol=LOGIT_TOL * np.abs(logits).max())


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_sample_actions_matches_jax(models, mode):
    jmodule, variables, port = models[mode]
    arrays = _arrays(seed=54)
    noise = np.random.default_rng(55).standard_normal((2, 4, 7)).astype(np.float32)
    ref = jax.jit(lambda v, o, n: jmodule.apply(v, jax.random.PRNGKey(0), o, noise=n, method=jmodule.sample_actions))(
        variables, jax_observation(arrays), jnp.asarray(noise))
    got = port.sample_actions(port_observation(arrays), noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5, rtol=2e-5)
    exact = models[None][2].sample_actions(port_observation(arrays), noise=torch.from_numpy(noise)).numpy()
    assert np.abs(got - exact).max() > 1e-5  # the expert MLPs went through the dequant matmuls


def test_ar_policy_infer_is_seeded_per_request(models):
    port = models["int8"][2]
    arrays = _arrays(seed=56, batch=1)
    request = {
        "image": {k: ((v[0] + 1) * 127.5).astype(np.uint8) for k, v in arrays["images"].items()},
        "state": arrays["state"][0],
        "tokenized_prompt": arrays["tokenized_prompt"][0],
        "tokenized_prompt_mask": arrays["tokenized_prompt_mask"][0],
    }
    hot = 100.0  # the wide embedding table spreads the logits by ~80
    first = ARPolicy(port, max_decoding_steps=6, temperature=hot, seed=3).infer(request)
    again = ARPolicy(port, max_decoding_steps=6, temperature=hot, seed=3)
    t1, t2 = again.infer(request)["tokens"], again.infer(request)["tokens"]
    assert first["tokens"].shape == (1, 6) and first["tokens"].dtype == np.int32
    assert "infer_ms" in first["policy_timing"]
    np.testing.assert_array_equal(first["tokens"], t1)  # same seed, same request step
    assert (t1 != t2).any()  # the next request draws new noise
    greedy = [ARPolicy(port, max_decoding_steps=6, seed=s).infer(request)["tokens"] for s in (3, 4)]
    np.testing.assert_array_equal(*greedy)  # temperature 0 draws nothing
