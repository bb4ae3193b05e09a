"""LAPGemma3 of the port against lap_tpu's on the CPU.

The gemma3_dummy VLM and action expert with the dummy SigLIP at 56x56 (16
image tokens a camera), f32, parameters randomised with numpy and carried
across by the weight bridge. The prompts are laid out as Gemma3Tokenizer
lays them out (BOS, turn tokens, per camera BOI + 16 placeholders +
END_IMAGE + newline, text) and **padded** (66 and 58 of 80 slots), so that
the right-aligned AR prefill has valid rows with no key on local layers and
the flow suffix sits a window's worth of slots past its positions. Every
whole-model test runs under both forced attention implementations: the
port's ``flash`` (the kernels' plain versions on CPU tensors) against JAX's
flash path (the Pallas kernels in interpret mode), the port's ``xla``
against JAX's ``xla``; the two disagree on the dead rows, and each side must
agree with its own.

Tolerances: actions and losses atol/rtol 2e-5; every AR step's logits 2e-5
of their largest entry with the tokens exact (the embedding table drawn at
10x spread, the top-2 gap asserted above 10x the tolerance); gradient leaves
``1e-4 * max|leaf| + 2e-6`` (``tests/test_torch_loss.py``: the sine-cosine
time embedding limits them); the masks of every attention call exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.models import gemma as jax_gemma  # noqa: E402
from lap_tpu.models import gemma3 as jax_gemma3  # noqa: E402
from lap_tpu.models import lap_gemma3 as jax_lap_gemma3  # noqa: E402
from lap_tpu.models import lora as jax_lora  # noqa: E402
from lap_tpu.models.lap_model import LAPConfig as JaxLAPConfig  # noqa: E402
from lap_tpu.models.preprocessing import preprocess_observation as jax_preprocess  # noqa: E402
from lap_tpu.models.tokenizer import GEMMA3_END_IMAGE_TOKEN, GEMMA3_IMAGE_TOKEN  # noqa: E402
from lap_tpu.ops.masks import make_attn_mask as jax_make_attn_mask  # noqa: E402
from lap_tpu_torch.models import convert  # noqa: E402
from lap_tpu_torch.models import gemma as port_gemma  # noqa: E402
from lap_tpu_torch.models import lap_gemma3 as port_lap_gemma3  # noqa: E402
from lap_tpu_torch.models import lora  # noqa: E402
from lap_tpu_torch.models.lap_model import LAPConfig  # noqa: E402
from lap_tpu_torch.ops.masks import make_attn_mask  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    TORCH_THREADS,
    flatten,
    jax_loss_randomness,
    jax_observation,
    port_observation,
    randomize_params,
)

torch.set_num_threads(TORCH_THREADS)
T, B, VALID, LANGACT_FROM = 80, 2, (66, 58), 50
IMPLS = ["xla", "flash"]
STEPS = 6
LOGIT_TOL = 2e-5
TOL = dict(atol=2e-5, rtol=2e-5)
KW = dict(
    dtype="float32", paligemma_variant="gemma3_dummy", action_expert_variant="gemma3_dummy",
    siglip_variant="dummy", action_dim=7, action_horizon=4, max_token_len=T, image_resolution=(56, 56),
    enable_action_training=True, enable_langact_training=True,
)


def gemma3_prompt(rng, valid: int) -> np.ndarray:
    """A padded prompt laid out as Gemma3Tokenizer lays it out."""
    seq = [2, 106, 1645, 108, *rng.integers(300, 2000, 3), 108, 108]
    for _ in range(2):
        seq += [255999] + [GEMMA3_IMAGE_TOKEN] * 16 + [GEMMA3_END_IMAGE_TOKEN, 108]
    seq += list(rng.integers(300, 2000, valid - len(seq)))
    return np.asarray(seq + [0] * (T - valid), np.int32)


def obs_arrays(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    valid = np.asarray(VALID)[:, None]
    keys = ("base_0_rgb", "left_wrist_0_rgb")
    iota = np.arange(T)[None]
    return dict(
        images={k: rng.uniform(-1, 1, (B, 56, 56, 3)).astype(np.float32) for k in keys},
        image_masks={k: np.ones((B,), bool) for k in keys},
        state=rng.standard_normal((B, 7)).astype(np.float32),
        tokenized_prompt=np.stack([gemma3_prompt(rng, v) for v in VALID]),
        tokenized_prompt_mask=iota < valid,
        tokenized_langact_mask=(iota >= LANGACT_FROM) & (iota < valid),
        token_loss_mask=rng.random((B, T)) < 0.9,
    )


@pytest.fixture(scope="module")
def params():
    jmodel = JaxLAPConfig(**KW).create_module()
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=jmodel.init_params_fn))
    p = randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 61)
    p["llm"]["embedder"]["input_embedding"] *= 10.0  # well-separated argmax
    return p


def port_model(params, **overrides):
    model = LAPConfig(**{**KW, **overrides}).create_module(device="cpu", init_seed=None)
    return convert.load_jax_params(model, params)


def test_config_builds_lap_gemma3_and_counts_its_layers():
    cfg = LAPConfig(**KW)
    assert cfg.backbone_depth == JaxLAPConfig(**KW).backbone_depth == 6
    model = cfg.create_module(device="meta", init_seed=None)
    assert type(model) is port_lap_gemma3.LAPGemma3 and model.EOS_TOKEN == 1
    assert model.llm.is_global == (False,) * 5 + (True,)
    assert model.img.config.pool_to_tokens == 16 and not model.img.config.head_bias
    assert type(LAPConfig(**{**KW, "paligemma_variant": "dummy", "action_expert_variant": "dummy"})
                .create_module(device="meta", init_seed=None)).__name__ == "LAP"
    with pytest.raises(ValueError, match="gemma3 variants"):
        LAPConfig(**{**KW, "action_expert_variant": "dummy"}).create_module(device="meta", init_seed=None)


def test_left_to_right_align_with_image_mask_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3)).astype(np.float32)
    # Row 1 has a masked slot inside (an absent camera): the roll is by the
    # last valid index + 1, not by the count.
    mask = np.array([[1, 1, 1, 1, 0, 0, 0], [1, 0, 1, 1, 1, 0, 0]], bool)
    ar = np.zeros((2, 7), bool)
    ar[0, 2] = True
    img = np.array([[0, 1, 1, 0, 0, 0, 0], [0, 1, 1, 0, 0, 0, 0]], bool)
    ref = jax_lap_gemma3.left_to_right_align_with_image_mask(
        jnp.asarray(x), jnp.asarray(mask), jax_make_attn_mask(jnp.asarray(mask), jnp.asarray(ar)), jnp.asarray(img))
    got = port_lap_gemma3.left_to_right_align_with_image_mask(
        torch.from_numpy(x), torch.from_numpy(mask), make_attn_mask(torch.from_numpy(mask), torch.from_numpy(ar)),
        torch.from_numpy(img))
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("impl", IMPLS)
def test_sample_actions_matches_jax(params, impl):
    arrays = obs_arrays(62)
    noise = np.random.default_rng(63).standard_normal((B, 4, 7)).astype(np.float32)
    jmodel = JaxLAPConfig(**KW, attn_impl=impl).create_module()
    ref = jax.jit(lambda p, o, n: jmodel.apply({"params": p}, jax.random.PRNGKey(0), o, noise=n, num_steps=3,
                                               method=jmodel.sample_actions))(
        params, jax_observation(arrays), jnp.asarray(noise))
    got = port_model(params, attn_impl=impl).sample_actions(port_observation(arrays), noise=torch.from_numpy(noise),
                                                             num_steps=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def assert_grads_match(named_grads: dict, jax_grads):
    """Every port gradient against its JAX leaf (a missing one counts as 0)."""
    ref = convert.from_jax_params(jax.tree.map(np.asarray, jax_grads))
    assert set(ref) == set(named_grads)
    for name, grad in named_grads.items():
        got = np.zeros(ref[name].shape, np.float32) if grad is None else grad.numpy()
        want = ref[name].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 2e-6, err_msg=name)


def _jax_greedy(module, obs, steps):
    """``LAPGemma3.sample_tokens`` at temperature 0, unrolled so that every
    step's logits come out."""
    cfg = module.config
    obs = jax_preprocess(None, obs, train=False, image_keys=list(obs.images.keys()),
                         image_resolution=cfg.image_resolution, aug_wrist_image=cfg.aug_wrist_image)
    tokens, mask, ar, img = module.embed_prefix(obs)
    tokens, mask, attn, img = jax_lap_gemma3.left_to_right_align_with_image_mask(
        tokens, mask, jax_make_attn_mask(mask, ar), img)
    size, plen = tokens.shape[1], jnp.sum(mask, axis=-1)
    attn = jnp.pad(attn, ((0, 0), (0, 0), (0, steps)))
    pre, cache = module.llm([tokens, None], jnp.cumsum(mask, axis=-1) - 1, attn, [None, None], image_mask=img)
    logit = module.llm.decode_logits(pre[0][:, -1:])
    logits, picked = [logit], []
    col = jnp.arange(size + steps)[None, None, :]
    for i in range(steps):
        token = jnp.argmax(logit, axis=-1).astype(jnp.int32)
        picked.append(token)
        step_mask = (col >= (size - plen)[:, None, None]) & (col < size + i + 1)
        pre, cache = module.llm([module.llm.embed(token), None], plen[:, None] + i, step_mask, [None, None],
                                image_mask=jnp.zeros((token.shape[0], 1), bool), kv_cache=cache)
        logit = module.llm.decode_logits(pre[0])
        logits.append(logit)
    return jnp.concatenate(picked, axis=1), jnp.concatenate(logits, axis=1)


def _port_greedy(model, obs, steps):
    state = model.ar_prefill(obs, steps)
    logits, tokens = [state.logits], []
    for _ in range(steps):
        tokens.append(state.logits.argmax(dim=-1).to(torch.int32))
        logits.append(model.ar_step(state, tokens[-1]))
    return torch.cat(tokens, 1).numpy(), torch.cat(logits, 1).numpy()


def _assert_logits_match(logits, ref_logits):
    tol = LOGIT_TOL * np.abs(logits).max()
    np.testing.assert_allclose(logits, np.asarray(ref_logits), rtol=0, atol=tol)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 10 * tol


@pytest.mark.parametrize("impl", IMPLS)
def test_sample_tokens_and_every_step_logits_match_jax(params, impl):
    arrays = obs_arrays(64)
    jmodel = JaxLAPConfig(**KW, attn_impl=impl).create_module()
    ref_tokens = np.asarray(jax.jit(lambda p, o: jmodel.apply(
        {"params": p}, jax.random.PRNGKey(0), o, max_decoding_steps=STEPS, stop_on_eos=False,
        method=jmodel.sample_tokens))(params, jax_observation(arrays)))
    port = port_model(params, attn_impl=impl)
    got = port.sample_tokens(port_observation(arrays), max_decoding_steps=STEPS, stop_on_eos=False)
    np.testing.assert_array_equal(got.numpy(), ref_tokens)

    helper_tokens, ref_logits = jax.jit(lambda p, o: jmodel.apply({"params": p}, o, STEPS, method=_jax_greedy))(
        params, jax_observation(arrays))
    np.testing.assert_array_equal(np.asarray(helper_tokens), ref_tokens)
    tokens, logits = _port_greedy(port, port_observation(arrays), STEPS)
    np.testing.assert_array_equal(tokens, ref_tokens)
    _assert_logits_match(logits, ref_logits)


def test_the_dead_rows_make_flash_and_einsum_disagree(params):
    """The right-aligned prefill's valid rows below ``prefix_start`` see no key
    on a local layer: the einsum path averages V there, the flash path gives
    zeros, so the two implementations' prefill logits differ (on each side
    alike, as the two tests above show)."""
    arrays = obs_arrays(64)
    first = {impl: port_model(params, attn_impl=impl).ar_prefill(port_observation(arrays), 1).logits
             for impl in IMPLS}
    assert (first["xla"] - first["flash"]).abs().max().item() > 1e-3


LOSS_CASES = {"config": {}, "stop_grad": dict(stop_action_to_vlm_grad=True)}


class _SelectLabels(jax_lap_gemma3.LAPGemma3):
    """The JAX model with its label log-probs for ids outside the table set
    to 0 instead of NaN. JAX fills NaN there (``take_along_axis``) and
    multiplies by the boolean loss mask; jitted on the CPU the product keeps
    the NaN of a masked placeholder label (the language loss of every prompt
    with images is NaN), while the port drops a masked position as a select
    does. With 0 in the NaN's place the two agree on everything else."""

    def _token_logp_and_pred(self, pre_logits, labels, *, need_pred):
        vocab = jax_gemma3.GEMMA3_VOCAB_SIZE
        logp, pred = super()._token_logp_and_pred(pre_logits, jnp.clip(labels, 0, vocab - 1), need_pred=need_pred)
        return jnp.where(labels < vocab, logp, 0.0), pred


@pytest.mark.parametrize("impl,case", [("xla", "config"), ("flash", "stop_grad")])
def test_compute_loss_and_every_gradient_match_jax(params, impl, case):
    """``compute_loss`` (train=False) against ``jax.value_and_grad`` with the
    same noise and time; the prompt holds the END_IMAGE id and the
    placeholders, whose labels lie outside the table and are masked
    (``_SelectLabels``)."""
    overrides = dict(attn_impl=impl, **LOSS_CASES[case])
    arrays = obs_arrays(65)
    actions = np.random.default_rng(66).standard_normal((B, 4, 7)).astype(np.float32)
    rng = jax.random.PRNGKey(67)
    jcfg = JaxLAPConfig(**KW, **overrides)
    jmodel = _SelectLabels(config=jcfg)

    def jax_loss(p):
        return jmodel.apply({"params": p}, rng, jax_observation(arrays), jnp.asarray(actions), train=False,
                            method=jmodel.compute_loss)

    (ref_loss, ref_metrics), ref_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    draws = jax_loss_randomness(rng, image_keys=jcfg.image_keys, batch=B, resolution=(56, 56),
                                action_shape=actions.shape)
    port = port_model(params, **overrides)
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


def test_the_end_image_id_reads_the_last_row_and_its_label_is_nan(params):
    """GEMMA3_END_IMAGE_TOKEN is one past the table: JAX's gather clamps it to
    row 262143, and the language loss's label gather fills NaN for it, which
    an unmasked position keeps. The port does the same."""
    assert GEMMA3_END_IMAGE_TOKEN == jax_gemma3.GEMMA3_VOCAB_SIZE
    port = port_model(params)
    ids = torch.tensor([[5, GEMMA3_END_IMAGE_TOKEN, GEMMA3_END_IMAGE_TOKEN + 7]])
    got = port.llm.embed(ids)
    table = port.llm.embedder.input_embedding
    torch.testing.assert_close(got[0, 1], got[0, 2])
    torch.testing.assert_close(got[0, 1], table[-1] * 8.0)  # sqrt(64)
    jmodel = JaxLAPConfig(**KW).create_module()
    # Under jit, as JAX runs it: eager indexing raises on the id instead.
    ref = jax.jit(lambda p, t: jmodel.apply({"params": p}, t, method=lambda m, t: m.llm.embed(t)))(
        params, jnp.asarray(ids.numpy()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=0)

    # A language-action span that holds an image block: its labels lie
    # outside the table, so the loss is NaN on both sides.
    arrays = obs_arrays(68)
    arrays["tokenized_langact_mask"] = np.broadcast_to(np.arange(T) >= 2, (B, T)) & arrays["tokenized_prompt_mask"]
    arrays["token_loss_mask"] = np.ones((B, T), bool)
    actions = np.zeros((B, 4, 7), np.float32)
    ref_loss, _ = jax.jit(lambda p, o: jmodel.apply({"params": p}, jax.random.PRNGKey(0), o, jnp.asarray(actions),
                                                    method=jmodel.compute_loss))(params, jax_observation(arrays))
    with torch.no_grad():
        loss, _ = port.compute_loss(port_observation(arrays), torch.from_numpy(actions),
                                    generator=torch.Generator().manual_seed(0))
    assert np.isnan(float(ref_loss)) and np.isnan(loss.item())


def _record_masks(monkeypatch, module, seen):
    attention = module.attention

    def recording(q, k, v, mask, **kw):
        if isinstance(mask, torch.Tensor):
            seen.append(mask.numpy())
        else:  # JAX, under jit: eager indexing raises on the END_IMAGE id
            jax.debug.callback(lambda m: seen.append(np.asarray(m)), mask, ordered=True)
        return attention(q, k, v, mask, **kw)

    monkeypatch.setattr(module, "attention", recording)


def test_the_sliding_window_compares_positions_with_slots(params, monkeypatch):
    """Every attention call of the gemma3 backbone gets the same mask on both
    sides through a flow request and an AR request, with the reference's
    quirk: the local layers' window compares the queries' RoPE positions with
    the keys' cache slots. So, with the prompt padded, the AR decode step's
    query does not see its own key, the flow suffix's queries see none of
    the action keys, and valid prefill rows below ``prefix_start`` see no
    key at all, on every local layer."""
    arrays = obs_arrays(69)
    noise = np.random.default_rng(70).standard_normal((B, 4, 7)).astype(np.float32)
    jmodel = JaxLAPConfig(**KW, attn_impl="xla").create_module()
    port = port_model(params, attn_impl="xla")
    jax_seen, port_seen = [], []
    _record_masks(monkeypatch, jax_gemma3, jax_seen)
    _record_masks(monkeypatch, port_gemma, port_seen)  # gemma3.Attention attends through gemma's
    jax.jit(lambda p, o, n: jmodel.apply({"params": p}, jax.random.PRNGKey(0), o, noise=n, num_steps=1,
                                         method=jmodel.sample_actions))(params, jax_observation(arrays),
                                                                        jnp.asarray(noise))
    jax.jit(lambda p, o: jmodel.apply({"params": p}, o, 1, method=_jax_greedy))(params, jax_observation(arrays))
    jax.effects_barrier()
    port.sample_actions(port_observation(arrays), noise=torch.from_numpy(noise), num_steps=1)
    _port_greedy(port, port_observation(arrays), 1)
    assert len(port_seen) == len(jax_seen) == 4 * 6
    for got, ref in zip(port_seen, jax_seen, strict=True):
        np.testing.assert_array_equal(got, ref)

    local = [i for i in range(6) if i != 5]
    suffix, prefill, decode = port_seen[6:12], port_seen[12:18], port_seen[18:24]
    for i in local:
        assert not suffix[i][:, :, T:].any()  # no action key on a local layer
        assert not decode[i][:, 0, T:].any()  # nor the decode step's own key
        valid = np.asarray(VALID)
        dead = ~prefill[i].any(axis=-1)  # [B, T]: right-aligned rows
        for b in range(B):
            assert dead[b, T - valid[b]:].sum() > 0  # valid rows with no key
    assert suffix[5][:, :, T:].all() and decode[5][:, 0, T].all()  # the global layer sees them


def _unstacked(params):
    p = dict(params)
    p["llm"] = jax_gemma.unstack_layer_params(dict(p["llm"]), 6)
    return p


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_ar_logits_match_jax(params, mode, monkeypatch):
    """JAX's quantized serving layout (``scan_layers=False``, its "quant"
    collection carried across) at thresholds that quantize the dummy
    widths: the decode steps and the flow suffix take the dequant matmuls,
    the 80-row prefill the exact product."""
    for m in (jax_lora, lora):
        monkeypatch.setattr(m, "QUANT_MIN_WEIGHT_ELEMS", 4096)
        monkeypatch.setattr(m, "QUANT_MAX_ROWS", 32)
    jcfg = JaxLAPConfig(**KW, attn_impl="xla", scan_layers=False, quant=mode)
    jmodel = jcfg.create_module()
    p_u = _unstacked(params)
    _, qvars = jax.jit(lambda v: jmodel.apply(v, jax.random.PRNGKey(0), method=jmodel.init_params_fn,
                                              mutable=["quant"]))({"params": p_u})
    quant = jax.tree.map(np.asarray, qvars["quant"])
    paths = list(flatten(quant))
    assert any("gating_w_i" in k for k in paths) and any("decode_w_i" in k for k in paths)
    variables = {"params": p_u, "quant": quant}
    port = port_model(params, attn_impl="xla")
    convert.load_jax_quant(port, quant)

    arrays = obs_arrays(71)
    ref_tokens, ref_logits = jax.jit(lambda v, o: jmodel.apply(v, o, STEPS, method=_jax_greedy))(
        variables, jax_observation(arrays))
    tokens, logits = _port_greedy(port, port_observation(arrays), STEPS)
    np.testing.assert_array_equal(tokens, np.asarray(ref_tokens))
    _assert_logits_match(logits, ref_logits)

    noise = np.random.default_rng(72).standard_normal((B, 4, 7)).astype(np.float32)
    ref = jax.jit(lambda v, o, n: jmodel.apply(v, jax.random.PRNGKey(0), o, noise=n, num_steps=2,
                                               method=jmodel.sample_actions))(
        variables, jax_observation(arrays), jnp.asarray(noise))
    got = port.sample_actions(port_observation(arrays), noise=torch.from_numpy(noise), num_steps=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    port.quantize_(None)
    exact = port.sample_actions(port_observation(arrays), noise=torch.from_numpy(noise), num_steps=2)
    assert (got - exact).abs().max().item() > 1e-5  # the expert MLPs went through the dequant matmuls


def test_freeze_filters_split_the_gemma3_names_like_jax(params):
    from lap_tpu.models.lap_model import get_vlm_freeze_filter as jax_vlm_freeze
    from lap_tpu_torch.models import lap_model as port_lap
    from torch_port_helpers import unflatten

    port = port_model(params)
    frozen = port_lap.get_vlm_freeze_filter(port.config)
    jax_frozen = jax_vlm_freeze(JaxLAPConfig(**KW))
    marks = {k: np.full(np.shape(v), float(jax_frozen(k)), np.float32) for k, v in flatten(params).items()}
    expected = {n: bool(v.max().item()) for n, v in convert.from_jax_params(unflatten(marks)).items()}
    got = {n: frozen(n) for n, _ in port.named_parameters()}
    assert got == expected
    assert got["llm.layers.0.post_ffw_norm.scale"] and got["llm.layers.0.attn.q_rmsnorm.scale"]
    assert not got["llm.layers.0.mlp.1.gating_einsum"]


def test_a_padded_camera_keeps_its_image_block_bidirectional(params):
    """A camera whose mask is False: its placeholders take the False mask as
    input mask, yet the image mask (the placeholder ids) still ORs its block
    into the attention, as in JAX."""
    arrays = obs_arrays(73)
    arrays["image_masks"]["left_wrist_0_rgb"] = np.array([True, False])
    noise = np.random.default_rng(74).standard_normal((B, 4, 7)).astype(np.float32)
    jmodel = JaxLAPConfig(**KW).create_module()
    ref = jax.jit(lambda p, o, n: jmodel.apply({"params": p}, jax.random.PRNGKey(0), o, noise=n, num_steps=2,
                                               method=jmodel.sample_actions))(
        params, jax_observation(arrays), jnp.asarray(noise))
    got = port_model(params).sample_actions(port_observation(arrays), noise=torch.from_numpy(noise), num_steps=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    ref_tokens = np.asarray(jax.jit(lambda p, o: jmodel.apply(
        {"params": p}, jax.random.PRNGKey(0), o, max_decoding_steps=4, stop_on_eos=False,
        method=jmodel.sample_tokens))(params, jax_observation(arrays)))
    got_tokens = port_model(params).sample_tokens(port_observation(arrays), max_decoding_steps=4, stop_on_eos=False)
    np.testing.assert_array_equal(got_tokens.numpy(), ref_tokens)
