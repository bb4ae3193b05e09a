"""The port's training loss against lap_tpu on the CPU, module by module.

Dummy variants, f32 on both sides, inputs and parameters from numpy seeds
(carried across by the weight bridge), JAX's random draws replayed and handed
to the port. Tolerances: outputs and losses atol/rtol 2e-5; gradient leaves
``1e-4 * max|leaf| + 2e-6`` absolute (measured up to 3.6e-5 of the leaf's
largest entry: the sine-cosine time embedding takes sin of angles up to
~1600 rad, where one f32 ulp of the period moves the value by 1e-4, and that
difference runs through the adaRMS conditioning into every gradient; a wrong
term would show at the size of the leaf); augmentation 2e-5 on images in
[-1, 1].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.data import registry as jax_registry  # noqa: E402
from lap_tpu.data import vqa as _jax_vqa  # noqa: E402,F401  (registers the VQA datasets)
from lap_tpu.models import gemma as jax_gemma  # noqa: E402
from lap_tpu.models import preprocessing as jax_pre  # noqa: E402
from lap_tpu.models.lap_model import LAPConfig as JaxLAPConfig  # noqa: E402
from lap_tpu_torch.models import gemma as port_gemma  # noqa: E402
from lap_tpu_torch.models import lap_model as port_lap  # noqa: E402
from lap_tpu_torch.models import preprocessing as port_pre  # noqa: E402
from lap_tpu_torch.models.convert import from_jax_params, load_jax_params  # noqa: E402
from lap_tpu_torch.models.lap_model import LAP, LAPConfig  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    TORCH_THREADS,
    holder,
    jax_loss_randomness,
    jax_observation,
    port_aug_params,
    port_observation,
    randomize_params,
    replay_augment_draws,
    replay_preprocess_draws,
    tiny_lap_config_kwargs,
    train_obs_arrays,
)

torch.set_num_threads(TORCH_THREADS)
TOL = dict(atol=2e-5, rtol=2e-5)


def assert_grads_match(named_grads: dict, jax_grads, *, expect_zero=()):
    """Every port gradient against its JAX leaf (a missing one counts as 0)."""
    ref = from_jax_params(jax.tree.map(np.asarray, jax_grads))
    assert set(ref) == set(named_grads)
    for name, grad in named_grads.items():
        got = np.zeros(ref[name].shape, np.float32) if grad is None else grad.numpy()
        want = ref[name].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 2e-6,
                                   err_msg=name)
    for name in expect_zero:
        assert named_grads[name] is None or named_grads[name].abs().max().item() == 0.0, name


# ---------------------------------------------------------------------------
# (b) gemma.Module with stop_action_to_vlm_grad
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stop_grad_gemma():
    cfg = jax_gemma.get_config("dummy")
    jmod = jax_gemma.Module(configs=[cfg, cfg], embed_dtype="float32", adarms=True,
                            attn_impl="xla", stop_action_to_vlm_grad=True)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), [False, True], method=jmod.init_params))
    params = randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 51)
    pmod = port_gemma.Module(
        [port_gemma.get_config("dummy")] * 2, use_adarms=[False, True], embed_dtype=torch.float32,
        attn_impl="xla", stop_action_to_vlm_grad=True, device="cpu", dtype=torch.float32,
    )
    load_jax_params(holder(llm=pmod), {"llm": params})
    return jmod, params, pmod


def _joint_inputs(seed, b=2, p=10, s=4, width=64):
    rng = np.random.default_rng(seed)
    prefix = rng.standard_normal((b, p, width)).astype(np.float32)
    suffix = rng.standard_normal((b, s, width)).astype(np.float32)
    cond = rng.standard_normal((b, width)).astype(np.float32)
    mask = np.tril(np.ones((p + s, p + s), bool))[None].repeat(b, 0)
    mask[:, :p, p:] = False
    pos = np.broadcast_to(np.arange(p + s), (b, p + s)).astype(np.int32)
    w0 = rng.standard_normal((b, p, width)).astype(np.float32)
    w1 = rng.standard_normal((b, s, width)).astype(np.float32)
    return prefix, suffix, cond, mask, pos, w0, w1


@pytest.mark.parametrize("remat_policy", ["nothing_saveable", "none"])
def test_gemma_stop_gradient_outputs_and_every_gradient_match_jax(stop_grad_gemma, remat_policy):
    """The joint training pass (both experts live, no cache): outputs, and the
    gradient of every leaf of a loss over both experts' outputs."""
    jmod, params, pmod = stop_grad_gemma
    prefix, suffix, cond, mask, pos, w0, w1 = _joint_inputs(52)
    j = jnp.asarray

    def jax_loss(p):
        (o0, o1), _ = jmod.apply({"params": p}, [j(prefix), j(suffix)], j(pos), j(mask), [None, j(cond)])
        return jnp.sum(o0 * w0) + jnp.sum(o1 * w1), (o0, o1)

    (_, (j0, j1)), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(params)

    pmod.remat_policy = remat_policy
    pmod.zero_grad(set_to_none=True)
    t = torch.from_numpy
    (p0, p1), cache = pmod([t(prefix), t(suffix)], t(pos), t(mask), [None, t(cond)], want_cache=False)
    assert cache is None
    np.testing.assert_allclose(p0.detach().numpy(), np.asarray(j0), **TOL)
    np.testing.assert_allclose(p1.detach().numpy(), np.asarray(j1), **TOL)
    ((p0 * t(w0)).sum() + (p1 * t(w1)).sum()).backward()
    assert_grads_match({f"llm.{n}": p.grad for n, p in pmod.named_parameters()}, {"llm": jgrads})


def test_action_loss_gives_expert0_keys_and_values_no_gradient(stop_grad_gemma):
    """A loss on the action expert's output alone: the expert-0 K/V projection
    gets exactly no gradient (and no other expert-0 weight does either, since
    expert-0 queries do not feed it); without the flag it does."""
    jmod, params, pmod = stop_grad_gemma
    prefix, suffix, cond, mask, pos, _, w1 = _joint_inputs(53)
    j, t = jnp.asarray, torch.from_numpy

    def jax_loss(p):
        (_, o1), _ = jmod.apply({"params": p}, [j(prefix), j(suffix)], j(pos), j(mask), [None, j(cond)])
        return jnp.sum(o1 * w1)

    jgrads = jax.grad(jax_loss)(params)
    pmod.zero_grad(set_to_none=True)
    (_, p1), _ = pmod([t(prefix), t(suffix)], t(pos), t(mask), [None, t(cond)], want_cache=False)
    (p1 * t(w1)).sum().backward()
    grads = {f"llm.{n}": p.grad for n, p in pmod.named_parameters()}
    kv0 = [n for n in grads if ".kv_einsum.0." in n]
    assert len(kv0) == 4
    assert_grads_match(grads, {"llm": jgrads}, expect_zero=kv0)
    assert grads["llm.layers.0.attn.kv_einsum.1.w"].abs().max().item() > 0

    for block in pmod.layers:
        block.attn.stop_action_to_vlm_grad = False
    try:
        pmod.zero_grad(set_to_none=True)
        (_, p1), _ = pmod([t(prefix), t(suffix)], t(pos), t(mask), [None, t(cond)], want_cache=False)
        (p1 * t(w1)).sum().backward()
        assert pmod.layers[0].attn.kv_einsum[0].w.grad.abs().max().item() > 0
    finally:
        for block in pmod.layers:
            block.attn.stop_action_to_vlm_grad = True


def test_stop_gradient_split_leaves_serving_calls_alone(stop_grad_gemma, monkeypatch):
    """The split needs the joint pass: a prefill (expert 0 alone), a cached
    suffix step and a single-token AR decode step make one attention call per
    layer."""
    _, _, pmod = stop_grad_gemma
    prefix, suffix, cond, mask, pos, _, _ = _joint_inputs(54)
    t = torch.from_numpy
    calls = []
    real = port_gemma.attention
    monkeypatch.setattr(port_gemma, "attention", lambda *a, **k: calls.append(a[0].shape[1]) or real(*a, **k))
    p, s = prefix.shape[1], suffix.shape[1]
    with torch.no_grad():
        _, cache = pmod([t(prefix), None], t(pos[:, :p]), t(mask[:, :p, :p]), [None, None])
        assert calls == [p] * len(pmod.layers)
        calls.clear()
        pmod([None, t(suffix)], t(pos[:, p:]), t(mask[:, p:]), [None, t(cond)], kv_cache=cache)
        assert calls == [s] * len(pmod.layers)
        calls.clear()
        pmod([t(prefix), t(suffix)], t(pos), t(mask), [None, t(cond)], want_cache=False)
        assert calls == [p, s] * len(pmod.layers)
        # AR decode needs a cache with room for the token: a prefill padded by one key.
        roomy = np.pad(mask[:, :p, :p], ((0, 0), (0, 0), (0, 1)))
        _, cache = pmod([t(prefix), None], t(pos[:, :p]), t(roomy), [None, None])
        calls.clear()
        step_mask = np.ones((prefix.shape[0], 1, p + 1), bool)
        pmod([t(prefix[:, :1]), None], t(pos[:, :1]), t(step_mask), [None, None], kv_cache=cache)
        assert calls == [1] * len(pmod.layers)


def test_decode_logits_match_jax(stop_grad_gemma):
    jmod, params, pmod = stop_grad_gemma
    x = np.random.default_rng(55).standard_normal((2, 3, 64)).astype(np.float32)
    ref = jmod.apply({"params": params}, jnp.asarray(x), method=jmod.decode_logits)
    np.testing.assert_allclose(pmod.decode_logits(torch.from_numpy(x)).detach().numpy(), np.asarray(ref), **TOL)


def test_remat_policy_is_checked():
    with pytest.raises(ValueError, match="remat_policy"):
        port_gemma.Module([port_gemma.get_config("dummy")], remat_policy="dots_saveable", device="cpu")


# ---------------------------------------------------------------------------
# (c) augmentation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 28, 28, 3), (2, 40, 56, 3)])
def test_augmentation_matches_jax_on_the_same_random_values(shape):
    b, h, w, _ = shape
    images = np.random.default_rng(60).uniform(-1, 1, shape).astype(np.float32)
    rng = jax.random.PRNGKey(61)
    ref = np.asarray(jax_pre.augment_images(jnp.asarray(images), rng))
    params = port_aug_params({"cam": replay_augment_draws(rng, b, h, w)})["cam"]
    got = port_pre.augment_images(torch.from_numpy(images), params).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert np.abs(got - images).max() > 0.05  # it did something


def test_preprocess_train_branch_matches_jax_with_vqa_mask_and_wrist_switch():
    kw = tiny_lap_config_kwargs()
    arrays = train_obs_arrays(62, batch=3, valid=[16, 9, 12], cfg_kw=kw)
    arrays["images"] = {k: ((v + 1) * 127.5).astype(np.uint8) for k, v in arrays["images"].items()}
    rng = jax.random.PRNGKey(63)
    vqa = np.array([False, True, False])
    keys = ("base_0_rgb", "left_wrist_0_rgb")
    aug = port_aug_params(replay_preprocess_draws(rng, image_keys=keys, batch=3, resolution=(28, 28)))
    for aug_wrist in (True, False):
        ref = jax_pre.preprocess_observation(
            rng, jax_observation(arrays), train=True, image_resolution=(28, 28),
            aug_wrist_image=aug_wrist, vqa_mask=jnp.asarray(vqa),
        )
        got = port_pre.preprocess_observation(
            port_observation(arrays), train=True, image_resolution=(28, 28),
            aug_wrist_image=aug_wrist, vqa_mask=torch.from_numpy(vqa), aug_params=aug,
        )
        for key in keys:
            np.testing.assert_allclose(got.images[key].numpy(), np.asarray(ref.images[key]), **TOL)
        plain = arrays["images"]["left_wrist_0_rgb"].astype(np.float32) / 127.5 - 1.0
        same = np.abs(got.images["left_wrist_0_rgb"].numpy() - plain).max(axis=(1, 2, 3)) == 0
        assert list(same) == ([False, True, False] if aug_wrist else [True, True, True])


def test_augment_params_draw_is_seeded_and_in_range():
    gen = torch.Generator().manual_seed(3)
    p1 = port_pre.AugmentParams.draw(64, 224, 224, generator=gen)
    p2 = port_pre.AugmentParams.draw(64, 224, 224, generator=torch.Generator().manual_seed(3))
    assert torch.equal(p1.crop_y, p2.crop_y) and torch.equal(p1.angle, p2.angle)
    assert 0 <= int(p1.crop_y.min()) and int(p1.crop_x.max()) <= 224 - int(224 * 0.95)
    assert float(p1.angle.abs().max()) <= 5.0 * np.pi / 180 and float(p1.angle.abs().max()) > 0
    for f in (p1.brightness, p1.contrast, p1.saturation):
        assert 0.8 <= float(f.min()) and float(f.max()) <= 1.2


# ---------------------------------------------------------------------------
# (d), (e) the loss
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lap_params():
    cfg = JaxLAPConfig(**tiny_lap_config_kwargs())
    model = cfg.create_module()
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=model.init_params_fn)
    )
    return randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 71)


def _port_model(params, **cfg_overrides):
    model = LAP(LAPConfig(**tiny_lap_config_kwargs(**cfg_overrides)), device="cpu", init_seed=None)
    return load_jax_params(model, params)


def test_token_logp_single_shot_chunked_and_jax_agree(lap_params):
    """18 positions: single-shot (CE_CHUNK 256), chunked with CE_CHUNK lowered
    to 5 on the instance (a ragged last chunk), and JAX's own chunked path."""
    rng = np.random.default_rng(72)
    pre = rng.standard_normal((2, 18, 64)).astype(np.float32)
    labels = rng.integers(0, 257_152, (2, 18)).astype(np.int32)
    port = _port_model(lap_params)
    tp, tl = torch.from_numpy(pre).requires_grad_(), torch.from_numpy(labels)
    logp, pred = port._token_logp_and_pred(tp, tl, need_pred=True)
    (g_single,) = torch.autograd.grad(logp.sum(), tp)
    port.CE_CHUNK = 5
    logp_c, pred_c = port._token_logp_and_pred(tp, tl, need_pred=True)
    table = port.llm.embedder.input_embedding
    g_chunk, g_table = torch.autograd.grad(logp_c.sum(), (tp, table))
    torch.testing.assert_close(logp_c, logp, atol=1e-5, rtol=1e-5)
    assert torch.equal(pred_c, pred)
    torch.testing.assert_close(g_chunk, g_single, atol=1e-6, rtol=1e-5)
    assert g_table.abs().max().item() > 0
    assert port._token_logp_and_pred(tp, tl, need_pred=False)[1] is None

    class Chunked(type(JaxLAPConfig(**tiny_lap_config_kwargs()).create_module())):
        CE_CHUNK: int = 5

    jmodel = Chunked(config=JaxLAPConfig(**tiny_lap_config_kwargs()))
    ref_logp, ref_pred = jmodel.apply(
        {"params": lap_params}, jnp.asarray(pre), jnp.asarray(labels), need_pred=True,
        method=jmodel._token_logp_and_pred,
    )
    np.testing.assert_allclose(logp_c.detach().numpy(), np.asarray(ref_logp), **TOL)
    np.testing.assert_array_equal(pred_c.numpy(), np.asarray(ref_pred))


# name, config overrides, extra observation fields, train (augmentation on)
LOSS_CASES = {
    "lap_like_stop_grad": (dict(stop_action_to_vlm_grad=True), {}, True),
    "action_only": (dict(enable_langact_training=False), {}, False),
    "vqa_pred_and_sample_mask": (
        dict(stop_action_to_vlm_grad=True, enable_vqa_training=True, enable_prediction_training=True,
             vqa_loss_weights={"coco_captions": 0.3, "pixmo_point": 0.7, "unknown": 9.0}, verbose_mode=True),
        dict(
            is_vqa_sample=np.array([True, False, True, False]),
            is_prediction_sample=np.array([False, True, False, False]),
            sample_mask=np.array([True, True, False, True]),
            vqa_dataset_id=np.array([1, 0, 7, 0], np.int32),
        ),
        True,
    ),
}


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_compute_loss_metrics_and_every_gradient_match_jax(lap_params, case, attn_impl):
    """``compute_loss`` against ``jax.value_and_grad(model.compute_loss)`` with
    the same augmentation, noise and time, through the einsum path and the
    flash path (lap_tpu runs its Pallas kernels in interpret mode on the CPU,
    the port its plain forward and backward)."""
    overrides, extras, train = LOSS_CASES[case]
    kw = tiny_lap_config_kwargs(attn_impl=attn_impl, **overrides)
    batch = 4 if extras else 2
    arrays = train_obs_arrays(73, batch=batch, valid=[14, 9, 16, 11][:batch], cfg_kw=kw)
    arrays.update(extras)
    actions = np.random.default_rng(74).standard_normal((batch, 4, 7)).astype(np.float32)
    rng = jax.random.PRNGKey(75)

    jcfg = JaxLAPConfig(**kw)
    jmodel = jcfg.create_module()

    def jax_loss(p):
        return jmodel.apply({"params": p}, rng, jax_observation(arrays), jnp.asarray(actions),
                            train=train, method=jmodel.compute_loss)

    (ref_loss, ref_metrics), ref_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(lap_params)

    draws = jax_loss_randomness(rng, image_keys=jcfg.image_keys, batch=batch, resolution=(28, 28),
                                action_shape=actions.shape)
    port = _port_model(lap_params, attn_impl=attn_impl, **overrides)
    loss, metrics = port.compute_loss(
        port_observation(arrays), torch.from_numpy(actions), train=train,
        noise=torch.from_numpy(draws["noise"].copy()), time=torch.from_numpy(draws["time"].copy()),
        aug_params=port_aug_params(draws["aug"]),
    )
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), **TOL)
    assert set(metrics) == set(ref_metrics)
    for name, ref in ref_metrics.items():
        np.testing.assert_allclose(metrics[name].detach().numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5,
                                   err_msg=name)
    grads = {n: p.grad for n, p in port.named_parameters()}
    # With the action gradient stopped and no language loss, or in the
    # action-only case, the VLM's final norm gets no gradient at all.
    assert_grads_match(grads, ref_grads)
    if not kw.get("enable_langact_training", True):
        assert grads["llm.final_norm.0.scale"] is None


def test_action_loss_leaves_vlm_keys_alone_in_compute_loss(lap_params):
    """lap-like config without the language loss: the action loss reaches the
    VLM only through its queries' own rows, never through expert-0 K/V."""
    port = _port_model(lap_params, stop_action_to_vlm_grad=True, enable_langact_training=False)
    kw = tiny_lap_config_kwargs()
    arrays = train_obs_arrays(76, batch=2, valid=[12, 16], cfg_kw=kw)
    actions = torch.from_numpy(np.random.default_rng(77).standard_normal((2, 4, 7)).astype(np.float32))
    loss, _ = port.compute_loss(port_observation(arrays), actions, generator=torch.Generator().manual_seed(0))
    loss.backward()
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert all(g is None or g.abs().max().item() == 0 for n, g in grads.items()
               if n.startswith("img.") or (n.startswith("llm.") and not port_lap.is_action_expert_param(n)))
    assert grads["llm.layers.0.attn.kv_einsum.1.w"].abs().max().item() > 0
    assert grads["action_in_proj.weight"].abs().max().item() > 0


def test_compute_loss_draws_from_the_generator_when_nothing_is_given(lap_params):
    port = _port_model(lap_params, stop_action_to_vlm_grad=True)
    kw = tiny_lap_config_kwargs()
    obs = port_observation(train_obs_arrays(78, batch=2, valid=[12, 16], cfg_kw=kw))
    actions = torch.from_numpy(np.random.default_rng(79).standard_normal((2, 4, 7)).astype(np.float32))
    with torch.no_grad():
        a = port.compute_loss(obs, actions, train=True, generator=torch.Generator().manual_seed(1))[0]
        b = port.compute_loss(obs, actions, train=True, generator=torch.Generator().manual_seed(1))[0]
        c = port.compute_loss(obs, actions, train=True, generator=torch.Generator().manual_seed(2))[0]
    assert a.item() == b.item() and a.item() != c.item() and np.isfinite(a.item())


def test_vqa_dataset_ids_are_the_jax_registry_ones():
    assert port_lap.VQA_DATASET_ID_MAP == jax_registry.VQA_DATASET_ID_MAP


def test_freeze_filters_partition_the_port_names_like_jax(lap_params):
    from lap_tpu.models.lap_model import get_freeze_filter as jax_freeze
    from lap_tpu.models.lap_model import get_vlm_freeze_filter as jax_vlm_freeze
    from torch_port_helpers import flatten

    port = _port_model(lap_params)
    cfg = port.config
    frozen = port_lap.get_vlm_freeze_filter(cfg)
    jax_frozen = jax_vlm_freeze(JaxLAPConfig(**tiny_lap_config_kwargs()))
    # Push a marker through the bridge: 1.0 where JAX freezes, 0.0 elsewhere.
    marks = {k: np.full(np.shape(v), float(jax_frozen(k)), np.float32) for k, v in flatten(lap_params).items()}
    from torch_port_helpers import unflatten

    expected = {n: bool(v.max().item()) for n, v in from_jax_params(unflatten(marks)).items()}
    got = {n: frozen(n) for n, _ in port.named_parameters()}
    assert got == expected
    assert sum(got.values()) > 0 and not all(got.values())
    assert not got["llm.layers.0.mlp.1.linear"] and got["llm.layers.0.mlp.0.linear"]
    assert got["llm.embedder.input_embedding"] and not got["action_out_proj.weight"]
    assert port_lap.get_freeze_filter(cfg) is None and jax_freeze(JaxLAPConfig(**tiny_lap_config_kwargs())) is None
