"""LoRA in the port (``lap_tpu_torch/models/lora.py``, ``gemma.py``,
``gemma3.py``, the freeze filter of ``lap_model.py``) against lap_tpu's on
the CPU.

- ``Einsum`` with adapters at each of the backbone's equations, and the
  Gemma and Gemma3 ``FeedForward`` with adapters: forward and the gradients
  of every input and parameter against JAX, f32, atol/rtol 2e-5 (gradients
  2e-5 of the leaf's largest entry). ``lora_b`` is random too: at its zero
  init a parity test would prove nothing about the adapter path.
- The freeze filter freezes exactly the leaves JAX's regex rule freezes, on
  every leaf of the JAX tree: at ``dummy_lora`` (the JAX tree from its init)
  and at full width (``jax.eval_shape``, names only), for a LoRA VLM, a LoRA
  action expert and both; and ``freeze_vlm``'s rule on the same trees.
- An adapted weight never quantizes, its unadapted neighbours still do: the
  quantized buffers equal JAX's "quant" collection, and a decode step's
  dequant launches drop by exactly the adapted weights it calls.
- Two ``dummy_lora`` training steps against lap_tpu's partitioned step
  (AdamW): loss and norms rtol 5e-5, moments rtol 2e-4 + atol 2e-6,
  parameters rtol 2e-4 + atol 1e-3 (the learning rate: Adam's normalised
  update, see the test); the frozen leaves' bits unchanged and the
  optimizer state on the trainable leaves JAX keeps it on.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.models import gemma3 as jax_gemma3  # noqa: E402
from lap_tpu.models import lora as jax_lora  # noqa: E402
from lap_tpu.models.lap_model import LAPConfig as JaxLAPConfig  # noqa: E402
from lap_tpu.models.lap_model import get_freeze_filter as jax_freeze_filter  # noqa: E402
from lap_tpu.models.lap_model import get_vlm_freeze_filter as jax_vlm_freeze_filter  # noqa: E402
from lap_tpu.training import optimizer as jax_opt  # noqa: E402
from lap_tpu.training import train_step as jax_train_step  # noqa: E402
from lap_tpu_torch.models import convert, lora  # noqa: E402
from lap_tpu_torch.models import gemma as port_gemma  # noqa: E402
from lap_tpu_torch.models import gemma3 as port_gemma3  # noqa: E402
from lap_tpu_torch.models.lap_model import LAPConfig, get_freeze_filter, get_vlm_freeze_filter  # noqa: E402
from lap_tpu_torch.ops import int8_matmul as port_int8  # noqa: E402
from lap_tpu_torch.training import optimizer as port_opt  # noqa: E402
from lap_tpu_torch.training.train_step import make_step_functions  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    TORCH_THREADS,
    flatten,
    jax_loss_randomness,
    jax_observation,
    port_aug_params,
    port_observation,
    randomize_params,
    tiny_lap_config_kwargs,
    train_obs_arrays,
)

torch.set_num_threads(TORCH_THREADS)
TOL = dict(atol=2e-5, rtol=2e-5)
CFG = lora.LoRAConfig(rank=4, alpha=8.0)
SMALL_MIN_ELEMS = 4096


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _grads_match(got: dict, ref: dict):
    for name, g in got.items():
        want = np.asarray(ref[name])
        np.testing.assert_allclose(g, want, rtol=0, atol=2e-5 * np.abs(want).max() + 1e-7, err_msg=name)


EINSUMS = [
    # JAX equation, the port's, weight shape (the backbone's q, kv, qkv and attn_vec)
    ("BTD,NDH->BTNH", port_gemma.Attention.Q_EQN, (8, 32, 16)),
    ("BSD,2KDH->2BSKH", port_gemma.Attention.QKV_EQN, (2, 2, 32, 16)),
    ("BSD,3KDH->3BSKH", port_gemma.Attention.QKV_EQN, (3, 8, 32, 16)),
    ("BTNH,NHD->BTD", port_gemma.Attention.ATTN_VEC_EQN, (8, 16, 32)),
]


@pytest.mark.parametrize("jax_eqn,eqn,shape", EINSUMS)
def test_einsum_with_adapters_matches_jax(jax_eqn, eqn, shape):
    rng = np.random.default_rng(90)
    *batch, d_in, d_out = shape
    params = {"w": _rand(rng, shape, 0.2), "lora_a": _rand(rng, (*batch, d_in, 4), 0.3),
              "lora_b": _rand(rng, (*batch, 4, d_out), 0.3)}
    x = _rand(rng, (2, 3, 8, 16) if jax_eqn.startswith("BTNH") else (2, 3, 32))
    jmod = jax_lora.Einsum(shape=shape, init_fn=jax.nn.initializers.zeros, lora_config=CFG)
    out_shape = jax.eval_shape(lambda: jmod.apply({"params": params}, jax_eqn, jnp.asarray(x))).shape
    r = _rand(rng, out_shape)

    def jax_fn(p, x_):
        return jnp.sum(jmod.apply({"params": p}, jax_eqn, x_) * r)

    ref_out = jmod.apply({"params": params}, jax_eqn, jnp.asarray(x))
    ref_grads = jax.grad(jax_fn, argnums=(0, 1))(params, jnp.asarray(x))
    port = lora.Einsum(shape, eqn, d_in, lora_config=CFG)
    with torch.no_grad():
        for k, v in params.items():
            getattr(port, k).copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), **TOL)
    (out * torch.from_numpy(r)).sum().backward()
    _grads_match({k: getattr(port, k).grad.numpy() for k in params} | {"x": xt.grad.numpy()},
                 {**ref_grads[0], "x": ref_grads[1]})
    assert port.quant_spec("int8") == {}  # an adapted weight never quantizes, whatever its size


@pytest.mark.parametrize("family", ["gemma", "gemma3"])
def test_feed_forward_with_adapters_matches_jax(family):
    rng = np.random.default_rng(91)
    d, f = 32, 48
    if family == "gemma":
        jmod = jax_lora.FeedForward(features=d, hidden_dim=f, lora_config=CFG)
        port = lora.FeedForward(d, f, lora_config=CFG)
        gating = (2, d, f)
    else:
        jmod = jax_gemma3.FeedForward(features=d, hidden_dim=f, lora_config=CFG)
        port = port_gemma3.FeedForward(d, f, lora_config=CFG)
        gating = (2, f, d)
    params = {"gating_einsum": _rand(rng, gating, 0.2), "linear": _rand(rng, (f, d), 0.2),
              "gating_lora_a": _rand(rng, (2, d, 4), 0.3), "gating_lora_b": _rand(rng, (2, 4, f), 0.3),
              "linear_lora_a": _rand(rng, (f, 4), 0.3), "linear_lora_b": _rand(rng, (4, d), 0.3)}
    assert {n: tuple(p.shape) for n, p in port.named_parameters()} == {k: v.shape for k, v in params.items()}
    x = _rand(rng, (2, 5, d))
    r = _rand(rng, (2, 5, d))
    ref_out = jmod.apply({"params": params}, jnp.asarray(x))
    ref_grads = jax.grad(lambda p, x_: jnp.sum(jmod.apply({"params": p}, x_) * r), argnums=(0, 1))(
        params, jnp.asarray(x))
    with torch.no_grad():
        for k, v in params.items():
            getattr(port, k).copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), **TOL)
    (out * torch.from_numpy(r)).sum().backward()
    _grads_match({k: getattr(port, k).grad.numpy() for k in params} | {"x": xt.grad.numpy()},
                 {**ref_grads[0], "x": ref_grads[1]})
    assert port.quant_spec("int8") == {}


def test_the_lora_variants_and_their_init():
    for variant, base, rank in (("gemma_2b_lora", "gemma_2b", 16), ("gemma_300m_lora", "gemma_300m", 32),
                                ("dummy_lora", "dummy", 4)):
        got, ref = port_gemma.get_config(variant), jax_lora_config(variant)
        assert got.lora_configs == {"attn": lora.LoRAConfig(rank, float(rank)), "ffn": lora.LoRAConfig(rank, float(rank))}
        assert {k: (v.rank, v.alpha, v.init_scale, v.scaling_value) for k, v in got.lora_configs.items()} == {
            k: (v.rank, v.alpha, v.init_scale, v.scaling_value) for k, v in ref.lora_configs.items()}
        assert got.width == port_gemma.get_config(base).width
    model = LAPConfig(**tiny_lap_config_kwargs(paligemma_variant="dummy_lora")).create_module(device="cpu",
                                                                                             init_seed=3)
    named = dict(model.named_parameters())
    # lora_b starts at zero (an adapted layer starts as its base), lora_a at N(0, 0.01).
    assert all(not p.any() for n, p in named.items() if n.endswith("lora_b"))
    a = torch.cat([p.flatten() for n, p in named.items() if n.endswith("lora_a")])
    assert 0.008 < a.std().item() < 0.012
    assert not any("lora" in n for n in named if "_1/" in convert.jax_path(n))  # the plain action expert has none


def jax_lora_config(variant):
    from lap_tpu.models import gemma as jax_gemma

    return jax_gemma.get_config(variant)


def _jax_tree_paths(kw: dict) -> dict:
    model = JaxLAPConfig(**kw).create_module()
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=model.init_params_fn))["params"]
    return {k: tuple(v.shape) for k, v in flatten(shapes).items()}


PAIRS = [("lora", "plain"), ("plain", "lora"), ("lora", "lora")]


def _variants(pair, full: bool):
    names = {("lora", True): ("gemma_2b_lora", "gemma_300m_lora"), ("plain", True): ("gemma_2b", "gemma_300m"),
             ("lora", False): ("dummy_lora", "dummy_lora"), ("plain", False): ("dummy", "dummy")}
    return names[(pair[0], full)][0], names[(pair[1], full)][1]


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("pair", PAIRS)
def test_the_freeze_filter_freezes_the_leaves_jax_freezes(pair, full):
    vlm, expert = _variants(pair, full)
    kw = dict(paligemma_variant=vlm, action_expert_variant=expert, enable_action_training=True)
    if not full:
        kw = tiny_lap_config_kwargs(**kw)
    jax_paths = _jax_tree_paths(kw)
    port = LAPConfig(**kw).create_module(device="meta", init_seed=None)
    names = [n for n, _ in port.named_parameters()]
    template = convert.jax_params_template(port)
    assert {k: tuple(v.shape) for k, v in template.items()} == jax_paths
    for port_rule, jax_rule in ((get_freeze_filter, jax_freeze_filter), (get_vlm_freeze_filter, jax_vlm_freeze_filter)):
        frozen, ref = port_rule(port.config), jax_rule(JaxLAPConfig(**kw))
        got = {convert.jax_path(n): frozen(n) for n in names}
        assert set(got) == set(jax_paths)
        assert got == {p: ref(p) for p in jax_paths}
    frozen = get_freeze_filter(port.config)
    trainable = [n for n in names if not frozen(n)]
    lora_names = [n for n in names if "lora" in n]
    llm_plain = [n for n in names if n.startswith("llm.") and "lora" not in n]
    # Frozen: exactly the adapted experts' llm leaves but the adapters; the
    # image encoder and the action projections train.
    assert lora_names and set(lora_names) <= set(trainable)
    assert any(n.startswith("img.") for n in trainable) and "action_out_proj.weight" in trainable
    if pair == ("lora", "lora"):
        assert not set(llm_plain) & set(trainable)


@pytest.fixture
def small_threshold(monkeypatch):
    monkeypatch.setattr(jax_lora, "QUANT_MIN_WEIGHT_ELEMS", SMALL_MIN_ELEMS)
    monkeypatch.setattr(lora, "QUANT_MIN_WEIGHT_ELEMS", SMALL_MIN_ELEMS)


def _count_dequant(monkeypatch):
    calls = []
    real = port_int8.int8_matmul

    def counting(x, *a, **kw):
        calls.append(tuple(x.shape))
        return real(x, *a, **kw)

    monkeypatch.setattr(port_int8, "int8_matmul", counting)
    return calls


@pytest.mark.parametrize("pair", PAIRS + [("plain", "plain")])
def test_an_adapted_weight_never_quantizes_and_its_neighbours_do(small_threshold, monkeypatch, pair):
    """The quantized buffers are JAX's "quant" collection's (the one-expert
    decode head included); one AR decode step calls the dequant matmul for
    every unadapted quantized weight of the VLM and the head, one flow step
    for the action expert's: the adapted ones drop out, one launch each."""
    vlm, expert = _variants(pair, False)
    kw = tiny_lap_config_kwargs(paligemma_variant=vlm, action_expert_variant=expert, enable_langact_training=True)
    jmodel = JaxLAPConfig(**kw, scan_layers=False, quant="int8").create_module()
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=jmodel.init_params_fn))
    jquant = flatten(shapes["quant"]) if "quant" in shapes else {}
    port = LAPConfig(**kw).create_module(device="cpu", init_seed=5)
    port.quantize_("int8")
    buffers = {n for n, _ in port.named_buffers() if n.rsplit(".", 1)[-1].endswith(("w_i8", "scale"))}
    assert buffers == set(convert.from_jax_quant({k: np.zeros(v.shape, v.dtype) for k, v in jquant.items()}))

    # Quantizable (>= the threshold, kv_einsum is not) weights a layer calls: q, attn_vec, gating, linear.
    per_expert = {"lora": 0, "plain": 4}
    depth = 4
    calls = _count_dequant(monkeypatch)
    arrays = train_obs_arrays(92, batch=1, valid=[14], cfg_kw=kw)
    state = port.ar_prefill(port_observation(arrays), 2)  # 24 rows: within QUANT_MAX_ROWS, as a step
    assert len(calls) == depth * per_expert[pair[0]] + 1
    del calls[:]
    port.ar_step(state, torch.zeros((1, 1), dtype=torch.int32))
    assert len(calls) == depth * per_expert[pair[0]] + 1  # the VLM's unadapted weights and the head
    del calls[:]
    port.sample_actions(port_observation(arrays), num_steps=1, noise=torch.zeros((1, 4, 7)))
    assert len(calls) == depth * (per_expert[pair[0]] + per_expert[pair[1]])  # the prefill, then one suffix step


@pytest.fixture(scope="module")
def lora_params():
    kw = tiny_lap_config_kwargs(paligemma_variant="dummy_lora", action_expert_variant="dummy",
                                stop_action_to_vlm_grad=True)
    model = JaxLAPConfig(**kw).create_module()
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=model.init_params_fn))
    return kw, randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 93)


def _assert_tree_matches(named: dict, jax_tree, what, atol):
    ref = convert.from_jax_params(jax.tree.map(lambda x: None if x is None else np.asarray(x), jax_tree,
                                               is_leaf=lambda x: x is None))
    assert set(ref) == set(named), what
    for name, got in named.items():
        np.testing.assert_allclose(got.detach().numpy(), ref[name].numpy(), rtol=2e-4, atol=atol,
                                   err_msg=f"{what}: {name}")


def test_two_lora_train_steps_match_jax_and_keep_the_frozen_bits(lora_params):
    from lap_tpu.training.state import TrainState as JaxTrainState

    kw, params = lora_params
    arrays = train_obs_arrays(94, batch=2, valid=[14, 9], cfg_kw=kw)
    actions = np.random.default_rng(95).standard_normal((2, 4, 7)).astype(np.float32)
    rng = jax.random.PRNGKey(96)
    sched, adam = dict(warmup_steps=2, peak_lr=1e-3, decay_steps=10, decay_lr=1e-4), dict(weight_decay=0.01)
    jcfg = JaxLAPConfig(**kw)
    tx = jax_opt.AdamW(**adam).create(jax_opt.CosineDecaySchedule(**sched).create())
    freeze_mask = jax_opt.freeze_mask_from_filter(params, jax_freeze_filter(jcfg))
    fns = jax_train_step.make_step_functions(jcfg.create_module(), tx, freeze_mask=freeze_mask)
    jparams = jax.tree.map(jnp.asarray, params)
    trainable = jax.tree.map(lambda p, m: None if m else p, jparams, freeze_mask)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams, opt_state=tx.init(trainable),
                           ema_params=None)
    jstep = jax.jit(fns.train_step)

    port = convert.load_jax_params(LAPConfig(**kw).create_module(device="cpu", init_seed=None), params)
    steps = make_step_functions(port, port_opt.AdamW(**adam), port_opt.CosineDecaySchedule(**sched),
                                freeze_filter=get_freeze_filter(port.config))
    pstate = steps.init_fn()
    frozen = {n: p.detach().clone() for n, p in port.named_parameters() if n not in pstate.trainable}
    n_lora = sum(1 for n, _ in port.named_parameters() if "lora" in n)
    assert n_lora == 4 * (3 * 2 + 4)  # 4 layers x (q, kv, attn_vec: a and b) + (gating, linear: a and b)
    assert frozen and all("lora" not in n for n in frozen)
    assert len(pstate.opt_state.mu) == len(pstate.trainable)
    assert {convert.jax_path(n) for n in pstate.trainable} == {
        k for k, m in flatten(freeze_mask).items() if not m}  # the optimizer state's leaves are JAX's
    assert all(not p.requires_grad and p.grad is None for n, p in port.named_parameters() if n in frozen)
    before = {n: p.detach().clone() for n, p in port.named_parameters() if "lora" in n}
    batch = (port_observation(arrays), torch.from_numpy(actions))
    for step in range(2):
        jstate, jmetrics = jstep(rng, jstate, (jax_observation(arrays), jnp.asarray(actions)))
        draws = jax_loss_randomness(jax.random.fold_in(rng, step), image_keys=jcfg.image_keys, batch=2,
                                    resolution=(28, 28), action_shape=actions.shape)
        pstate, pmetrics = steps.train_step(
            pstate, batch, noise=torch.from_numpy(draws["noise"].copy()),
            time=torch.from_numpy(draws["time"].copy()), aug_params=port_aug_params(draws["aug"]),
        )
        for key in ("loss", "grad_norm", "param_norm", "action_loss", "lang_loss"):
            np.testing.assert_allclose(float(pmetrics[key]), float(jmetrics[key]), rtol=5e-5, err_msg=key)
    # Adam's normalised first steps move an entry by up to the learning rate
    # (1e-3) whatever the size of its gradient: entries whose gradient is
    # near zero (one of 2048 in an expert kv_einsum landed 2.2e-4 apart,
    # while every gradient leaf of this model matches JAX's to 1.1e-5 of its
    # largest entry) differ by a share of it. So the parameters are held at
    # the learning rate and the moments, linear in the gradients, tightly.
    _assert_tree_matches(pstate.params, jstate.params, "params", atol=1e-3)
    adam_state = jstate.opt_state[1][0]
    trainable = pstate.trainable
    _assert_tree_matches(dict(zip(trainable, pstate.opt_state.mu, strict=True)), adam_state.mu, "mu", 2e-6)
    _assert_tree_matches(dict(zip(trainable, pstate.opt_state.nu, strict=True)), adam_state.nu, "nu", 2e-6)
    now = dict(port.named_parameters())
    assert all(torch.equal(now[n], v) for n, v in frozen.items())  # bit for bit
    assert all(not torch.equal(now[n], v) for n, v in before.items())  # every adapter moved
    assert math.isfinite(float(pmetrics["loss"]))
