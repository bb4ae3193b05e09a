"""The port's optimizer and training step against optax and lap_tpu on the CPU.

f32 on both sides, dummy variants, numpy-seeded inputs. Tolerances: schedules
rtol 1e-6 plus 2e-7 of the peak (optax evaluates them in f32 as
``(init - peak) * (1 - t) + peak``, which cancels near step 0; the port uses
Python floats); three
optimizer steps on the same gradients atol 1e-7 + rtol 2e-5 on parameters,
moments and EMA; two whole training steps against lap_tpu's ``train_step``
rtol 2e-4 + atol 2e-6 on the moments and rtol 2e-4 + atol 1e-5 on parameters
and EMA (Adam's normalised update moves every weight by about the learning
rate, 1e-3 here, whatever its gradient's size, so an entry whose tiny gradient
is off by a percent moves by 1e-5 more or less; measured 2.2e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.models.lap_model import LAPConfig as JaxLAPConfig  # noqa: E402
from lap_tpu.models.lap_model import get_vlm_freeze_filter as jax_vlm_freeze_filter  # noqa: E402
from lap_tpu.training import config as jax_config  # noqa: E402
from lap_tpu.training import optimizer as jax_opt  # noqa: E402
from lap_tpu.training import train_step as jax_train_step  # noqa: E402
from lap_tpu.training.state import inference_params as jax_inference_params  # noqa: E402
from lap_tpu_torch.models.convert import from_jax_params, load_jax_params  # noqa: E402
from lap_tpu_torch.models.lap_model import LAP, LAPConfig, get_vlm_freeze_filter  # noqa: E402
from lap_tpu_torch.training import config as port_config  # noqa: E402
from lap_tpu_torch.training import optimizer as port_opt  # noqa: E402
from lap_tpu_torch.training import train as port_train  # noqa: E402
from lap_tpu_torch.training.state import inference_params  # noqa: E402
from lap_tpu_torch.training.train_step import make_step_functions  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    TORCH_THREADS,
    jax_loss_randomness,
    jax_observation,
    port_aug_params,
    port_observation,
    randomize_params,
    tiny_lap_config_kwargs,
    train_obs_arrays,
)

torch.set_num_threads(TORCH_THREADS)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

STEPS = [0, 1, 5, 9, 10, 11, 57, 99, 100, 101, 5000]


@pytest.mark.parametrize("fields", [
    dict(warmup_steps=10, peak_lr=1e-3, decay_steps=100, decay_lr=1e-4),
    dict(warmup_steps=5_000, peak_lr=1e-4, decay_steps=40_000, decay_lr=1e-5),
])
def test_cosine_schedule_matches_optax(fields):
    ref = jax_opt.CosineDecaySchedule(**fields).create()
    got = port_opt.CosineDecaySchedule(**fields)
    for step in STEPS + [39_999, 40_000, 50_000]:
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6, atol=2e-7 * fields["peak_lr"],
                                   err_msg=str(step))
    assert got(0) == fields["peak_lr"] / (fields["warmup_steps"] + 1)


def test_rsqrt_schedule_matches_jax():
    ref = jax_opt.RsqrtDecaySchedule(warmup_steps=10, peak_lr=5e-5, timescale=100).create()
    got = port_opt.RsqrtDecaySchedule(warmup_steps=10, peak_lr=5e-5, timescale=100)
    for step in STEPS:
        np.testing.assert_allclose(got(step), float(ref(jnp.asarray(step))), rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind,start", [("disabled", 0), ("constant", 0), ("delayed", 0), ("delayed", 3),
                                         ("cosine_delayed", 2)])
def test_ema_decay_for_step_matches_jax_config(kind, start):
    for ema_decay in (0.99, None):
        jcfg = jax_config.TrainConfig(
            ema_decay=ema_decay, num_train_steps=8,
            ema_schedule_choice=jax_opt.EmaScheduleChoice(kind=kind, start_step=start),
        )
        pcfg = port_config.TrainConfig(
            ema_decay=ema_decay, num_train_steps=8,
            ema_schedule_choice=port_opt.EmaScheduleChoice(kind=kind, start_step=start),
        )
        assert pcfg.has_ema == jcfg.has_ema
        for step in range(10):
            ref_decay, ref_on = jcfg.get_ema_decay_for_step(step)
            decay, on = pcfg.get_ema_decay_for_step(step)
            assert on == bool(ref_on)
            np.testing.assert_allclose(decay, float(ref_decay), rtol=1e-6, atol=1e-9)


def test_ema_schedule_stages_match_jax_and_validate():
    stages = [(0, 2, None), (2, 5, 0.5), (5, None, 0.9)]
    ref = jax_opt.EmaSchedule(stages=tuple(jax_opt.EmaStage(*s) for s in stages))
    got = port_opt.EmaSchedule(stages=tuple(port_opt.EmaStage(*s) for s in stages))
    for step in range(8):
        ref_decay, ref_on = ref.get_decay_for_step(step)
        assert got.get_decay_for_step(step) == (pytest.approx(float(ref_decay)), bool(ref_on))
    assert got.has_ema() and got.default_decay() == 0.5
    with pytest.raises(ValueError, match="overlap"):
        port_opt.EmaSchedule(stages=(port_opt.EmaStage(0, 4, 0.5), port_opt.EmaStage(3, None, 0.5)))
    with pytest.raises(ValueError, match="decay"):
        port_opt.EmaSchedule(stages=(port_opt.EmaStage(0, None, 1.5),))


# ---------------------------------------------------------------------------
# (f) three optimizer steps against optax on the same gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grad_scale", [0.01, 30.0])  # below and above the clip norm
def test_three_adamw_steps_match_optax(grad_scale):
    rng = np.random.default_rng(80)
    shapes = [(7, 5), (11,), (3, 4, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(grad_scale * rng.standard_normal(s)).astype(np.float32) for s in shapes] for _ in range(3)]
    sched = dict(warmup_steps=2, peak_lr=1e-2, decay_steps=10, decay_lr=1e-3)
    adam = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_gradient_norm=1.0)

    tx = jax_opt.AdamW(**adam).create(jax_opt.CosineDecaySchedule(**sched).create())
    jparams = [jnp.asarray(p) for p in params]
    jstate = tx.init(jparams)
    opt = port_opt.AdamW(**adam)
    pparams = [torch.from_numpy(p.copy()) for p in params]
    pstate = opt.init(pparams)
    for step_grads in grads:
        updates, jstate = tx.update([jnp.asarray(g) for g in step_grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.update_(pparams, [torch.from_numpy(g.copy()) for g in step_grads], pstate,
                    port_opt.CosineDecaySchedule(**sched))
    adam_state = jstate[1][0]  # chain(clip, adamw=chain(scale_by_adam, ...))
    assert pstate.count == int(adam_state.count) == 3
    for got, ref in zip(pparams, jparams, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=1e-7)
    for got, ref in zip(pstate.mu, adam_state.mu, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=1e-7)
    for got, ref in zip(pstate.nu, adam_state.nu, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=1e-9)
    assert pstate.mu[0].dtype == torch.float32
    bf16 = opt.init([torch.zeros(3, dtype=torch.bfloat16)])
    assert bf16.mu[0].dtype == bf16.nu[0].dtype == torch.bfloat16  # moments take the parameter's dtype


def test_global_norm_matches_optax():
    rng = np.random.default_rng(81)
    xs = [rng.standard_normal(s).astype(np.float32) for s in [(4, 3), (9,), (2, 2, 2)]]
    ref = float(optax.global_norm([jnp.asarray(x) for x in xs]))
    np.testing.assert_allclose(port_opt.global_norm(map(torch.from_numpy, xs)).item(), ref, rtol=1e-6)


# ---------------------------------------------------------------------------
# (f) two whole training steps against lap_tpu's train_step
# ---------------------------------------------------------------------------

SCHED = dict(warmup_steps=2, peak_lr=1e-3, decay_steps=10, decay_lr=1e-4)
ADAM = dict(weight_decay=0.01, clip_gradient_norm=1.0)


@pytest.fixture(scope="module")
def lap_params():
    cfg = JaxLAPConfig(**tiny_lap_config_kwargs(stop_action_to_vlm_grad=True))
    model = cfg.create_module()
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=model.init_params_fn)
    )
    return randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 82)


def _assert_tree_matches(named: dict, jax_tree, what, atol=2e-6):
    ref = from_jax_params(jax.tree.map(lambda x: None if x is None else np.asarray(x), jax_tree,
                                       is_leaf=lambda x: x is None))
    assert set(ref) == set(named), what
    for name, got in named.items():
        np.testing.assert_allclose(got.detach().numpy(), ref[name].numpy(), rtol=2e-4, atol=atol,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("freeze_vlm", [False, True])
def test_two_train_steps_match_jax(lap_params, freeze_vlm):
    """Parameters, Adam moments and EMA after two steps of the lap-like dummy
    (stop-gradient, augmentation on, constant EMA), with and without the VLM
    frozen; loss, grad_norm and param_norm at each step."""
    kw = tiny_lap_config_kwargs(stop_action_to_vlm_grad=True)
    arrays = train_obs_arrays(83, batch=2, valid=[14, 9], cfg_kw=kw)
    actions = np.random.default_rng(84).standard_normal((2, 4, 7)).astype(np.float32)
    rng = jax.random.PRNGKey(85)

    jcfg = JaxLAPConfig(**kw)
    jmodel = jcfg.create_module()
    tx = jax_opt.AdamW(**ADAM).create(jax_opt.CosineDecaySchedule(**SCHED).create())
    ema_schedule = jax_opt.EmaSchedule(stages=(jax_opt.EmaStage(0, 1, None), jax_opt.EmaStage(1, None, 0.9)))
    freeze_mask = None
    if freeze_vlm:
        freeze_mask = jax_opt.freeze_mask_from_filter(lap_params, jax_vlm_freeze_filter(jcfg))
    fns = jax_train_step.make_step_functions(jmodel, tx, ema_schedule=ema_schedule, freeze_mask=freeze_mask)
    params = jax.tree.map(jnp.asarray, lap_params)
    trainable = params if freeze_mask is None else jax.tree.map(lambda p, m: None if m else p, params, freeze_mask)
    from lap_tpu.training.state import TrainState as JaxTrainState

    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(trainable),
                           ema_params=trainable)
    jstep = jax.jit(fns.train_step)

    port = load_jax_params(LAP(LAPConfig(**kw), device="cpu", init_seed=None), lap_params)
    port_ema = port_opt.EmaSchedule(stages=(port_opt.EmaStage(0, 1, None), port_opt.EmaStage(1, None, 0.9)))
    steps = make_step_functions(
        port, port_opt.AdamW(**ADAM), port_opt.CosineDecaySchedule(**SCHED),
        ema_decay_for_step=port_ema.get_decay_for_step,
        freeze_filter=get_vlm_freeze_filter(port.config) if freeze_vlm else None,
    )
    pstate = steps.init_fn()
    if freeze_vlm:
        assert 0 < len(pstate.trainable) < len(pstate.params)
        assert all(not p.requires_grad for n, p in port.named_parameters() if n not in pstate.trainable)
    assert len(pstate.opt_state.mu) == len(pstate.ema_params) == len(pstate.trainable)
    # The initial EMA is a copy, not the parameter itself.
    name0 = pstate.trainable[0]
    assert pstate.ema_params[name0].data_ptr() != pstate.params[name0].data_ptr()

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
    assert pstate.step == int(jstate.step) == 2
    _assert_tree_matches(pstate.params, jstate.params, "params", atol=1e-5)
    adam_state = jstate.opt_state[1][0]
    trainable_names = pstate.trainable
    _assert_tree_matches(dict(zip(trainable_names, pstate.opt_state.mu, strict=True)), adam_state.mu, "mu")
    _assert_tree_matches(dict(zip(trainable_names, pstate.opt_state.nu, strict=True)), adam_state.nu, "nu")
    _assert_tree_matches(pstate.ema_params, jstate.ema_params, "ema", atol=1e-5)
    _assert_tree_matches(inference_params(pstate), jax_inference_params(jstate), "inference params", atol=1e-5)
    assert all(p.grad is None for p in port.parameters())  # no gradient buffer outlives the step
    if freeze_vlm:
        frozen_name = "llm.layers.0.mlp.0.linear"
        assert frozen_name not in pstate.ema_params
        ref = from_jax_params(lap_params)[frozen_name]
        assert torch.equal(pstate.params[frozen_name], ref)  # untouched, weight decay included


def test_train_step_raises_when_a_trainable_parameter_takes_no_gradient(lap_params):
    """A loss that reaches one parameter only. The step used to refuse; it now
    follows JAX, whose value_and_grad gives every unreached leaf a zero
    gradient (a named config needs it: ``pi0_replicated`` trains without the
    language loss, so expert 0's last layer takes none). Against optax's
    AdamW on the same zero gradients: the unreached parameters keep zero
    moments and move by weight decay alone, and the EMA averages them."""
    kw = tiny_lap_config_kwargs(stop_action_to_vlm_grad=True)
    port = load_jax_params(LAP(LAPConfig(**kw), device="cpu", init_seed=None), lap_params)
    steps = make_step_functions(port, port_opt.AdamW(**ADAM), port_opt.CosineDecaySchedule(**SCHED),
                                ema_decay_for_step=lambda step: (0.5, True))
    state = steps.init_fn()
    reached = state.trainable[0]
    port.compute_loss = lambda observation, actions, train, **kw: (state.params[reached].square().sum(), {})
    snapshot = {n: p.detach().clone() for n, p in port.named_parameters()}
    state, metrics = steps.train_step(state, (None, None))
    assert state.step == 1 and state.opt_state.count == 1
    tx = jax_opt.AdamW(**ADAM).create(jax_opt.CosineDecaySchedule(**SCHED).create())
    ref_params = {n: jnp.asarray(v.numpy()) for n, v in snapshot.items() if n in state.trainable}
    ref_grads = {n: jnp.zeros_like(v) for n, v in ref_params.items()}
    ref_grads[reached] = jnp.asarray(2 * snapshot[reached].numpy())
    updates, _ = tx.update(ref_grads, tx.init(ref_params), ref_params)
    ref = optax.apply_updates(ref_params, updates)
    now = state.params
    for i, name in enumerate(state.trainable):
        np.testing.assert_allclose(now[name].detach().numpy(), np.asarray(ref[name]), rtol=2e-6, atol=1e-9,
                                   err_msg=name)
        if name != reached:
            assert not state.opt_state.mu[i].any() and not state.opt_state.nu[i].any()
            expected_ema = 0.5 * snapshot[name] + 0.5 * now[name].detach()
            torch.testing.assert_close(state.ema_params[name], expected_ema, rtol=1e-6, atol=1e-9)
    assert float(metrics["grad_norm"]) == pytest.approx(2 * snapshot[reached].norm().item(), rel=1e-6)


# ---------------------------------------------------------------------------
# (g) overfit, and the trainer entry point
# ---------------------------------------------------------------------------


def _small_train_config(**overrides):
    model = LAPConfig(**tiny_lap_config_kwargs(stop_action_to_vlm_grad=True))
    base = dict(
        name="tiny", model=model, batch_size=2, num_train_steps=6, log_interval=2, ema_decay=0.99,
        lr_schedule=port_opt.CosineDecaySchedule(warmup_steps=2, peak_lr=3e-3, decay_steps=50, decay_lr=3e-4),
        ema_schedule_choice=port_opt.EmaScheduleChoice(kind="cosine_delayed", start_step=2),
    )
    base.update(overrides)
    return port_config.TrainConfig(**base)


def test_a_few_steps_on_a_fixed_batch_lower_the_loss():
    records = port_train.train(_small_train_config(), device="cpu", num_steps=6)
    losses = [r["loss"] for r in records]
    assert len(records) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5, losses
    assert all(np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0 and r["step_ms"] > 0 for r in records)


def test_trainer_freezes_the_vlm_and_keeps_bf16_params_when_asked():
    trainer = port_train.build_trainer(_small_train_config(freeze_vlm=True), device="cpu", param_dtype="bfloat16")
    names = set(trainer.state.trainable)
    assert names and all(not n.startswith("img.") for n in names)
    assert all(p.dtype == torch.bfloat16 for p in trainer.model.parameters())
    assert all(m.dtype == torch.bfloat16 for m in trainer.state.opt_state.mu)
    assert set(trainer.state.ema_params) == names


def test_trainer_resolves_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.train(_small_train_config(), num_steps=1)


def test_fake_train_batch_is_the_synthetic_batch_of_the_jax_benchmark():
    cfg = LAPConfig(**tiny_lap_config_kwargs())
    obs, actions = port_train.fake_train_batch(cfg, 3, device="cpu", seed=0)
    t = cfg.max_token_len
    np.testing.assert_array_equal(obs.tokenized_prompt.numpy(), np.tile(np.arange(t, dtype=np.int32), (3, 1)))
    np.testing.assert_array_equal(obs.tokenized_langact_mask.numpy(), np.tile(np.arange(t) >= 8, (3, 1)))
    assert obs.token_loss_mask.all() and obs.tokenized_prompt_mask.all()
    assert all(v.dtype == torch.uint8 and v.shape == (3, 28, 28, 3) for v in obs.images.values())
    assert actions.shape == (3, 4, 7) and actions.abs().min().item() > 0
    again = port_train.fake_train_batch(cfg, 3, device="cpu", seed=0)[1]
    assert torch.equal(actions, again)


def _assert_same_fields(got, ref, path):
    if dataclasses.is_dataclass(ref):
        for field in dataclasses.fields(got):
            _assert_same_fields(getattr(got, field.name), getattr(ref, field.name), f"{path}.{field.name}")
    elif hasattr(ref, "value") and hasattr(got, "value"):  # the two packages' enums
        assert got.value == ref.value, path
    else:
        assert got == ref, path


def test_configs_hold_the_jax_values():
    """Every field of the port's configs, nested ones included (the weight
    loader choice, the schedules, the model and data configs), equals JAX's;
    lap_libero's schedule, EMA choice and weight loader too."""
    for name in ("lap", "lap_libero", "debug"):
        _assert_same_fields(port_config.get_config(name), jax_config.get_config(name), name)
    with pytest.raises(ValueError, match="Did you mean"):
        port_config.get_config("lapp")


def test_a_run_rebuilt_after_k_steps_repeats_the_uninterrupted_steps():
    """Each step's noise, flow time and augmentation are a function of the
    seed and the step: k steps, a rebuild carrying the state over, and N - k
    more give the losses and parameters of N steps in one go, bit for bit."""
    config = _small_train_config(batch_size=2)
    batches = [port_train.fake_train_batch(config.model, 2, device="cpu", seed=s) for s in range(4)]

    def steps(trainer, chosen):
        return [trainer.run(batch, 1)[0]["loss"] for batch in chosen]

    whole = port_train.build_trainer(config, device="cpu")
    reference = steps(whole, batches)
    first = port_train.build_trainer(config, device="cpu")
    losses = steps(first, batches[:2])
    rebuilt = port_train.build_trainer(config, device="cpu", init_weights=False)
    with torch.no_grad():
        for name, p in rebuilt.state.params.items():
            p.copy_(first.state.params[name])
        for dst, src in zip(rebuilt.state.opt_state.mu + rebuilt.state.opt_state.nu,
                            first.state.opt_state.mu + first.state.opt_state.nu, strict=True):
            dst.copy_(src)
        for name, ema in rebuilt.state.ema_params.items():
            ema.copy_(first.state.ema_params[name])
    rebuilt.state.step, rebuilt.state.opt_state.count = first.state.step, first.state.opt_state.count
    losses += steps(rebuilt, batches[2:])
    assert losses == reference
    got, want = rebuilt.state.params, whole.state.params
    assert all(torch.equal(got[n], want[n]) for n in want)
    assert all(torch.equal(rebuilt.state.ema_params[n], whole.state.ema_params[n]) for n in want if n in
               whole.state.ema_params)


def test_the_embedding_table_gradient_is_the_same_bit_for_bit_every_time():
    """The table gradient sums the rows of repeated tokens: its order must
    not vary with the threads, or a resumed run could not repeat an
    uninterrupted one (indexing's backward varied here; embedding's does not)."""
    from lap_tpu_torch.models.gemma import Embedder

    embedder = Embedder(5000, 64, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        embedder.random_init_(torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    tokens = torch.randint(0, 300, (8, 160), generator=gen, dtype=torch.int32)
    upstream = torch.randn((8, 160, 64), generator=gen)
    grads = [torch.autograd.grad(embedder.encode(tokens), embedder.input_embedding, upstream)[0] for _ in range(6)]
    assert all(torch.equal(g, grads[0]) for g in grads[1:])


# ---------------------------------------------------------------------------
# SGD (optax.sgd, as lap_tpu's SGDConfig builds it)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("momentum,nesterov", [(0.9, False), (0.9, True), (0.0, False), (0.0, True)])
def test_four_sgd_steps_match_optax(momentum, nesterov):
    """Parameters and the momentum trace after four steps on the same
    gradients (a warm-up schedule), with momentum on and off and nesterov on
    and off: atol 1e-7 + rtol 2e-5. No clip and no weight decay, as in JAX:
    gradients far above the AdamW clip norm pass unscaled."""
    rng = np.random.default_rng(86)
    shapes = [(7, 5), (11,), (3, 4, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(30.0 * rng.standard_normal(s)).astype(np.float32) for s in shapes] for _ in range(4)]
    sched = dict(warmup_steps=2, peak_lr=1e-2, decay_steps=10, decay_lr=1e-3)
    tx = jax_opt.SGDConfig(momentum=momentum, nesterov=nesterov).create(jax_opt.CosineDecaySchedule(**sched).create())
    jparams = [jnp.asarray(p) for p in params]
    jstate = tx.init(jparams)
    opt = port_opt.SGDConfig(momentum=momentum, nesterov=nesterov)
    pparams = [torch.from_numpy(p.copy()) for p in params]
    pstate = opt.init(pparams)
    for step_grads in grads:
        updates, jstate = tx.update([jnp.asarray(g) for g in step_grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.update_(pparams, [torch.from_numpy(g.copy()) for g in step_grads], pstate,
                    port_opt.CosineDecaySchedule(**sched))
    assert pstate.count == int(jstate[1].count) == 4
    for got, ref in zip(pparams, jparams, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=1e-7)
    for got, ref in zip(pstate.trace, jstate[0].trace, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=1e-7)
    assert opt.init([torch.zeros(3, dtype=torch.bfloat16)]).trace[0].dtype == torch.bfloat16


def test_sgd_train_steps_match_jax(lap_params):
    """Two whole training steps with SGD (momentum, nesterov) against
    lap_tpu's ``train_step`` with ``SGDConfig().create``: loss, grad_norm and
    the parameters, as ``test_two_train_steps_match_jax`` holds AdamW."""
    kw = tiny_lap_config_kwargs(stop_action_to_vlm_grad=True)
    arrays = train_obs_arrays(87, batch=2, valid=[14, 9], cfg_kw=kw)
    actions = np.random.default_rng(88).standard_normal((2, 4, 7)).astype(np.float32)
    rng = jax.random.PRNGKey(89)
    jcfg = JaxLAPConfig(**kw)
    sgd = dict(momentum=0.8, nesterov=True)
    tx = jax_opt.SGDConfig(**sgd).create(jax_opt.CosineDecaySchedule(**SCHED).create())
    fns = jax_train_step.make_step_functions(jcfg.create_module(), tx)
    params = jax.tree.map(jnp.asarray, lap_params)
    from lap_tpu.training.state import TrainState as JaxTrainState

    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params), ema_params=None)
    jstep = jax.jit(fns.train_step)
    port = load_jax_params(LAP(LAPConfig(**kw), device="cpu", init_seed=None), lap_params)
    steps = make_step_functions(port, port_opt.SGDConfig(**sgd), port_opt.CosineDecaySchedule(**SCHED))
    pstate = steps.init_fn()
    batch = (port_observation(arrays), torch.from_numpy(actions))
    for step in range(2):
        jstate, jmetrics = jstep(rng, jstate, (jax_observation(arrays), jnp.asarray(actions)))
        draws = jax_loss_randomness(jax.random.fold_in(rng, step), image_keys=jcfg.image_keys, batch=2,
                                    resolution=(28, 28), action_shape=actions.shape)
        pstate, pmetrics = steps.train_step(
            pstate, batch, noise=torch.from_numpy(draws["noise"].copy()),
            time=torch.from_numpy(draws["time"].copy()), aug_params=port_aug_params(draws["aug"]),
        )
        for key in ("loss", "grad_norm", "param_norm"):
            np.testing.assert_allclose(float(pmetrics[key]), float(jmetrics[key]), rtol=5e-5, err_msg=key)
    _assert_tree_matches(pstate.params, jstate.params, "params", atol=1e-5)
    _assert_tree_matches(dict(zip(pstate.trainable, pstate.opt_state.trace, strict=True)), jstate.opt_state[0].trace,
                         "trace", atol=1e-4)
