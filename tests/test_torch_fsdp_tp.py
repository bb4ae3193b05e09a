"""FSDP, tensor and sequence parallelism in training, on a gloo world of 4
CPU processes, against the port's one-process step and lap_tpu's unsharded
step.

The model is the ``TINY`` config of ``tests/test_tensor_parallel.py``
(dummy widths, 8 query heads on 1 KV head, f32) with the JAX params tree
randomised by numpy; the global batch is 4 (``train_obs_arrays``), each step's
randomness JAX's own draws (``jax_loss_randomness``), and each rank takes
its rows (``mesh.data_sharding``). One world (``run_world``, 180 s join
timeout) runs, in turn: (fsdp 2, tp 2); (dp 2, fsdp 2), whose state is saved
after its two steps and which takes a third; (dp 2, tp 2) with sequence
parallelism; and a LAPGemma3 loss (gemma3_dummy: 4 query heads on 2 KV
heads, so tp splits the KV heads) at (fsdp 2, tp 2) with sequence
parallelism.

Tolerances: the loss, the grad norm and the param norm within 1e-6
relative of one process's; each gradient leaf within 5e-6 of its norm
(norm-wise: the tp partial sums and the data ranks' shares add in another
order, f32 over 4 layers forward and back; measured at most 2e-6), plus
1e-7 of the whole gradient's norm (SigLIP's key biases, zero in exact
arithmetic); the parameters after two steps within 1e-5 + 1e-5 relative
(Adam's normalised update moves an entry with a tiny gradient by about the
learning rate, 1e-3, whatever its size; measured 5e-6). Against JAX: the
metrics of each step within 5e-5 relative (``test_torch_train_step.py``),
the parameters within 5e-5 + 2e-4 relative (the one-process port is itself
up to 2.1e-5 from JAX on these inputs, for the same reason). The restore is
exact: every tensor of the saved sharded state, read into one process,
equals the sharded run's whole tensor bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.models.lap_model import LAPConfig as JaxLAPConfig  # noqa: E402
from lap_tpu.training import optimizer as jax_opt  # noqa: E402
from lap_tpu.training import train_step as jax_train_step  # noqa: E402
from lap_tpu.training.state import TrainState as JaxTrainState  # noqa: E402
from lap_tpu_torch.models.convert import from_jax_params, load_jax_params  # noqa: E402
from lap_tpu_torch.models.lap_model import LAPConfig  # noqa: E402
from lap_tpu_torch.training import optimizer as port_opt  # noqa: E402
from lap_tpu_torch.training.checkpoints import CheckpointManager  # noqa: E402
from lap_tpu_torch.training.train_step import make_step_functions  # noqa: E402
from torch_dist_helpers import run_world  # noqa: E402
from torch_dist_workers import step_randomness  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    TORCH_THREADS,
    jax_loss_randomness,
    jax_observation,
    port_observation,
    randomize_params,
    tiny_lap_config_kwargs,
    train_obs_arrays,
)

torch.set_num_threads(TORCH_THREADS)

KW = tiny_lap_config_kwargs(enable_langact_training=True)
G3_KW = dict(KW, paligemma_variant="gemma3_dummy", action_expert_variant="gemma3_dummy", max_token_len=48,
             image_resolution=(56, 56))
B, STEPS = 4, 2
OPT = dict(adam=dict(weight_decay=0.01, clip_gradient_norm=1.0),
           sched=dict(warmup_steps=2, peak_lr=1e-3, decay_steps=10, decay_lr=1e-4))
LAYOUTS = [("fsdp2_tp2", 2, 2, False, STEPS), ("dp2_fsdp2", 2, 1, False, STEPS), ("dp2_tp2_sp", 1, 2, True, STEPS)]
NAMES = [name for name, *_ in LAYOUTS]
METRICS = ("loss", "grad_norm", "param_norm", "action_loss", "lang_loss")


def _jax_params(kw, seed):
    model = JaxLAPConfig(**kw).create_module()
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=model.init_params_fn))
    return randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), seed)


def _draws(kw, rng, step):
    return jax_loss_randomness(jax.random.fold_in(rng, step), image_keys=JaxLAPConfig(**kw).image_keys, batch=B,
                               resolution=kw["image_resolution"], action_shape=(B, kw["action_horizon"], 7))


@pytest.fixture(scope="module")
def inputs():
    rng = jax.random.PRNGKey(85)
    g3 = dict(params=_jax_params(G3_KW, 91), arrays=train_obs_arrays(92, batch=B, valid=[40, 33, 48, 20], cfg_kw=G3_KW),
              actions=np.random.default_rng(93).standard_normal((B, 4, 7)).astype(np.float32),
              draws=_draws(G3_KW, rng, 0))
    return dict(params=_jax_params(KW, 82), arrays=train_obs_arrays(83, batch=B, valid=[14, 9, 16, 12], cfg_kw=KW),
                actions=np.random.default_rng(84).standard_normal((B, 4, 7)).astype(np.float32), rng=rng,
                draws=[_draws(KW, rng, step) for step in range(STEPS + 1)], g3=g3)


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("fsdp_ckpt")
    g3 = inputs["g3"]
    jobs = [
        ("train_layouts", (KW, inputs["params"], inputs["arrays"], inputs["actions"], inputs["draws"], OPT, LAYOUTS,
                           ckpt)),
        ("gemma3_grads", (G3_KW, g3["params"], g3["arrays"], g3["actions"], g3["draws"], 2, 2, True)),
    ]
    layouts, g3_out = run_world(4, "torch_dist_workers:run_jobs", jobs)[0]
    return dict(layouts=layouts, g3=g3_out, ckpt=ckpt)


def _one_process_grads(kw, params, arrays, actions, draws):
    model = load_jax_params(LAPConfig(**kw).create_module(device="cpu", init_seed=None), params)
    loss, _ = model.compute_loss(port_observation(arrays), torch.from_numpy(actions), train=True,
                                 **step_randomness(draws, slice(None)))
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy().copy() for n, p in model.named_parameters()}


def _one_process_steps(inputs, steps):
    model = load_jax_params(LAPConfig(**KW).create_module(device="cpu", init_seed=None), inputs["params"])
    fns = make_step_functions(model, port_opt.AdamW(**OPT["adam"]), port_opt.CosineDecaySchedule(**OPT["sched"]),
                              ema_decay_for_step=lambda step: (0.9, step >= 1))
    state = fns.init_fn()
    batch = (port_observation(inputs["arrays"]), torch.from_numpy(inputs["actions"]))
    metrics = []
    for step in range(steps):
        state, m = fns.train_step(state, batch, **step_randomness(inputs["draws"][step], slice(None)))
        metrics.append({k: float(m[k]) for k in METRICS})
    return fns, state, batch, metrics


@pytest.fixture(scope="module")
def single(inputs):
    loss, grads = _one_process_grads(KW, inputs["params"], inputs["arrays"], inputs["actions"], inputs["draws"][0])
    fns, state, batch, metrics = _one_process_steps(inputs, STEPS)
    val = fns.val_step(state, batch, **step_randomness(inputs["draws"][STEPS], slice(None)))
    params = {n: p.detach().numpy().copy() for n, p in state.params.items()}
    return dict(loss=loss, grads=grads, metrics=metrics, params=params, val_loss=float(val["loss"]))


@pytest.fixture(scope="module")
def jax_run(inputs):
    jmodel = JaxLAPConfig(**KW).create_module()
    tx = jax_opt.AdamW(**OPT["adam"]).create(jax_opt.CosineDecaySchedule(**OPT["sched"]).create())
    ema = jax_opt.EmaSchedule(stages=(jax_opt.EmaStage(0, 1, None), jax_opt.EmaStage(1, None, 0.9)))
    fns = jax_train_step.make_step_functions(jmodel, tx, ema_schedule=ema)
    params = jax.tree.map(jnp.asarray, inputs["params"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params), ema_params=params)
    step_fn = jax.jit(fns.train_step)
    batch = (jax_observation(inputs["arrays"]), jnp.asarray(inputs["actions"]))
    metrics = []
    for _ in range(STEPS):
        state, m = step_fn(inputs["rng"], state, batch)
        metrics.append({k: float(m[k]) for k in METRICS})
    ref = from_jax_params(jax.tree.map(np.asarray, state.params))
    return dict(metrics=metrics, params={n: t.numpy() for n, t in ref.items()})


def _assert_leaves_close(got: dict, ref: dict, rel: float, what: str):
    """Each leaf within ``rel`` of its norm, plus 1e-7 of the whole
    gradient's norm: SigLIP's key biases have a zero gradient in exact
    arithmetic (softmax ignores a per-query constant) and f32 noise of
    ~1e-9 in both runs."""
    assert set(got) == set(ref), what
    floor = 1e-7 * np.sqrt(sum(np.square(r, dtype=np.float64).sum() for r in ref.values()))
    for name, r in ref.items():
        err = np.linalg.norm(got[name] - r)
        assert err <= rel * np.linalg.norm(r) + floor, f"{what} {name}: {err:.3g} of {np.linalg.norm(r):.3g}"


@pytest.mark.parametrize("layout", NAMES)
def test_every_gradient_leaf_matches_one_process(world, single, layout):
    got = world["layouts"][layout]
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-6)
    _assert_leaves_close(got["grads"], single["grads"], 5e-6, layout)
    # The MQA kv_einsum stays whole on each tp rank; its gradient sums the
    # ranks' query heads.
    kv = [n for n in single["grads"] if "kv_einsum" in n]
    assert len(kv) == 2 * 4 and all(np.abs(single["grads"][n]).max() > 0 for n in kv)


@pytest.mark.parametrize("layout", NAMES)
def test_two_steps_match_one_process(world, single, layout):
    got = world["layouts"][layout]
    for step, (m, ref) in enumerate(zip(got["metrics"], single["metrics"], strict=True)):
        for key in METRICS:
            np.testing.assert_allclose(m[key], ref[key], rtol=1e-6, err_msg=f"{layout} step {step} {key}")
    for name, ref in single["params"].items():
        np.testing.assert_allclose(got["params"][name], ref, rtol=1e-5, atol=1e-5, err_msg=f"{layout} {name}")
    # The validation loss on the EMA view after the steps.
    np.testing.assert_allclose(got["val_loss"], single["val_loss"], rtol=1e-6)


@pytest.mark.parametrize("layout", NAMES)
def test_two_steps_match_jax(world, jax_run, layout):
    got = world["layouts"][layout]
    for step, (m, ref) in enumerate(zip(got["metrics"], jax_run["metrics"], strict=True)):
        for key in METRICS:
            np.testing.assert_allclose(m[key], ref[key], rtol=5e-5, err_msg=f"{layout} step {step} {key}")
    for name, ref in jax_run["params"].items():
        np.testing.assert_allclose(got["params"][name], ref, rtol=2e-4, atol=5e-5, err_msg=f"{layout} {name}")


def test_layouts_are_the_meshes_asked_for(world):
    shapes = {name: world["layouts"][name]["shape"] for name in NAMES}
    assert shapes == {"fsdp2_tp2": {"dp": 1, "fsdp": 2, "tp": 2}, "dp2_fsdp2": {"dp": 2, "fsdp": 2, "tp": 1},
                      "dp2_tp2_sp": {"dp": 2, "fsdp": 1, "tp": 2}}


def test_gemma3_kv_heads_split_over_tp_match_one_process(world, inputs):
    g3 = inputs["g3"]
    loss, grads = _one_process_grads(G3_KW, g3["params"], g3["arrays"], g3["actions"], g3["draws"])
    np.testing.assert_allclose(world["g3"]["loss"], loss, rtol=1e-6)
    _assert_leaves_close(world["g3"]["grads"], grads, 5e-6, "gemma3")
    assert any("kv_einsum" in n for n in grads) and any("q_rmsnorm" in n for n in grads)


def test_fsdp_save_restores_into_one_process_bit_equal(world, inputs):
    """The (dp 2, fsdp 2) state saved after two steps, restored into one
    process: parameters, Adam moments and EMA bit for bit; its next loss
    within 1e-6 of the sharded run's next one (the shares add in another
    order)."""
    sharded = world["layouts"]["dp2_fsdp2"]
    fns, state, batch, _ = _one_process_steps(inputs, 0)
    CheckpointManager(world["ckpt"]).restore(None, state)
    assert state.step == STEPS
    for name, p in state.params.items():
        assert np.array_equal(p.detach().numpy(), sharded["params"][name]), name
    for name, t in state.ema_params.items():
        assert np.array_equal(t.numpy(), sharded["ema"][name]), name
    for name, t in zip(state.trainable, state.opt_state.mu, strict=True):
        assert np.array_equal(t.numpy(), sharded["mu"][name]), name
    _, m = fns.train_step(state, batch, **step_randomness(inputs["draws"][STEPS], slice(None)))
    np.testing.assert_allclose(float(m["loss"]), sharded["next_loss"], rtol=1e-6)
