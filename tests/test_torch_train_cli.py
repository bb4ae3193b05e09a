"""The port's training and eval entry points (``python -m
lap_tpu_torch.training.train`` / ``.eval``) on the CPU, beside the JAX
package's ``scripts/train.py`` semantics.

- The cases of ``tests/test_crash_resume.py``: SIGTERM after the first step
  saves and exits 0, and the restart in a new process gives the losses and
  the final state of 3 uninterrupted steps bit for bit (subprocesses of the
  ``debug`` config at batch 1); SIGKILL at an arbitrary moment leaves a step
  the restart resumes from.
- ``val_step`` against JAX's on the same parameters, EMA and batch, and the
  eval metrics against ``scripts/eval.py``'s evaluators: 2e-5 relative
  (f32 sums in another order).
- The EMA re-seeded from the weights a weight loader merged in; the config
  and its CLI overrides equal JAX's field by field; no run without the card
  unless the CPU is asked for; quantized serving of a step the trainer wrote.
"""

import dataclasses
import enum
import math
import importlib
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.models.lap_model import LAPConfig as JaxLAPConfig  # noqa: E402
from lap_tpu.training import config as jax_config  # noqa: E402
from lap_tpu.training import optimizer as jax_opt  # noqa: E402
from lap_tpu.training import train_step as jax_train_step  # noqa: E402
from lap_tpu.training.state import TrainState as JaxTrainState  # noqa: E402
from lap_tpu_torch.models import convert, lora  # noqa: E402
from lap_tpu_torch.models.lap_model import LAP, LAPConfig  # noqa: E402
from lap_tpu_torch.policies import policy_config  # noqa: E402
from lap_tpu_torch.training import checkpoints  # noqa: E402
from lap_tpu_torch.training import config as port_config  # noqa: E402
from lap_tpu_torch.training import eval as port_eval  # noqa: E402
from lap_tpu_torch.training import optimizer as port_opt  # noqa: E402
from lap_tpu_torch.training import train as port_train  # noqa: E402
from lap_tpu_torch.training import weight_loaders  # noqa: E402
from lap_tpu_torch.training.train_step import make_step_functions  # noqa: E402
from test_torch_serving_stack import robot_request  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    TORCH_THREADS,
    flatten,
    jax_loss_randomness,
    jax_observation,
    port_observation,
    randomize_params,
    tiny_lap_config_kwargs,
    train_obs_arrays,
)

torch.set_num_threads(TORCH_THREADS)
REPO = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "OMP_NUM_THREADS": str(TORCH_THREADS)}
TOL = 2e-5
CLI_ARGS = ("--batch_size", "1", "--log_interval", "1")
STEP_LINE = re.compile(r"step (\d+) (?:\S+=\S+ )*loss=(\S+)")


def _cmd(module, ckpt_dir, *extra):
    return [sys.executable, "-m", f"lap_tpu_torch.training.{module}", "debug", "--device", "cpu",
            "--checkpoint_base_dir", str(ckpt_dir), *CLI_ARGS, *extra]


def _start(module, ckpt_dir, *extra):
    return subprocess.Popen(_cmd(module, ckpt_dir, *extra), cwd=REPO, env=ENV, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(proc, timeout=300):
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-6000:]
    return out


def _run(module, ckpt_dir, *extra):
    return _finish(_start(module, ckpt_dir, *extra))


def _losses(log: str) -> dict[int, str]:
    return {int(m[1]): m[2] for m in STEP_LINE.finditer(log) if " val " not in m[0]}


def _train_state(ckpt_dir, exp, step):
    return torch.load(Path(ckpt_dir) / "debug" / exp / str(step) / "train_state" / checkpoints.TRAIN_STATE_FILE,
                      weights_only=True)


def _wait_for(path_test, proc, log_path, what, deadline_s=240):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"train exited early:\n{log_path.read_text()[-3000:]}")
        if path_test():
            return
        time.sleep(0.2)
    proc.kill()
    raise AssertionError(f"no {what} before the deadline")


@pytest.fixture(scope="module")
def resumed_runs(tmp_path_factory):
    """Three steps in one run; beside it a run stopped by SIGTERM after its
    first step (it finishes the step in flight and saves), then resumed to
    step 3 in a new process."""
    ckpt = tmp_path_factory.mktemp("cli")
    full = _start("train", ckpt, "--exp_name", "full", "--num_train_steps", "3")
    log_path = ckpt / "part.log"
    with log_path.open("w") as log:
        part = subprocess.Popen(_cmd("train", ckpt, "--exp_name", "part", "--num_train_steps", "500",
                                     "--save_interval", "1000"),
                                cwd=REPO, env=ENV, stdout=log, stderr=subprocess.STDOUT, text=True)
        try:
            _wait_for(lambda: "step 1 " in log_path.read_text(), part, log_path, "first step")
            part.send_signal(signal.SIGTERM)
            part.wait(timeout=120)
        finally:
            if part.poll() is None:
                part.kill()
    steps_after_sigterm = checkpoints.CheckpointManager(ckpt / "debug" / "part").all_steps()
    rest = _run("train", ckpt, "--exp_name", "part", "--num_train_steps", "3", "--resume", "true")
    return dict(ckpt=ckpt, full=_finish(full), part=log_path.read_text(), part_rc=part.returncode,
                steps_after_sigterm=steps_after_sigterm, rest=rest)


def test_sigterm_saves_and_exits_cleanly(resumed_runs):
    """Graceful preemption: SIGTERM -> the step in flight finishes -> a
    checkpoint -> exit 0 (the resume is the next test's)."""
    assert resumed_runs["part_rc"] == 0, resumed_runs["part"][-3000:]
    step = int(re.search(r"exiting after preemption checkpoint at step (\d+)", resumed_runs["part"])[1])
    assert resumed_runs["steps_after_sigterm"] == [step] and 1 <= step < 3


def test_resume_after_k_steps_equals_n_uninterrupted_steps(resumed_runs):
    full, part, rest = (_losses(resumed_runs[k]) for k in ("full", "part", "rest"))
    k = max(part)
    assert sorted(full) == [1, 2, 3] and sorted(part) == list(range(1, k + 1)) and sorted(rest) == list(range(k + 1, 4))
    assert {**part, **rest} == full  # every logged digit (float32 to 9 significant digits)
    assert f"resumed from step {k}" in resumed_runs["rest"] and "training complete at step 3" in resumed_runs["rest"]
    a, b = (_train_state(resumed_runs["ckpt"], exp, 3) for exp in ("full", "part"))
    assert a["step"] == b["step"] == 3 and a["opt_state"]["count"] == b["opt_state"]["count"] == 3
    assert all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"])
    for moment in ("mu", "nu"):
        assert all(torch.equal(a["opt_state"][moment][n], b["opt_state"][moment][n]) for n in a["opt_state"][moment])
    assert a["ema_params"] == {} == b["ema_params"]  # debug has no EMA: saved as {}
    state = checkpoints.CheckpointManager(resumed_runs["ckpt"] / "debug" / "part").load_assets(
        3, "dataloader_process_0/dataloader_state.json")
    assert state == {"batches_seen": 3, "seed": 0}
    # max_to_keep=1 as in JAX: step k was removed once step 3 was whole.
    assert sorted(p.name for p in (resumed_runs["ckpt"] / "debug" / "part").iterdir()) == ["3"]


def test_eval_cli_prints_the_metrics_of_the_last_step(resumed_runs):
    log = _run("eval", resumed_runs["ckpt"], "--exp_name", "full", "--num_eval_batches", "1")
    line = next(ln for ln in log.splitlines() if "checkpoint 3 [original]" in ln)
    values = dict(re.findall(r"original/(\w+)=(\S+)", line))
    assert {"val_loss", "action_prediction_l2"} <= set(values)
    assert all(np.isfinite(float(v)) for v in values.values())


def test_quantized_serving_of_a_step_the_trainer_wrote(resumed_runs, monkeypatch):
    monkeypatch.setattr(lora, "QUANT_MIN_WEIGHT_ELEMS", 4096)
    step_dir = resumed_runs["ckpt"] / "debug" / "full" / "3"
    cfg = port_config.get_config("debug")
    saved = _train_state(resumed_runs["ckpt"], "full", 3)["params"]
    for make in (policy_config.create_trained_policy, policy_config.create_trained_policy_ar):
        kw = dict(max_decoding_steps=4) if make is policy_config.create_trained_policy_ar else {}
        policy = make(cfg, step_dir, device="cpu", allow_test_vocab=True, quantize="int8", **kw)
        model = policy._model
        assert any(name.endswith("w_i8") for name, _ in model.named_buffers())
        assert all(torch.equal(p, saved[n]) for n, p in model.named_parameters())
        out = policy.infer(robot_request(0))
        assert np.isfinite(out["actions"]).all()


def _resume_in_process(ckpt_dir, num_train_steps):
    """Restart from the latest step (``train.run`` in this process, where the
    imports are paid for) and take the steps left; returns the final step."""
    config = port_config.cli(["debug", "--checkpoint_base_dir", str(ckpt_dir), "--exp_name", "t", *CLI_ARGS,
                              "--num_train_steps", str(num_train_steps)])
    result = port_train.run(config, device="cpu")
    result.close()
    assert result.timings["restore_s"] >= 0  # it resumed
    return result.trainer.state.step


def test_sigkill_mid_training_then_resume(tmp_path):
    """A kill at an arbitrary moment (mid-save more often than not with a save
    every step): the restart resumes from a whole step or starts fresh."""
    run_dir = tmp_path / "debug" / "t"
    log_path = tmp_path / "log.txt"
    with log_path.open("w") as log:
        proc = subprocess.Popen(_cmd("train", tmp_path, "--exp_name", "t", "--num_train_steps", "50",
                                     "--save_interval", "1"),
                                cwd=REPO, env=ENV, stdout=log, stderr=subprocess.STDOUT, text=True)
        try:
            _wait_for(lambda: run_dir.exists() and any(p.name.isdigit() for p in run_dir.iterdir()), proc,
                      log_path, "checkpoint")
            time.sleep(0.3)
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
    steps = sorted(int(p.name) for p in run_dir.iterdir() if p.name.isdigit())
    assert steps  # a whole step survived the kill
    step = steps[-1]
    assert _resume_in_process(tmp_path, step + 1) == step + 1
    assert not any(checkpoints.TMP_MARK in p.name for p in run_dir.iterdir())


# ---------------------------------------------------------------------------
# In process: validation, eval metrics, the weight-loader merge, configs
# ---------------------------------------------------------------------------

KW = tiny_lap_config_kwargs(stop_action_to_vlm_grad=True)


@pytest.fixture(scope="module")
def tiny_params():
    model = JaxLAPConfig(**KW).create_module()
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=model.init_params_fn))["params"]
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    return model, randomize_params(zeros, 60), randomize_params(zeros, 61)


def test_val_step_matches_jax_on_the_ema_view(tiny_params):
    jmodel, params, ema = tiny_params
    arrays = train_obs_arrays(62, batch=2, valid=[14, 9], cfg_kw=KW)
    actions = np.random.default_rng(63).standard_normal((2, 4, 7)).astype(np.float32)
    rng = jax.random.PRNGKey(64)
    tx = jax_opt.AdamW().create(jax_opt.CosineDecaySchedule().create())
    ema_schedule = jax_opt.EmaSchedule(stages=(jax_opt.EmaStage(0, None, 0.9),))
    fns = jax_train_step.make_step_functions(jmodel, tx, ema_schedule=ema_schedule)
    jstate = JaxTrainState(step=jnp.asarray(5), params=jax.tree.map(jnp.asarray, params), opt_state=tx.init(params),
                           ema_params=jax.tree.map(jnp.asarray, ema))
    want = jax.jit(fns.val_step)(rng, jstate, (jax_observation(arrays), jnp.asarray(actions)))

    port = convert.load_jax_params(LAP(LAPConfig(**KW), device="cpu", init_seed=None), params)
    steps = make_step_functions(port, port_opt.AdamW(), port_opt.CosineDecaySchedule(),
                                ema_decay_for_step=lambda step: (0.9, True))
    state = steps.init_fn()
    ema_sd = convert.from_jax_params(ema)
    for name, value in state.ema_params.items():
        value.copy_(ema_sd[name])
    live = {n: p.detach().clone() for n, p in port.named_parameters()}
    draws = jax_loss_randomness(rng, image_keys=port.config.image_keys, batch=2, resolution=(28, 28),
                                action_shape=actions.shape)
    got = steps.val_step(state, (port_observation(arrays), torch.from_numpy(actions)),
                         noise=torch.from_numpy(draws["noise"].copy()), time=torch.from_numpy(draws["time"].copy()))
    for key in ("loss", "action_loss", "lang_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=TOL, err_msg=key)
    assert all(torch.equal(p, live[n]) for n, p in port.named_parameters())  # the live parameters untouched
    assert all(p.grad is None for p in port.parameters())


def test_eval_metrics_match_the_jax_evaluators(tiny_params):
    from lap_tpu.parallel import make_mesh

    jax_eval = importlib.import_module("scripts.eval")
    jmodel, params, _ = tiny_params
    jcfg = dataclasses.replace(jax_config.get_config("debug"), model=JaxLAPConfig(**KW))
    mesh = make_mesh(devices=jax.devices("cpu")[:1])
    val_fn, pred_fn = jax_eval.make_evaluators(jmodel, mesh, jax_eval._params_sharding(jcfg, jmodel, mesh))
    arrays = train_obs_arrays(65, batch=2, valid=[16, 11], cfg_kw=KW)
    arrays["images"] = {k: ((v + 1) * 127.5).astype(np.uint8) for k, v in arrays["images"].items()}  # as loaded
    actions = np.random.default_rng(66).standard_normal((2, 4, 7)).astype(np.float32)
    rng = jax.random.PRNGKey(67)
    batch = (jax_observation(arrays), jnp.asarray(actions))
    want = {**val_fn(params, rng, batch), **pred_fn(params, rng, batch)}

    port = convert.load_jax_params(LAP(LAPConfig(**KW), device="cpu", init_seed=None), params)
    draws = jax_loss_randomness(rng, image_keys=port.config.image_keys, batch=2, resolution=(28, 28),
                                action_shape=actions.shape)
    pbatch = (port_observation(arrays), torch.from_numpy(actions))
    got = port_eval.val_loss(port, pbatch, noise=torch.from_numpy(draws["noise"].copy()),
                             time=torch.from_numpy(draws["time"].copy()))
    noise = np.asarray(jax.random.normal(rng, actions.shape))  # what sample_actions draws from rng
    got.update(port_eval.action_prediction_l2(port, pbatch, noise=torch.from_numpy(np.array(noise))))
    for key in ("val_loss", "action_loss", "lang_loss", "action_prediction_l2"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=TOL, err_msg=key)
    reduced = port_train.reduce_metrics(got)
    assert set(reduced) >= {"val_loss", "action_prediction_l2"} and all(isinstance(v, float) for v in reduced.values())


def test_eval_selects_steps_as_jax_does():
    cfg = port_config.get_config("debug")
    steps = [3, 6, 9]
    assert port_eval.select_steps(cfg, steps) == [3, 6, 9]
    assert port_eval.select_steps(dataclasses.replace(cfg, eval_all_checkpoints=False), steps) == [9]
    assert port_eval.select_steps(dataclasses.replace(cfg, eval_checkpoint_step=6), steps) == [6]
    assert port_eval.select_steps(dataclasses.replace(cfg, eval_checkpoint_steps=(3, 9)), steps) == [3, 9]
    assert port_eval.select_steps(dataclasses.replace(cfg, eval_start_from_step=5), steps) == [6, 9]


def test_weight_loader_merge_reseeds_the_ema(tmp_path, tiny_params):
    _, params, pretrained = tiny_params
    npz = tmp_path / "pg.npz"
    np.savez(npz, **{f"params/{k}": v for k, v in flatten(pretrained).items()
                     if k.split("/")[0] in ("llm", "img") and not any(p.endswith("_1") for p in k.split("/"))})
    cfg = port_config.TrainConfig(
        name="tiny", exp_name="merge", checkpoint_base_dir=str(tmp_path), model=LAPConfig(**KW),
        data=port_config.DataConfig(repo_id="fake"), batch_size=2, num_train_steps=0, ema_decay=0.99,
        weight_loader=weight_loaders.WeightLoaderChoice(kind="paligemma", params_path=str(npz)),
    )
    result = port_train.run(cfg, device="cpu")
    result.close()
    state = result.trainer.state
    params_now = state.params
    assert state.ema_params and all(torch.equal(e, params_now[n]) for n, e in state.ema_params.items())
    merged = convert.from_jax_params(pretrained)
    assert torch.equal(params_now["llm.layers.0.mlp.0.linear"], merged["llm.layers.0.mlp.0.linear"])
    fresh = LAP(LAPConfig(**KW), device="cpu", init_seed=0)  # the config's seed: expert 1 keeps its init
    assert torch.equal(params_now["llm.layers.0.mlp.1.linear"], dict(fresh.named_parameters())["llm.layers.0.mlp.1.linear"])


def _assert_same_fields(got, ref, path):
    if dataclasses.is_dataclass(ref):
        for field in dataclasses.fields(got):
            _assert_same_fields(getattr(got, field.name), getattr(ref, field.name), f"{path}.{field.name}")
    elif isinstance(ref, enum.Enum):
        assert isinstance(got, enum.Enum) and got.value == ref.value, path
    else:
        assert got == ref, (path, got, ref)


@pytest.mark.parametrize("name", ["lap", "lap_libero", "debug", "lap_gemma3_4b", "lap_gemma3_12b", "lap_gemma3_27b",
                                  "lap_gemma3_4b_libero", "pi05_replicated", "pi0_replicated", "fast_gemma3_4b",
                                  "vla0_replicated", "vla0_replicated_libero", "lap_cotrain"])
def test_config_and_cli_defaults_equal_jax(name):
    _assert_same_fields(port_config.get_config(name), jax_config.get_config(name), name)
    argv = [name, "--exp_name", "x", "--data.repo_id", "fake", "--batch_size", "4", "--keep_period", "none",
            "--eval_checkpoint_steps", "3,6", "--weight_loader.kind", "paligemma", "--param_dtype", "bfloat16",
            "--data.action_proprio_normalization_type", "NORMAL", "--use_validation", "true"]
    got, ref = port_config.cli(argv), jax_config.cli(argv)
    _assert_same_fields(got, ref, f"cli {name}")
    assert got.checkpoint_dir == ref.checkpoint_dir and got.assets_dirs == ref.assets_dirs
    assert got.eval_checkpoint_steps == (3, 6) and got.keep_period is None


def test_fast_gemma3_config_waits_for_the_fast_tokenizer():
    """The FAST tokenizer is ported: the config builds and equals JAX's, its
    model transforms are the FAST group, and, as in JAX, the Gemma3 FAST
    tokenizer has no ``tokenize_with_actions``, so its input transform
    raises ``AttributeError`` on a request (a reference quirk kept)."""
    got, ref = port_config.get_config("fast_gemma3_4b"), jax_config.get_config("fast_gemma3_4b")
    assert got.model.use_fast and ref.model.use_fast
    _assert_same_fields(got, ref, "fast_gemma3_4b")
    group = got.data.model_transforms(got.model)
    assert [type(t).__name__ for t in group.inputs] == ["InjectDefaultPrompt", "TokenizeFASTInputs"]
    assert [type(t).__name__ for t in group.outputs] == ["ExtractFASTActions"]
    jgroup = ref.data.model_transforms(ref.model)
    request = {"prompt": "pick up the cup", "state": np.zeros(7, np.float32)}
    for transform in (group.inputs[1], jgroup.inputs[1]):
        with pytest.raises(AttributeError, match="tokenize_with_actions"):
            transform(dict(request))


def test_the_optimizer_field_takes_sgd_on_the_command_line():
    """``--optimizer SGDConfig`` (the port's CLI names a member of the union)
    then its fields; JAX's config holds the same optimizer when given it."""
    got = port_config.cli(["lap", "--optimizer", "SGDConfig", "--optimizer.momentum", "0.5",
                           "--optimizer.nesterov", "true"])
    assert got.optimizer == port_opt.SGDConfig(momentum=0.5, nesterov=True)
    ref = dataclasses.replace(jax_config.get_config("lap"), optimizer=jax_opt.SGDConfig(momentum=0.5, nesterov=True))
    _assert_same_fields(got, ref, "sgd")
    assert port_config.cli(["lap", "--optimizer", "adamw"]).optimizer == port_opt.AdamW()
    assert port_config.cli(["lap", "--optimizer.b1", "0.8"]).optimizer.b1 == 0.8


def test_entry_points_raise_without_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (port_train.main, port_eval.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["debug", "--exp_name", "t", "--checkpoint_base_dir", str(tmp_path)])
    assert port_train.split_device(["debug", "--device=cpu", "--x", "1"]) == ("cpu", ["debug", "--x", "1"])


SMALL_MODEL = ["--model.paligemma_variant", "dummy", "--model.action_expert_variant", "dummy", "--model.siglip_variant",
               "dummy", "--model.dtype", "float32", "--model.image_resolution", "56,56", "--data.repo_id", "fake",
               "--data.data_mix", "none", "--batch_size", "1"]


@pytest.mark.parametrize("name,extra,losses", [
    ("vla0_replicated", [], {"lang_loss"}),
    ("pi0_replicated", ["--model.pi05", "False"], {"action_loss"}),
])
def test_the_vlm_only_and_pi0_configs_train_through_the_entry_point(tmp_path, name, extra, losses):
    """One step of each at dummy size on the fake loader, saved (asynchronously)
    and waited for: the VLM-only model's loss is the language loss; pi0 without
    the language loss trains although expert 0's last layer takes no gradient
    (zero gradients, as JAX's)."""
    result = port_train.main([name, *SMALL_MODEL, *extra, "--num_train_steps", "1", "--exp_name", "v",
                              "--checkpoint_base_dir", str(tmp_path), "--device", "cpu"])
    result.close()
    metrics = result.metrics
    assert losses <= set(metrics) and not ({"lang_loss", "action_loss"} - losses) & set(metrics)
    assert math.isfinite(metrics["loss"]) and result.checkpoints.all_steps() == [1]
    assert result.checkpoints.last_save["step"] == 1 and "save_wait_s" in result.timings


def test_fast_configs_take_no_actions_into_the_batch_in_either_package():
    """A reference quirk kept: ``TokenizeFASTInputs`` pops the action chunk
    (it becomes tokens), so the loader's batch of a FAST config carries no
    actions, and ``compute_loss`` of the flow model fails on them, in JAX
    and in the port alike: pi05_replicated does not train in either."""
    from lap_tpu.data.loader import create_data_loader as jax_loader
    from lap_tpu_torch.data.loader import create_data_loader

    argv = ["pi05_replicated", *SMALL_MODEL]
    port_cfg, jax_cfg = port_config.cli(argv), jax_config.cli(argv)
    it = iter(create_data_loader(port_cfg, device="cpu", split="train"))
    try:
        obs, actions = next(it)
    finally:
        it.close()
    jax_obs, jax_actions = next(iter(jax_loader(jax_cfg, split="train")))
    assert actions is None and jax_actions is None
    np.testing.assert_array_equal(obs.tokenized_prompt.numpy(), np.asarray(jax_obs.tokenized_prompt))
    model = port_cfg.model.create_module(device="cpu", init_seed=0)
    with pytest.raises(AttributeError):
        model.compute_loss(obs, actions)
    jmodel = jax_cfg.model.create_module()
    with pytest.raises(AttributeError):
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), jax_obs, jax_actions,
                                           method=jmodel.compute_loss))
